"""Streamlines example (§5.4) on the PyTorch port: RK4 particle advection
with forwarding.

Advects particle sets through three analytic vector fields (ABC flow,
tornado, Taylor-Green) on an 8-rank slab partition, all ranks stacked on one
device — the Fig. 6 analogue — and verifies against the single-rank oracle,
as ``examples/streamlines_demo.py`` does for the JAX package (the port draws
its default seeds from ``torch.Generator``, so the lengths and rounds differ
from that demo's).  Runs on the CUDA card; ``--cpu`` runs the plain PyTorch
path.  Under ``torchrun`` the 8 ranks spread over the world's processes
(gloo with ``--cpu``, NCCL with a card per process) and process 0 prints
the same lines.

Run:  PYTHONPATH=src python examples/streamlines_demo_torch.py [--cpu]
      PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \
          examples/streamlines_demo_torch.py --cpu
"""
import argparse
import os

import numpy as np

from repro_torch.apps import streamlines as sl
from repro_torch.kernels.rk4_advect import ops as rk4
from repro_torch.launch import dist

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else None
comm = dist.init_world(device) if "WORLD_SIZE" in os.environ else None
if comm is not None and device is None:
    device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"

for name, fid in [("ABC", rk4.ABC), ("tornado", rk4.TORNADO), ("taylor-green", rk4.TAYLOR_GREEN)]:
    cfg = sl.StreamlineConfig(num_particles=48, max_steps=60, dt=0.12, field_id=fid)
    traces, lengths, stats = sl.run(cfg, num_ranks=8, device=device, comm=comm)
    orc = sl.oracle(cfg, device=device)
    m = np.isfinite(traces) & np.isfinite(orc)
    err = np.abs(traces[m] - orc[m]).max() if m.any() else 0.0
    ok = np.array_equal(np.isfinite(traces), np.isfinite(orc)) and err < 5e-4
    if comm is None or comm.index == 0:
        print(
            f"{name:>13}: mean streamline length {lengths.mean():6.1f} steps, "
            f"rounds {stats['rounds']:3d}, oracle max err {err:.1e} -> {'OK' if ok else 'FAIL'}"
        )
dist.destroy_world()
