"""Batched serving on the PyTorch port: heterogeneous requests through the
slot engine (the twin of ``examples/serve_lm.py``).

Serves ten requests through four slots with ``qwen2-7b``'s smoke config
(dense), then with ``llama4-scout-17b-16e``'s (16 experts scaled to 4,
top-1), whose MoE layers dispatch every routed token as a RaFI work item:
two ``forward_work`` rounds a layer over the (data=1, model=4) rank layout.
Weights are random, from a seeded ``torch.Generator``.

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path.  Under
``torchrun`` the four model ranks spread over the world's processes (gloo
with ``--cpu``, NCCL with a card per process); every process holds every
slot, and process 0 prints the same lines.
Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--cpu]
      PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \
          examples/serve_lm_torch.py --cpu
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request
from repro_torch.models.api import build_model

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = torch.device("cpu" if args.cpu else "cuda")
comm = dist.init_world(device) if "WORLD_SIZE" in os.environ else None
if comm is not None and device.type == "cuda":
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
lead = comm is None or comm.index == 0

for arch in ("qwen2-7b", "llama4-scout-17b-16e"):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    layout = make_test_layout(1, 4, comm=comm) if cfg.kind == "moe" else None

    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, rng.integers(2, 12)),
                max_new_tokens=int(rng.integers(4, 12)))
        for i in range(10)
    ]
    engine = BatchedEngine(model, params, slots=4, max_len=64, layout=layout, device=device)
    out = engine.run(requests)
    if not lead:
        continue
    print(f"{cfg.name}: {model.param_count()} parameters, {engine.steps} engine steps")
    for rid in sorted(out):
        print(f"  request {rid}: prompt_len={len(requests[rid].prompt):2d} -> {out[rid]}")
    drops = sum(int(d) for d in engine.step_drops)
    print(f"served {len(out)} requests through 4 slots"
          + (f"; MoE tokens dropped at capacity_factor {cfg.capacity_factor}: {drops}" if layout else ""))
dist.destroy_world()
