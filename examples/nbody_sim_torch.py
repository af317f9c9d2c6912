"""N-body example (§5.5) on the PyTorch port: three forwarding contexts.

Runs the distributed Barnes-Hut-style simulation on 8 ranks (a 2×2×2 grid
decomposition, all ranks stacked on one device) and reports conservation and
accuracy against the direct sum, as ``examples/nbody_sim.py`` does for the
JAX package.  Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path.

Run:  PYTHONPATH=src python examples/nbody_sim_torch.py [--cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import nbody

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else None

cfg = nbody.NBodyConfig(num_particles=256, steps=8, dt=5e-4, theta=0.3)
pos, vel, stats = nbody.run(cfg, num_ranks=8, device=device)
po, vo = nbody.oracle(cfg, device=device)

print(f"rank grid: {stats['dims']}, particles per step: {stats['totals']}")
print(f"queue drops: {stats['drops']}")
print(f"max position error vs direct sum: {np.abs(pos - po).max():.2e}")
print(f"rms velocity error vs direct sum: {np.sqrt(((vel - vo) ** 2).mean()):.2e}")
assert stats["totals"][-1] == cfg.num_particles, "particles lost!"
print("OK — particles conserved through migration, three contexts coexisting")
