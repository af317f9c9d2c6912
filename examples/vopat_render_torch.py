"""VoPaT example on the PyTorch port: distributed volume path tracing with
ray forwarding (§5.1).

Renders the blob scene of ``examples/vopat_render.py`` on 8 ranks (the
sort-free ``marshal="scatter"`` round) and on 1 rank, checks that the
images are bitwise identical (the paper's "images will not differ in any
way"), and writes the 8-rank image as a PPM under ``build/``.  The
telemetry summary of the reference example waits for the port's telemetry
(ROADMAP Queue 1 item 8).  Runs on the CUDA card; ``--cpu`` runs the plain
PyTorch path.

Run:  PYTHONPATH=src python examples/vopat_render_torch.py [--cpu]
"""
import argparse
import pathlib
import time

import numpy as np

from repro_torch.apps import vopat
from repro_torch.apps.fields import write_ppm

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else None

scene = vopat.VopatScene(width=96, height=96, spp=1, max_bounces=4, albedo=0.85)

t0 = time.time()
img8, s8 = vopat.render(scene, num_ranks=8, marshal="scatter", device=device)
print(f"8-rank render: {time.time() - t0:.1f}s  rounds={s8['rounds']} drops={s8['drops']}")
t0 = time.time()
img1, s1 = vopat.render(scene, num_ranks=1, device=device)
print(f"1-rank render: {time.time() - t0:.1f}s  rounds={s1['rounds']}")
same = np.array_equal(img1, img8)
print("bitwise identical across rank counts:", same)
assert same and s8["drops"] == 0

out = pathlib.Path(__file__).resolve().parents[1] / "build" / "vopat_8rank_torch.ppm"
out.parent.mkdir(exist_ok=True)
write_ppm(str(out), img8)
print("wrote", out)
