"""VoPaT example on the PyTorch port: distributed volume path tracing with
ray forwarding (§5.1).

Renders the blob scene of ``examples/vopat_render.py`` on 8 ranks (the
sort-free ``marshal="scatter"`` round) and on 1 rank, checks that the
images are bitwise identical (the paper's "images will not differ in any
way"), prints the 8-rank render's telemetry summary (the measured basis
for sizing its queues below the §6.3 worst case), and writes the 8-rank
image as a PPM under ``build/``.  Runs on the CUDA card; ``--cpu`` runs the
plain PyTorch path.  Under ``torchrun`` the 8-rank render spreads its ranks
over the world's processes (gloo with ``--cpu``, NCCL with a card per
process), every process renders the 1-rank image itself, and process 0
prints the same lines.

Run:  PYTHONPATH=src python examples/vopat_render_torch.py [--cpu]
      PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \
          examples/vopat_render_torch.py --cpu
"""
import argparse
import os
import pathlib
import time

import numpy as np

from repro_torch.apps import vopat
from repro_torch.apps.fields import write_ppm
from repro_torch.launch import dist

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else None
comm = dist.init_world(device) if "WORLD_SIZE" in os.environ else None
if comm is not None and device is None:
    device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
lead = comm is None or comm.index == 0


def say(*line):
    if lead:
        print(*line)


scene = vopat.VopatScene(width=96, height=96, spp=1, max_bounces=4, albedo=0.85)

t0 = time.time()
img8, s8 = vopat.render(scene, num_ranks=8, marshal="scatter", telemetry=True, device=device, comm=comm)
say(f"8-rank render: {time.time() - t0:.1f}s  rounds={s8['rounds']} drops={s8['drops']}")
tel = s8["telemetry"]
say(f"telemetry: {tel['rounds']} rounds recorded, max segment demand {tel['demand_max'][0]} "
    f"(peer slots sized {tel['tier_capacities'][0]}), clamp drops {tel['drops']}")
t0 = time.time()
img1, s1 = vopat.render(scene, num_ranks=1, device=device)
say(f"1-rank render: {time.time() - t0:.1f}s  rounds={s1['rounds']}")
same = np.array_equal(img1, img8)
say("bitwise identical across rank counts:", same)
assert same and s8["drops"] == 0 and tel["drops"] == 0

if lead:
    out = pathlib.Path(__file__).resolve().parents[1] / "build" / "vopat_8rank_torch.ppm"
    out.parent.mkdir(exist_ok=True)
    write_ppm(str(out), img8)
    say("wrote", out)
dist.destroy_world()
