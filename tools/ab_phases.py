#!/usr/bin/env python3
"""The earlier phases' end-to-end numbers, tree after tree, on one NVIDIA card.

    python3 tools/ab_phases.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``chip_smoke.py``
beside ``src/``), e.g. the parent commit unpacked with ``git archive``
under ``build/`` and the working tree ``.``.  For each, in the order given,
a fresh Python process builds that tree's kernels and times, every number
after a warm-up pass:

  - the Fig-8 round (R=8, C=262,144 44-byte rays, S=65,536), sort and
    scatter, and the hierarchical Fig-8 round on 2×4 and 2×2×2 (sort):
    medians of 20 CUDA-event timings (``chip_smoke.cuda_ms``);
  - phase ``lossless`` (a)'s flat retain drive (``rotating_hotspot(8, 8,
    32768)``, 8,192 peer slots), sort and scatter: wall ms a forwarding
    round through ``run_until_done``;
  - streamlines (ABC, 131,072 particles, 64 steps): wall s;
  - VoPaT (1024×1024, R=8, scatter): wall s;
  - N-body (262,144 particles, R=8, 8 steps): wall ms a step.

It prints one JSON line a tree and writes ``chiprun_out/ab_phases.json``.
To compare two commits, give them as parent, change, change, parent.
Exits non-zero without a card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _warm(fn):
    fn()
    return fn()


def measure(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as CS
    from repro_torch import chaos as TC
    from repro_torch.apps import nbody, streamlines, vopat
    from repro_torch.core import ForwardConfig, WorkQueue, forward_work
    from repro_torch.kernels import build

    build.build()
    dev = torch.device("cuda", 0)
    R, C, S = 8, 262144, 65536
    Ray44 = CS._ray44_types()
    gen = torch.Generator(device=dev).manual_seed(44)
    f32 = lambda *s: torch.randn((R, C) + s, generator=gen, device=dev)
    q = WorkQueue(
        items=Ray44(origin=f32(3), direction=f32(3), tmin=f32(),
                    pixel=torch.arange(R * C, dtype=torch.int32, device=dev).reshape(R, C),
                    integral=f32(), extra=f32(2)),
        dest=CS._fig8_dest(gen, R, C, dev), count=torch.full((R,), C, dtype=torch.int32, device=dev),
        drops=torch.zeros(R, dtype=torch.int32, device=dev),
    )
    out = {"tree": str(tree)}
    rounds = {"flat_sort": ForwardConfig(R, C, peer_capacity=S), "flat_scatter": ForwardConfig(
        R, C, peer_capacity=S, marshal="scatter")}
    for sizes in ((2, 4), (2, 2, 2)):
        rounds["hier_" + "x".join(map(str, sizes)) + "_sort"] = ForwardConfig(R, C, exchange="hierarchical",
                                                                             level_sizes=sizes)
    for name, cfg in rounds.items():
        out[f"round_ms_{name}"] = _warm(lambda: CS.cuda_ms(lambda: forward_work(q, cfg)))
    del q
    sc = TC.rotating_hotspot(R, 8, 32768)
    for marshal in ("sort", "scatter"):
        d = CS.ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=8192, marshal=marshal, overflow="retain"), dev)
        res, wall = _warm(d.run)
        out[f"retain_ms_a_round_{marshal}"] = 1e3 * wall / (res["rounds"] + 1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()  # each ends in a copy to the host
        return time.perf_counter() - t0

    scfg = streamlines.StreamlineConfig(num_particles=131072, max_steps=64, dt=0.1, field_id=0)
    out["streamlines_abc_s"] = _warm(lambda: timed(lambda: streamlines.run(scfg, num_ranks=R, device=dev)))
    scene = vopat.VopatScene(width=1024, height=1024, spp=1, max_bounces=4, albedo=0.85, num_blobs=6)
    out["vopat_s"] = _warm(lambda: timed(lambda: vopat.render(scene, num_ranks=R, marshal="scatter", device=dev)))
    ncfg = nbody.NBodyConfig(num_particles=262144, steps=8, dt=5e-4, theta=0.3, eps2=1e-3, g=64.0 / 262144)
    out["nbody_ms_a_step"] = 1e3 * _warm(lambda: timed(lambda: nbody.run(ncfg, num_ranks=R, device=dev))) / 8
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_phases: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    results = []
    for tree in sys.argv[1:]:
        run = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ab_phases.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
