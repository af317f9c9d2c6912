#!/usr/bin/env python3
"""The stacked LM prefill and MoE train step, tree after tree, on one NVIDIA card.

    python3 tools/ab_lm_steps.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``chip_smoke.py``
beside ``src/``), e.g. the parent commit unpacked with ``git archive``
under ``build/`` and the working tree ``.``.  For each, in the order given,
a fresh Python process builds that tree's kernels and measures, on the
stacked collective backend, the two paths whose every MoE layer ends in
``models.moe.rafi_ep_combine``:

  - phase ``lm`` (d)'s 2,048-token prefill: llama4-scout-17b-16e at 4 of 48
    layers, bfloat16, layout (1, 8), capacity factor E / k, weights from
    seed 2323; device ms a call (``chip_smoke.device_ms``, 20 calls under
    ``torch.profiler``) and the median of 20 CUDA-event timings of one
    call (``chip_smoke.cuda_ms``), after warm-up;
  - phase ``train`` (b)'s step: llama4-scout-17b-16e at 1 of 48 layers,
    batch 8 × 512, layout (1, 8), 4 steps through ``launch.train.train``
    (``chip_smoke._train_full``): the step's event median and its device
    ms from one profiled step.

It prints one JSON line a tree and writes ``chiprun_out/ab_lm_steps.json``.
To compare two commits, give them as parent, change, change, parent.
Exits non-zero without a card or when a tree's checks fail.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def measure(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import dataclasses as dc
    import gc

    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Layout
    from repro_torch.models.api import build_model

    build.build()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"tree": str(tree), "card": CS.nvidia_smi()}

    cfg = dc.replace(get_config(CS.LM_ARCH), num_layers=4)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(2323), device=dev)
    free = dc.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    prefill = build_model(free).prefill_fn(Layout(1, 8))
    tokens = torch.from_numpy(np.random.default_rng(64).integers(0, cfg.vocab_size, (1, 2048)).astype(np.int32)).to(dev)
    with torch.no_grad():
        call = lambda: prefill(params, {"tokens": tokens})
        out["prefill_event_ms"] = CS.cuda_ms(call)
        out["prefill_device_ms"], _ = CS.device_ms(call)
    del params, prefill, call
    gc.collect()
    torch.cuda.empty_cache()

    r = CS._train_full(dev, CS.LM_ARCH, 1, 4, batch=8, seq=512, layout=Layout(1, 8), widths=None, profile=True)
    out["train_step_event_ms"] = r["step_ms_median"]
    out["train_step_device_ms"] = r["device_ms"]
    out["train_step_device_split_ms"] = r["device_split_ms"]
    out["failures"] = list(CS.FAILURES)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_lm_steps: no CUDA device is available", file=sys.stderr)
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
    (ROOT / "chiprun_out" / "ab_lm_steps.json").write_text(json.dumps(results, indent=1))
    return 1 if any(r["failures"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
