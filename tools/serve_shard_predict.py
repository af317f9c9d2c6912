#!/usr/bin/env python3
"""What phase ``serve_shard`` of ``chip_smoke.py`` should read, counted on
the meta device from the partition rule (no card, nothing allocated).

    PYTHONPATH=src python3 tools/serve_shard_predict.py

qwen2-7b at full width, 4 of 28 layers, bfloat16, serve-placed on layout
(2, 4) stacked, 16 slots: the parameters' bytes whole, a rank's bytes
under the serve rule and the stacked layout's sum; the caches' bytes at
``max_len`` 128 and 4,096; one placed decode step's collective calls by
kind and tier and their bytes (the stacked backend's call recorder); and,
from ``roofline.analysis.count_step``, the bytes each decode step's aten
ops move, its FLOPs and the peak of the bytes alive above its inputs,
placed and unsharded, at both cache lengths.  Each step's bound on one
H100 is its bytes moved over 3.35e12 B/s (every count here is memory
bound).  Prints one JSON object and writes
``chiprun_out/serve_shard_predict.json``.
"""
import dataclasses as dc
import json
import pathlib

import torch

from repro_torch.configs import get_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Layout
from repro_torch.models.api import build_model
from repro_torch.roofline.analysis import count_step

HBM = 3.35e12
META = torch.device("meta")


def leaves(tree):
    return [t for _p, t in S.named_leaves(dict(tree))]


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def main():
    cfg = dc.replace(get_config("qwen2-7b"), num_layers=4)
    model = build_model(cfg)
    layout = Layout(2, 4)
    lm = model.abstract()
    sp = PL.serve_placement(model, layout)
    params = sp.place(lm)
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())
    per_rank = nbytes(params) // layout.num_ranks
    out = {"param_bytes_whole": whole, "param_bytes_per_rank": per_rank, "param_bytes_stacked": nbytes(params),
           "rank_share_of_whole": per_rank / whole}
    token = torch.zeros((16, 1), dtype=torch.int32, device=META)
    step = model.decode_fn()
    for max_len in (128, 4096):
        cp = PL.cache_placement(model, layout, 16, max_len)
        pc, wc = cp.zeros(META), model.init_caches(16, max_len, device=META)
        sp.comm.reset()
        placed = count_step(lambda: step(params, token, pc), held=[(leaves(params) + leaves(pc), None)])
        calls = {}
        for c, n in sp.comm.calls.items():
            key = f"{c.kind}{c.tier}"
            calls.setdefault(key, [0, 0])
            calls[key][0] += n
            calls[key][1] += c.nbytes * n
        held_p = nbytes(params) + nbytes(pc)
        held_w = whole + nbytes(wc)
        unsharded = count_step(lambda: step(lm, token, wc), held=[(list(lm.parameters()) + leaves(wc), None)])
        out[f"max_len_{max_len}"] = {
            "cache_bytes_whole": nbytes(wc), "cache_bytes_stacked": nbytes(pc),
            "placed_calls_and_bytes": calls,
            "placed": {"bytes_accessed": placed.bytes_accessed, "flops": placed.flops,
                       "peak_above_held_gib": (placed.peak_bytes - held_p) / 2**30,
                       "bound_ms": placed.bytes_accessed / HBM * 1e3},
            "unsharded": {"bytes_accessed": unsharded.bytes_accessed, "flops": unsharded.flops,
                          "peak_above_held_gib": (unsharded.peak_bytes - held_w) / 2**30,
                          "bound_ms": unsharded.bytes_accessed / HBM * 1e3},
        }
    print(json.dumps(out, indent=1))
    path = pathlib.Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "serve_shard_predict.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
