#!/usr/bin/env python3
"""Where a pipelined round's device time goes, on one NVIDIA card.

    python3 tools/pipeline_split.py

Builds the port's kernels and runs ``chip_smoke.py``'s Fig-8 round (R=8,
C=262,144 44-byte rays a rank, S=65,536 peer slots, the sort marshal) at
``pipeline_shards`` 1, 2 and 4, in turns (1, 2, 4, 4, 2, 1).  For each it
prints the device time of one round under ``torch.profiler`` (20 rounds;
``chip_smoke.device_ms``) and that time split by device event, largest
first.  Then the receive compaction alone on the round's received blocks:
K2 (``stages.compact_blocks``) against the plain per-shard
``stages.compact_shard`` run over 1, 2 and 4 shards into one accumulator.
Writes ``chiprun_out/pipeline_split.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _split(prof_events, calls):
    """Device ms a call by event name, largest first."""
    out = {}
    for e in prof_events:
        out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _profile(fn, calls=20):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _split(chip_smoke._device_events(prof), calls)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pipeline_split: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work
    from repro_torch.core import stages as ST
    from repro_torch.core import types as T
    from repro_torch.kernels import build
    from repro_torch.kernels.sort_keys import ops as sk_ops

    dev = torch.device("cuda", 0)
    build.build()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    R, C, S = 8, 262144, 65536
    q = chip_smoke._fig8_queue(dev, R, C)
    out = {"card": smi, "rounds": {}, "compaction": {}}
    for n in (1, 2, 4, 4, 2, 1):
        cfg = ForwardConfig(R, C, peer_capacity=S, pipeline_shards=n)
        ms, _events = chip_smoke.device_ms(lambda: forward_work(q, cfg))
        split = _profile(lambda: forward_work(q, cfg))
        out["rounds"].setdefault(str(n), []).append({"device_ms": ms, "split": split})
        print(f"{n} shard(s): device {ms:.4f} ms a round; by event (ms): "
              + ", ".join(f"{chip_smoke._short(k)} {v:.4f}" for k, v in list(split.items())[:12]), flush=True)

    # the received blocks of the round, compacted alone
    perm, _sd, hist = sk_ops.sort_permutation(q.dest, q.count, R)
    packed, _spec = T.pack_payload(q.items, batch_dims=2)
    st = ST.RoundState(packed=packed, perm=perm, send_counts=hist[:, :R])
    comm = StackedCollectives()
    st = ST.compose(ST.SpillExtract(R, C, S), ST.Marshal(R, S), ST.CountExchange(comm), ST.PayloadExchange(comm))(st)
    recv, counts = st.recv_buf, st.recv_counts
    W = recv.shape[-1]
    k2_ms, _ = chip_smoke.device_ms(lambda: ST.compact_blocks(recv, counts, C))
    out["compaction"]["K2"] = k2_ms
    print(f"compaction of (8, 8, {S}, {W}): K2 compact_blocks {k2_ms:.4f} ms", flush=True)
    want = ST.compact_blocks(recv, counts, C)[0]
    for n in (1, 2, 4):
        chunk = S // n
        parts = [recv[:, :, k * chunk:(k + 1) * chunk].contiguous() for k in range(n)]  # as received

        def shards():
            acc = None
            for k, part in enumerate(parts):
                acc = ST.compact_shard(acc, part, counts, C, row_offset=k * chunk)
            return acc

        got = shards()[:R * C].view(R, C, W)
        if not torch.equal(got, want):
            print(f"pipeline_split: compact_shard over {n} shards != compact_blocks", file=sys.stderr)
            return 1
        ms, _ = chip_smoke.device_ms(shards)
        split = _profile(shards)
        out["compaction"][f"plain_{n}"] = {"device_ms": ms, "split": split}
        print(f"  plain compact_shard over {n} shard(s): {ms:.4f} ms; by event (ms): "
              + ", ".join(f"{chip_smoke._short(k)} {v:.4f}" for k, v in list(split.items())[:8]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "pipeline_split.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
