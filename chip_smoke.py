#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together, linked into one library under
``build/``) and runs seven phases on ``cuda:0``:

  1. kernels     — all ten kernels (K1 gather_rows, K2 unmarshal, K3
                   pack_and_histogram, K4 rank_and_histogram, K5
                   scatter_rows, K6 compact_positions, K7 marshal, K8
                   rk4_step, K9 pairwise_accel, K10 track), each held against
                   its plain PyTorch version on the card at the main paths'
                   shapes (bit-equal; K8 within 1e-5; K9 and its plain
                   version against a float64 witness on a sample, each
                   within 1e-5 of the row's sum of |terms|, K9 within 2x the
                   plain version's error; K10's t within rtol 1e-6, statuses
                   equal but for near-ties) and timed beside its plain
                   version, a PyTorch library call where one exists, and its
                   bound (bytes over 3.35 TB/s or float32 operations over
                   67e12/s; K10's counted from the steps its rays take),
                   each two ways: ``device_ms`` (the device time of
                   every kernel, fill and memset of a call, from
                   ``torch.profiler`` over 20 back-to-back calls) and
                   ``call_ms`` (one CUDA event pair around one call, host
                   issue time included); K2, K4 and K6 must make one kernel
                   launch a call and no fill; K8 must give each particle
                   the same bits wherever it sits (``pos[k:]`` against
                   ``pos``); K2 and K4 also at VoPaT's shapes, K6 at the
                   streamlines and VoPaT shapes, K8 at the streamlines
                   shape; K2 also with offsets shifted by a retain spill
                   front inside (0, C) and at or past C; plus the two-pass
                   marshal path (K3 + sort + K7) against K1's fused marshal;
  2. forward     — one ``forward_work`` round of the Fig-8 44-byte ray, R=8
                   ranks × C=262,144 (2,097,152 rays, about one 1080p frame
                   of primary rays), S=65,536 peer slots, in both marshal
                   modes: the sort round equal to the onehot oracle on the
                   card and to the same round run on the CPU, the scatter
                   round equal to both; one payload and one count
                   all_to_all each; K1, K2, K3 once in the sort round, K4,
                   K5, K2 once in the scatter round; median round times and
                   the stage splits (CUDA events at the stage boundaries);
  3. lossless    — ``overflow="retain"`` and the hierarchical route, the
                   Fig-8 ray's 11 words with a scenario uid in the first:
                   (a) ``chaos.rotating_hotspot(8, 8, 32768)`` through the
                   flat padded retain drive (C=262,144, 8,192 peer slots)
                   in both marshals, equal to the port's numpy oracle
                   forward for forward (11 rounds, retained rows and their
                   largest age) and to ``expected_by_rank``, timed, with
                   the seed round's stage split; (b) one hierarchical drop
                   round of the Fig-8 rays on 2×4 and 2×2×2 in both
                   marshals, equal to the flat onehot round and to the CPU,
                   one payload and one count ``all_to_all`` per tier, timed
                   with stage splits beside the flat padded round; (c) the
                   scenario of (a) through the hierarchical retain drive at
                   tight tier capacities on both layouts: checksums equal,
                   0 drops, rows parked after a later tier, sort and
                   scatter equal after every forward; launches counted on
                   every path;
  4. streamlines — ``apps.streamlines.run`` through
                   ``RafiContext.run_until_done``, R=8, 131,072 particles,
                   64 steps, ABC field (tornado and Taylor-Green at 16,384):
                   traces equal the single-rank oracle exactly; K6 launched
                   once per ``enqueue``;
  5. vopat       — ``apps.vopat.render`` at 1024×1024 (1,048,576 primary
                   rays), R=8, ``marshal="scatter"``: drops 0, the image
                   bit-equal to the R=1 render and to the R=8 sort render,
                   finite and in [0, 1]; rounds, wall time and the
                   device-busy share; two witnesses independent of the
                   card: the threefry words of 2,097,152 (pixel, event)
                   pairs bit-equal to the same words on the CPU, and a
                   64×64 render equal to the port's plain CPU render within
                   the port-against-reference tolerance of the tests;
  6. nbody       — ``apps.nbody.run``, R=8, 262,144 particles, 8 steps (dt
                   5e-4, θ 0.3, ε² 1e-3, G = 64/N): every particle conserved
                   (totals N every step, drops 0), positions within 1e-2 of
                   the direct-sum oracle, the R=1 run within 1e-5 of it, K9
                   launched once a step and K3, K1, K2 four times (four
                   forwarding contexts a step); a 512-particle R=8 run on the
                   card against the same run on the CPU; wall time per step,
                   the device-busy share and K9's share of device time;
  7. report      — one JSON line of the kernels (launches on the paths that
                   run them, errors, bounds; ``ms``, ``plain_ms`` and
                   ``library_ms`` are device times, ``call_ms`` the event
                   pair's; device events a call), the card's name and
                   power limit, and a last line
                   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when there is no CUDA card, when the
port's sources are not beside this script, or when any check fails.  The
full record is also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
L2_BYTES = 50e6  # H100 L2 cache
REPS = 20
DEVICE_CALLS = 20  # calls a device_ms profile averages over

KERNELS = {  # name → (source in the repo, the TPU kernel it replaces)
    "pack_and_histogram": ("src/repro_torch/kernels/csrc/sort_keys.cu",
                           "src/repro/kernels/sort_keys/kernel.py:62"),
    "gather_rows": ("src/repro_torch/kernels/csrc/marshal.cu",
                    "src/repro/kernels/marshal/kernel.py:83"),
    "unmarshal": ("src/repro_torch/kernels/csrc/marshal.cu",
                  "src/repro/kernels/marshal/kernel.py:140"),
    "rk4_step": ("src/repro_torch/kernels/csrc/rk4_advect.cu",
                 "src/repro/kernels/rk4_advect/kernel.py:63"),
    "rank_and_histogram": ("src/repro_torch/kernels/csrc/bucket_scatter.cu",
                           "src/repro/kernels/bucket_scatter/kernel.py:82"),
    "scatter_rows": ("src/repro_torch/kernels/csrc/bucket_scatter.cu",
                     "src/repro/kernels/bucket_scatter/kernel.py:147"),
    "compact_positions": ("src/repro_torch/kernels/csrc/compact.cu",
                          "src/repro/kernels/compact/kernel.py:43"),
    "marshal": ("src/repro_torch/kernels/csrc/marshal.cu",
                "src/repro/kernels/marshal/kernel.py:50"),
    "pairwise_accel": ("src/repro_torch/kernels/csrc/nbody_forces.cu",
                       "src/repro/kernels/nbody_forces/kernel.py:41"),
    "track": ("src/repro_torch/kernels/csrc/delta_tracking.cu",
              "src/repro/kernels/delta_tracking/kernel.py:64"),
}
# the paths whose launches the report counts, per kernel (each path is run
# with the counts set to 0 just before it and read just after)
LOSSLESS_PATHS = tuple(
    [f"lossless_flat_{m}" for m in ("sort", "scatter")]
    + [f"hier_round_{t}_{m}" for t in ("2x4", "2x2x2") for m in ("sort", "scatter")]
    + [f"lossless_hier_{t}" for t in ("2x4", "2x2x2")]
)
LAUNCH_PATHS = {
    "pack_and_histogram": ("streamlines", "nbody") + LOSSLESS_PATHS,
    "gather_rows": ("streamlines", "nbody") + LOSSLESS_PATHS,
    "unmarshal": ("streamlines", "vopat", "nbody") + LOSSLESS_PATHS, "rk4_step": ("streamlines",),
    "compact_positions": ("streamlines", "vopat", "nbody") + LOSSLESS_PATHS,
    "rank_and_histogram": ("vopat",) + LOSSLESS_PATHS, "scatter_rows": ("vopat",) + LOSSLESS_PATHS,
    "marshal": ("two_pass_marshal",),
    "pairwise_accel": ("nbody",), "track": ("woodcock_check",),
}

FAILURES: list = []


def check(cond: bool, what: str) -> bool:
    print(f"  check {'ok  ' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        FAILURES.append(what)
    return cond


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up: one
    event pair around one call, so the span also holds the host's issue
    time (allocations, the library load, the ``ctypes`` call) whenever the
    card waits on it.  Reported as ``call_ms``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """Device-side events of a profile (kernels, copies, fills, memsets):
    an aten op's own entry repeats the device time of the kernels it
    launched, so only these are summed."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def _short(key: str) -> str:
    """A device event's name without its argument list."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:90] if not key.startswith("Mem") else key


def device_ms(fn, calls: int = DEVICE_CALLS, warmup: int = 3, attempts: int = 3):
    """Device time of one call of ``fn``: ``calls`` back-to-back calls after
    warm-up under ``torch.profiler``; for every device event (kernels,
    fills, memsets, copies) its mean ``self_device_time_total`` times its
    launches a call, summed.  The host's issue time is left out.  The
    profiler may miss a few of an event's launches (on the H100 it
    recorded 15 to 19 of 20 in some profiles), so launches a call are the
    recorded count over ``calls`` rounded, and at least 1.  Returns ``(ms,
    events)``, ``events`` the launches a call by event name.  A profile
    that recorded no device event is taken again, up to ``attempts`` times
    in all; after that the calls are timed between one CUDA event pair (an
    upper bound: it also holds any host time the card waits on) and
    ``events`` is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        stats = [e for e in _device_events(prof) if e.count > 0]
        if sum(e.self_device_time_total for e in stats) > 0:
            break
    else:
        print(f"  device_ms: the profiler saw no device time in {attempts} profiles; timing "
              f"{calls} calls between one CUDA event pair instead", flush=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, None
    us, events = 0.0, {}
    for e in stats:
        per_call = max(1, round(e.count / calls))
        us += e.self_device_time_total / e.count * per_call
        events[_short(e.key)] = events.get(_short(e.key), 0) + per_call
        if e.count != per_call * calls:
            print(f"  device_ms: the profiler recorded {e.count} launches of {_short(e.key)} "
                  f"in {calls} calls; counted {per_call} a call", flush=True)
    return us / 1e3, events


def kernels_a_call(events):
    """Kernel launches a call among ``device_ms``'s events (copies and
    memsets are not kernels); None where the profiler recorded none."""
    return None if events is None else sum(v for k, v in events.items() if not k.startswith("Mem"))


def _timed(timer, dtimer, kernel, plain, library=None, *, reps=REPS, calls=DEVICE_CALLS, warmup=3):
    """The kernel's wrapper, its plain version and the library call (where
    there is one), each timed by the event pair (``call_ms``,
    ``plain_call_ms``, ``library_call_ms``) and by device time
    (``device_ms``, ``events``, and the same with the prefixes)."""
    out = {}
    for pre, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out.update({f"{pre}call_ms": None, f"{pre}device_ms": None, f"{pre}events": None})
            continue
        out[f"{pre}call_ms"] = timer(fn, reps=reps, warmup=warmup)
        out[f"{pre}device_ms"], out[f"{pre}events"] = dtimer(fn, calls=calls, warmup=warmup)
    return out


def bound_ms(nbytes: float, ops: float = 0.0):
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- 1. kernels
def _fig8_dest(gen, R, C, dev):
    """Uniform destinations with ~6% DISCARD lanes."""
    import torch

    dest = torch.randint(0, R, (R, C), generator=gen, device=dev, dtype=torch.int32)
    discard = torch.rand((R, C), generator=gen, device=dev) < 0.06
    return torch.where(discard, -1, dest)


def phase_kernels(dev, R=8, C=262144, S=65536, W=11, N_PART=2097152,
                  MASKS=((8, 131072), (8, 1048576)), NBODY=(8, 262144, 262288), SAMPLE=4096,
                  RAYS=1024, K2_VOPAT=(8, 8, 1048576, 15), K4_VOPAT=(8, 1048576),
                  K8_STREAMLINES=1048576, timer=cuda_ms, dtimer=device_ms):
    import torch

    from repro_torch import kernels as KN
    from repro_torch.core import stages as ST
    from repro_torch.kernels.bucket_scatter import ops as BS
    from repro_torch.kernels.compact import ops as CO
    from repro_torch.kernels.marshal import ops as MO
    from repro_torch.kernels.rk4_advect import ops as RO
    from repro_torch.kernels.sort_keys import ops as SO

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}
    T = lambda *fns: _timed(timer, dtimer, *fns)

    # K3: dest (R, C) with DISCARD, out-of-range lanes and count < C on some ranks
    dest = _fig8_dest(gen, R, C, dev)
    dest[:, ::997] = R + 3
    count = torch.full((R,), C, dtype=torch.int32, device=dev)
    count[1::3] = C - 12345
    ib = max(1, (C - 1).bit_length())
    k_keys, k_hist = SO.pack_and_histogram(dest, count, num_ranks=R, idx_bits=ib)
    p_keys, p_hist = SO.pack_and_histogram_plain(dest, count, num_ranks=R, idx_bits=ib)
    ok = torch.equal(k_keys, p_keys) and torch.equal(k_hist, p_hist)
    check(ok, f"K3 pack_and_histogram dest {tuple(dest.shape)}: keys and histogram bit-equal to plain")
    # the function writes 4-byte uint32 keys: the bound counts those; the
    # kernel writes them widened to int64 for torch.sort (printed beside)
    nbytes = dest.numel() * 4 + count.numel() * 4 + k_keys.numel() * 4 + k_hist.numel() * 4
    int64_bytes = nbytes + k_keys.numel() * 4
    print(f"  pack_and_histogram: bound counts 4-byte keys ({nbytes} B); with the "
          f"int64 keys it writes, {int64_bytes} B = {bound_ms(int64_bytes)[0]:.4f} ms", flush=True)
    rows["pack_and_histogram"] = dict(
        max_abs_err=0.0 if ok else float((k_keys - p_keys).abs().max()),
        **T(lambda: SO.pack_and_histogram(dest, count, num_ranks=R, idx_bits=ib),
            lambda: SO.pack_and_histogram_plain(dest, count, num_ranks=R, idx_bits=ib)),
        nbytes=nbytes, ops=0.0,
        library_call=None, int64_key_bytes=int64_bytes,
    )

    # K1: the forward round's composed send gather
    src = torch.randint(-2**31, 2**31 - 1, (R, C, W), generator=gen, device=dev, dtype=torch.int32)
    count_full = torch.full((R,), C, dtype=torch.int32, device=dev)
    perm, _, hist = SO.sort_permutation(_fig8_dest(gen, R, C, dev), count_full, R)
    idx = ST.send_rows(perm, hist[:, :R], peer_capacity=S)  # (R, R·S)
    k_out = MO.gather_rows(src, idx)
    p_out = MO.gather_rows_plain(src, idx)
    b_idx, idx_long = torch.arange(R, device=dev)[:, None], idx.long()
    lib_out = src[b_idx, idx_long]
    ok = torch.equal(k_out, p_out) and torch.equal(lib_out, p_out)
    check(ok, f"K1 gather_rows src {tuple(src.shape)} idx {tuple(idx.shape)}: bit-equal to plain")
    uniq = sum(int(torch.unique(idx[r]).numel()) for r in range(R))
    nbytes = idx.numel() * 4 + uniq * W * 4 + k_out.numel() * 4
    rows["gather_rows"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.gather_rows(src, idx), lambda: MO.gather_rows_plain(src, idx),
            lambda: src[b_idx, idx_long]),
        nbytes=nbytes, ops=0.0,
        library_call="advanced indexing src[b, idx]",
    )
    del k_out, p_out, lib_out, src

    # K2: received blocks, rank 0's counts overflow the capacity
    recv = torch.randint(-2**31, 2**31 - 1, (R, R, S, W), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(S // 3, S // 2, (R, R), generator=gen, device=dev, dtype=torch.int32)
    counts[0] = S  # 8 full blocks = 2·C rows into rank 0: half are cut
    off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    k_out = MO.unmarshal(recv, off, counts, capacity=C)
    p_out = MO.unmarshal_plain(recv, off, counts, capacity=C)
    s_ar = torch.arange(S, device=dev)
    dst = off[:, :, None].long().clamp(0, C) + s_ar
    keep = (s_ar < counts[:, :, None]) & (dst < C)
    dst = torch.where(keep, dst, C).reshape(R, R * S)
    bb = torch.arange(R, device=dev)[:, None].expand(R, R * S)
    flat = recv.reshape(R, R * S, W)

    def library():
        out = torch.zeros(R, C + 1, W, dtype=torch.int32, device=dev)
        return out.index_put_((bb, dst), flat)

    ok = torch.equal(k_out, p_out) and torch.equal(library()[:, :C], p_out)
    check(ok, f"K2 unmarshal recv {tuple(recv.shape)} capacity {C}, rank 0 overflowing: bit-equal to plain")
    landed = int(keep.sum())
    check(landed < int(counts.sum()), f"K2 input really overflows: {int(counts.sum())} rows offered, {landed} land")
    nbytes = landed * W * 4 + 2 * off.numel() * 4 + k_out.numel() * 4
    rows["unmarshal"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.unmarshal(recv, off, counts, capacity=C),
            lambda: MO.unmarshal_plain(recv, off, counts, capacity=C), library),
        nbytes=nbytes, ops=0.0,
        library_call="zeros + index_put_ at precomputed positions",
    )
    _one_launch("unmarshal", "unmarshal_kernel", rows["unmarshal"]["events"], dev)
    # the retain round's compaction: offsets shifted by a spill front inside
    # (0, C) on six ranks, at C and past it on two (nothing lands there)
    front = torch.randint(1, C, (R,), generator=gen, device=dev, dtype=torch.int32)
    front[2], front[5] = C, C + 4096
    k_f = MO.unmarshal(recv, off + front[:, None], counts, capacity=C)
    p_f = MO.unmarshal_plain(recv, off + front[:, None], counts, capacity=C)
    below = torch.arange(C, device=dev)[None, :] < front[:, None]
    check(torch.equal(k_f, p_f) and not bool(k_f[below].any()) and not bool(k_f[[2, 5]].any()),
          f"K2 unmarshal with a spill front (fronts {front.tolist()}): bit-equal to plain, rows below "
          "the front zero, nothing lands at or past capacity")
    del k_out, p_out, k_f, p_f, recv, flat, dst, bb, keep
    rows["unmarshal"]["vopat_shape"] = _kernel_k2_at(dev, gen, timer, dtimer, *K2_VOPAT)

    # K8: all three fields; the ABC timing goes in the report
    pos = torch.rand((N_PART, 3), generator=gen, device=dev) * 6.283185307179586
    errs = []
    for fid, name in ((RO.ABC, "ABC"), (RO.TORNADO, "tornado"), (RO.TAYLOR_GREEN, "Taylor-Green")):
        kn, kv = RO.rk4_step(pos, dt=0.1, field_id=fid)
        pn, pv = RO.rk4_step_plain(pos, dt=0.1, field_id=fid)
        err = max(float((kn - pn).abs().max()), float((kv - pv).abs().max()))
        errs.append(err)
        check(err <= 1e-5, f"K8 rk4_step pos {tuple(pos.shape)} {name}: max abs diff {err:.3e} <= 1e-5")
        # each particle in another thread, slot and alignment: the streamlines oracle's need
        same = all(torch.equal(a, b[k:]) for k in (1, 2, 3)
                   for a, b in zip(RO.rk4_step(pos[k:], dt=0.1, field_id=fid), (kn, kv)))
        check(same, f"K8 {name}: rk4_step(pos[k:]) == rk4_step(pos)[k:] bit for bit, k = 1, 2, 3")
    rows["rk4_step"] = dict(
        max_abs_err=max(errs),
        **T(lambda: RO.rk4_step(pos, dt=0.1, field_id=RO.ABC),
            lambda: RO.rk4_step_plain(pos, dt=0.1, field_id=RO.ABC)),
        **_k8_work(N_PART), library_call=None,
    )
    del pos, kn, kv, pn, pv
    rows["rk4_step"]["streamlines_shape"] = _kernel_k8_at(dev, gen, timer, dtimer, K8_STREAMLINES)
    # K4: the scatter plan, on K3's destinations (DISCARD, out-of-range
    # lanes, count < C on some ranks)
    k4 = BS.rank_and_histogram(dest, count, num_ranks=R)
    p4 = BS.rank_and_histogram_plain(dest, count, num_ranks=R)
    ok = all(torch.equal(a, b) for a, b in zip(k4, p4))
    check(ok, f"K4 rank_and_histogram dest {tuple(dest.shape)}: d_clean, rank and histogram bit-equal to plain")
    rows["rank_and_histogram"] = dict(
        max_abs_err=0.0 if ok else float(max((a - b).abs().max() for a, b in zip(k4, p4))),
        **T(lambda: BS.rank_and_histogram(dest, count, num_ranks=R),
            lambda: BS.rank_and_histogram_plain(dest, count, num_ranks=R)),
        nbytes=dest.numel() * 4 * 3 + count.numel() * 4 + k4[2].numel() * 4,
        ops=0.0, library_call=None,
    )
    _one_launch("rank_and_histogram", "rank_hist_kernel", rows["rank_and_histogram"]["events"], dev)
    rows["rank_and_histogram"]["vopat_shape"] = _kernel_k4_at(dev, gen, timer, dtimer, *K4_VOPAT)

    # K5: the scatter marshal's send pass at the round's positions
    # d_clean·S + rank (rank >= S and invalid lanes dropped)
    src = torch.randint(-2**31, 2**31 - 1, (R, C, W), generator=gen, device=dev, dtype=torch.int32)
    d_clean, rank, _ = k4
    keep = (d_clean < R) & (rank < S)
    dstpos = torch.where(keep, d_clean * S + rank, R * S)
    k_out = BS.scatter_rows(src, dstpos, num_slots=R * S)
    p_out = BS.scatter_rows_plain(src, dstpos, num_slots=R * S)
    bb, pos_long = torch.arange(R, device=dev)[:, None].expand(R, C), dstpos.long()

    def library_k5():
        out = torch.zeros(R, R * S + 1, W, dtype=torch.int32, device=dev)
        return out.index_put_((bb, pos_long), src)

    ok = torch.equal(k_out, p_out) and torch.equal(library_k5()[:, :R * S], p_out)
    check(ok, f"K5 scatter_rows src {tuple(src.shape)} -> {tuple(k_out.shape)}: bit-equal to plain")
    landed = int(keep.sum())
    rows["scatter_rows"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: BS.scatter_rows(src, dstpos, num_slots=R * S),
            lambda: BS.scatter_rows_plain(src, dstpos, num_slots=R * S), library_k5),
        nbytes=landed * W * 4 + dstpos.numel() * 4 + k_out.numel() * 4, ops=0.0,
        library_call="zeros + index_put_ at the positions",
    )
    del k_out, p_out

    # K6: emit masks of the streamlines shape and of the VoPaT shape; the
    # last (VoPaT's) goes in the report, each one is kept under at_shapes
    at_shapes = {}
    for shape in MASKS:
        mask = torch.rand(shape, generator=gen, device=dev) < 0.6
        kp, kt = CO.compact_positions(mask)
        pp, pt = CO.compact_positions_plain(mask)
        ok = torch.equal(kp, pp) and torch.equal(kt, pt)
        check(ok, f"K6 compact_positions mask {shape}: positions and totals bit-equal to plain")
        r = dict(
            max_abs_err=0.0 if ok else float((kp - pp).abs().max()),
            **T(lambda: CO.compact_positions(mask), lambda: CO.compact_positions_plain(mask),
                lambda: torch.cumsum(mask, dim=1, dtype=torch.int32)),
            nbytes=mask.numel() * (1 + 4) + kt.numel() * 4, ops=0.0,
            library_call="torch.cumsum", shape=shape,
        )
        _one_launch("compact_positions", "compact_kernel", r["events"], dev)
        _print_row(f"compact_positions {shape}", r)
        at_shapes[str(shape)] = {k: v for k, v in r.items() if k != "at_shapes"}
        rows["compact_positions"] = r
    rows["compact_positions"]["at_shapes"] = at_shapes

    # K7 on the sorted Fig-8 payload.  The two-pass marshal path is timed
    # from the counts set to 0: K3 + sort, the sorted payload (K1 gathers
    # it, with an S-row tail so no segment start is clipped), K7 copies the
    # segments; it must give K1's fused send buffer on every valid row.
    KN.reset_launch_counts()
    perm, _, hist = SO.sort_permutation(dest, count, R)
    tail = torch.zeros(R, S, dtype=torch.int32, device=dev)
    sorted_buf = MO.gather_rows(src, torch.cat([perm, tail], dim=1))  # (R, C+S, W)
    off = torch.cumsum(hist[:, :R], 1, dtype=torch.int32) - hist[:, :R]
    two_pass = MO.marshal(sorted_buf, off, num_ranks=R, slot=S)
    two_pass_launches = KN.launch_counts()
    fused = ST.padded_send_buffer(src, perm, hist[:, :R], num_ranks=R, peer_capacity=S)
    valid = torch.arange(S, device=dev) < torch.clamp(hist[:, :R], max=S)[:, :, None]
    check(torch.equal(two_pass[valid], fused[valid]),
          f"K3 + sort + K7 == K1's fused marshal on the {int(valid.sum())} valid rows")
    if dev.type == "cuda":
        check(two_pass_launches["marshal"] == 1, f"two-pass marshal launched K7 once: {two_pass_launches}")
    k_out = MO.marshal(sorted_buf, off, num_ranks=R, slot=S)
    p_out = MO.marshal_plain(sorted_buf, off, num_ranks=R, slot=S)
    cap2 = sorted_buf.shape[1]
    seg = (off.long().clamp(0, cap2 - S)[:, :, None] + torch.arange(S, device=dev)).reshape(R, -1)
    seg_w = seg[:, :, None].expand(-1, -1, W)
    ok = torch.equal(k_out, p_out) and torch.equal(torch.gather(sorted_buf, 1, seg_w).reshape(k_out.shape), p_out)
    check(ok, f"K7 marshal sorted {tuple(sorted_buf.shape)} -> {tuple(k_out.shape)}: bit-equal to plain")
    read = torch.zeros(R, cap2, dtype=torch.bool, device=dev).scatter_(1, seg, True)
    rows["marshal"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.marshal(sorted_buf, off, num_ranks=R, slot=S),
            lambda: MO.marshal_plain(sorted_buf, off, num_ranks=R, slot=S),
            lambda: torch.gather(sorted_buf, 1, seg_w)),
        nbytes=int(read.sum()) * W * 4 + off.numel() * 4 + k_out.numel() * 4, ops=0.0,
        library_call="torch.gather at the segment rows",
    )
    del k_out, p_out, two_pass, fused, sorted_buf, src

    rows["pairwise_accel"] = _kernel_k9(dev, gen, timer, dtimer, *NBODY, SAMPLE)
    KN.reset_launch_counts()
    rows["track"], woodcock_launches = _kernel_k10(dev, gen, timer, dtimer, RAYS)

    for name, r in rows.items():
        _print_row(name, r)
    return rows, {"two_pass_marshal": two_pass_launches, "woodcock_check": woodcock_launches}


def _print_row(name, r):
    """Bound, L2 state and one line of times: device ms (call ms) of the
    kernel, its plain version and the library call."""
    r["bound_ms"], r["bound_by"] = bound_ms(r["nbytes"], r["ops"])
    r["l2_warm"] = r["nbytes"] <= L2_BYTES  # back-to-back calls find the working set in L2
    fmt = lambda pre: ("n/a" if r[f"{pre}device_ms"] is None
                       else f"{r[f'{pre}device_ms']:.4f} ({r[f'{pre}call_ms']:.4f})")
    print(f"  {name}: device ms (call ms) kernel {fmt('')} plain {fmt('plain_')} library "
          f"{fmt('library_')}; bound {r['bound_ms']:.4f} ({r['bound_by']}: {r['nbytes']} B, "
          f"{r['ops']:.0f} ops; L2-{'warm' if r['l2_warm'] else 'cold'}); "
          f"{kernels_a_call(r['events'])} kernels a call {r['events']}; "
          f"max_abs_err {r['max_abs_err']:.3e}", flush=True)


def _one_launch(name, kernel, events, dev):
    """The wrapper ``name`` made one launch of its CUDA ``kernel`` a call, at
    most one memset, and no other device work (no fill kernel)."""
    if dev.type != "cuda":
        return
    if events is None:
        check(False, f"{name}: launches a call not seen (the profiler recorded no device event)")
        return
    kern = {k: v for k, v in events.items() if not k.startswith("Mem")}
    memset = sum(v for k, v in events.items() if k.startswith("Memset"))
    other = sum(v for k, v in events.items() if k.startswith("Memcpy"))
    check(len(kern) == 1 and kernel in next(iter(kern)) and next(iter(kern.values())) == 1
          and memset <= 1 and other == 0,
          f"{name}: one kernel launch a call, at most one memset, no fill: {events}")


def _kernel_k2_at(dev, gen, timer, dtimer, B, G, S, W):
    """K2 at VoPaT's shape (capacity S): counts uniform in [0, S/4), about
    S rows offered a rank, so some ranks overflow; bit-equal to plain, and
    the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.marshal import ops as MO

    recv = torch.randint(-2**31, 2**31 - 1, (B, G, S, W), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(0, S // 4, (B, G), generator=gen, device=dev, dtype=torch.int32)
    off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    ok = torch.equal(MO.unmarshal(recv, off, counts, capacity=S),
                     MO.unmarshal_plain(recv, off, counts, capacity=S))
    check(ok, f"K2 unmarshal recv {(B, G, S, W)} capacity {S}: bit-equal to plain")
    landed = int(torch.clamp(counts.sum(1), max=S).sum())
    r = dict(max_abs_err=0.0 if ok else float("nan"), shape=(B, G, S, W), offered=int(counts.sum()),
             **_timed(timer, dtimer, lambda: MO.unmarshal(recv, off, counts, capacity=S), None),
             nbytes=landed * W * 4 + 2 * counts.numel() * 4 + B * S * W * 4, ops=0.0)
    _print_row(f"unmarshal at {(B, G, S, W)}", r)
    return r


def _k8_work(n):
    """K8's bytes (12 B read, 24 B written a particle) and float32
    operations: per particle 4 velocity evaluations of 6 sin/cos + 9 flops
    (ABC), 18 flops forming the stage inputs, 21 in the final combination."""
    return dict(nbytes=n * 12 + 2 * n * 12, ops=n * (4 * 15 + 18 + 21))


def _kernel_k8_at(dev, gen, timer, dtimer, n):
    """K8 at the streamlines drive's shape (8 ranks x 131,072 particles):
    ABC within 1e-5 of plain, and the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.rk4_advect import ops as RO

    pos = torch.rand((n, 3), generator=gen, device=dev) * 6.283185307179586
    err = max(float((a - b).abs().max()) for a, b in
              zip(RO.rk4_step(pos, dt=0.1), RO.rk4_step_plain(pos, dt=0.1)))
    check(err <= 1e-5, f"K8 rk4_step pos {(n, 3)} ABC: max abs diff {err:.3e} <= 1e-5")
    r = dict(max_abs_err=err, shape=(n, 3), **_timed(timer, dtimer, lambda: RO.rk4_step(pos, dt=0.1), None),
             **_k8_work(n))
    _print_row(f"rk4_step at {(n, 3)}", r)
    return r


def _kernel_k4_at(dev, gen, timer, dtimer, B, C):
    """K4 at VoPaT's shape (the scatter marshal's plan of its 1,048,576-lane
    queues): Fig-8-like destinations, count < C on some rows; bit-equal to
    plain, one launch a call, and the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.bucket_scatter import ops as BS

    dest = _fig8_dest(gen, B, C, dev)
    count = torch.full((B,), C, dtype=torch.int32, device=dev)
    count[1::3] = C // 3
    got = BS.rank_and_histogram(dest, count, num_ranks=B)
    ok = all(torch.equal(a, b) for a, b in zip(got, BS.rank_and_histogram_plain(dest, count, num_ranks=B)))
    check(ok, f"K4 rank_and_histogram dest {(B, C)}: d_clean, rank and histogram bit-equal to plain")
    r = dict(max_abs_err=0.0 if ok else float("nan"), shape=(B, C),
             **_timed(timer, dtimer, lambda: BS.rank_and_histogram(dest, count, num_ranks=B), None),
             nbytes=dest.numel() * 4 * 3 + count.numel() * 4 + got[2].numel() * 4, ops=0.0)
    _one_launch(f"rank_and_histogram at {(B, C)}", "rank_hist_kernel", r["events"], dev)
    _print_row(f"rank_and_histogram at {(B, C)}", r)
    return r


def _kernel_k9(dev, gen, timer, dtimer, B, N, M, sample, eps2=1e-3):
    """K9 at the nbody path's shape: B ranks × N targets (every rank's queue
    capacity) against M = N + 2·72 sources (the local lanes, the roots and
    the octants), positions drawn like the app's (0.5 ± 0.15, clipped), the
    last 144 sources spread over the box with octant-sized masses or none.
    K9 and the float32 plain version are held against a float64 evaluation
    of the first ``sample`` targets of ranks 0 and B-1: per component, the
    error over the row's sum of |terms| must be at most 1e-5, and K9's at
    most 2× the plain version's."""
    import torch

    from repro_torch.kernels.nbody_forces import ops as NO

    xi = torch.clamp(0.5 + 0.15 * torch.randn((B, N, 3), generator=gen, device=dev), 0.05, 0.95)
    extra = M - N
    xj = torch.cat([xi, torch.rand((B, extra, 3), generator=gen, device=dev)], dim=1)
    m_far = (N / 64) * (0.5 + torch.rand((B, extra), generator=gen, device=dev))
    m_far[:, extra // 2:] = 0.0
    mj = torch.cat([0.5 + torch.rand((B, N), generator=gen, device=dev), m_far], dim=1)
    got = NO.pairwise_accel(xi, xj, mj, eps2=eps2)
    rows = [0, B - 1]
    sx, sj, sm = xi[rows, :sample], xj[rows], mj[rows]
    plain = NO.pairwise_accel_plain(sx, sj, sm, eps2=eps2)
    want, scale = _accel_float64(sx, sj, sm, eps2)
    k_err = ((got[rows, :sample].double() - want).abs() / scale).max().item()
    p_err = ((plain.double() - want).abs() / scale).max().item()
    kp_err = ((got[rows, :sample] - plain).abs().double() / scale).max().item()
    max_abs = (got[rows, :sample] - plain).abs().max().item()
    print(f"  K9 against float64 on {len(rows)}x{sample} targets x {M} sources: error / sum|terms| "
          f"K9 {k_err:.3e}, plain {p_err:.3e}, K9 - plain {kp_err:.3e} (max abs {max_abs:.3e})", flush=True)
    check(bool(torch.isfinite(got).all()), f"K9 pairwise_accel ({B}, {N}) x ({B}, {M}): finite")
    check(k_err <= 1e-5 and p_err <= 1e-5,
          "K9 and its plain version within 1e-5 of the float64 sum (relative to sum|terms|)")
    check(k_err <= 2 * p_err, f"K9's error {k_err:.3e} <= 2x the plain version's {p_err:.3e}")
    return dict(
        max_abs_err=max_abs,
        **_timed(timer, dtimer, lambda: NO.pairwise_accel(xi, xj, mj, eps2=eps2),
                 lambda: NO.pairwise_accel_plain(sx, sj, sm, eps2=eps2), reps=5, warmup=1),
        plain_shape=f"({len(rows)}, {sample}) targets x ({len(rows)}, {M}) sources",
        library_call=None,
        nbytes=B * N * 12 + B * M * 16 + B * N * 12, ops=20.0 * B * N * M,
        float64_err={"kernel": k_err, "plain": p_err, "kernel_vs_plain": kp_err},
    )


def _accel_float64(xi, xj, mj, eps2, rows=64):
    """The accelerations in float64 and, per component, the sum of the
    absolute terms, a few targets at a time."""
    import torch

    xi, xj, mj = xi.double(), xj.double(), mj.double()
    acc, scale = torch.empty_like(xi), torch.empty_like(xi)
    for s in range(0, xi.shape[1], rows):
        dx = xj[:, None] - xi[:, s:s + rows, None]
        r2 = (dx * dx).sum(-1) + eps2
        terms = (mj[:, None] / (r2 * torch.sqrt(r2)))[..., None] * dx
        acc[:, s:s + rows], scale[:, s:s + rows] = terms.sum(2), terms.abs().sum(2)
    return acc, scale


def k10_inputs(dev, gen, size, steps=8):
    """K10's inputs at the VoPaT scene's shape: the ``size``² camera rays
    that enter [0,1]³, from the domain entry to the domain exit, uniforms
    ``(N, steps, 2)`` drawn from ``gen``, and the scene's 6 blobs.  Returns
    ``(args, majorant)``, ``args`` as ``track`` takes them."""
    import torch

    from repro_torch.apps import fields as F

    o, d = F.camera_rays(size, size, device=dev)
    t_in, inside = F.ray_domain_entry(o, d)
    o, d, t0 = o[inside].contiguous(), d[inside].contiguous(), t_in[inside]
    t_exit, _, _ = F.ray_box_exit(o, d, t0, torch.zeros_like(t0), torch.ones_like(t0))
    blobs = torch.from_numpy(F.default_blobs(6, 0)).to(dev)
    u = torch.rand((o.shape[0], steps, 2), generator=gen, device=dev)
    return (o, d, t0, t_exit, u, blobs), F.majorant(blobs)


def k10_work(steps_taken, blobs):
    """K10's bound inputs, counted from the steps each ray takes (the walk
    ends at the first status change): a ray reads o, d (12 B each), t0,
    t_exit and writes t, status (4 B each), and reads 8 B of uniforms a step
    it takes; 14 float32 operations a blob a step.  Returns ``(bytes, ops)``."""
    n, total = steps_taken.numel(), int(steps_taken.sum())
    return n * (12 + 12 + 4 + 4 + 4 + 4) + 8 * total + blobs.numel() * 4, float(total * blobs.shape[0] * 14)


def _kernel_k10(dev, gen, timer, dtimer, size, steps=8):
    """K10 at the VoPaT scene's shape (``k10_inputs``), K = 8 steps through
    the scene's 6 blobs.  ``t`` within rtol 1e-6 and statuses equal to the
    plain version's, except on near-ties (|u₁·μ̄ − σ| < 1e-5·μ̄ at a step the
    ray took), which must be under 0.01% of the rays.  The bound counts the
    steps the rays take in the plain version's walk (``k10_work``).  Its
    launches are those of the one checked call."""
    import torch

    from repro_torch import kernels as KN
    from repro_torch.kernels.delta_tracking import ops as DO

    args, maj = k10_inputs(dev, gen, size, steps)
    kt, ks = DO.track(*args, majorant=maj, steps=steps)
    launches = KN.launch_counts()
    pt, ps = DO.track_plain(*args, majorant=maj, steps=steps)
    tie, taken = _woodcock_near_tie(*args, maj, steps)
    n, n_tie = args[0].shape[0], int(tie.sum())
    differ = ks != ps
    t_bad = ~torch.isclose(kt, pt, rtol=1e-6, atol=0.0) & ~tie
    hist = torch.bincount(taken, minlength=steps + 1).tolist()
    nbytes, ops = k10_work(taken, args[5])
    print(f"  K10 track on {n} rays x {steps} steps: statuses differ on {int(differ.sum())} rays, "
          f"all near-ties: {not bool((differ & ~tie).any())}; near-ties {n_tie}; "
          f"statuses STILL/HIT/EXITED {[int((ps == k).sum()) for k in (0, 1, 2)]}; "
          f"steps taken over 0..{steps} {hist}, mean {int(taken.sum()) / n:.4f}, "
          f"so {nbytes / n:.2f} B a ray", flush=True)
    check(not bool((differ & ~tie).any()) and not bool(t_bad.any()),
          f"K10 track ({n} rays): t within rtol 1e-6 and statuses equal to plain but for near-ties")
    check(int(differ.sum()) < 1e-4 * n, f"K10: {int(differ.sum())} status differences < 0.01% of {n} rays")
    return dict(
        max_abs_err=(kt - pt)[~tie].abs().max().item(),
        **_timed(timer, dtimer, lambda: DO.track(*args, majorant=maj, steps=steps),
                 lambda: DO.track_plain(*args, majorant=maj, steps=steps)),
        library_call=None, nbytes=nbytes, ops=ops, rays=n, near_ties=n_tie,
        steps_histogram=hist, mean_steps=int(taken.sum()) / n,
    ), launches


def _woodcock_near_tie(o, d, t0, t_exit, u, blobs, maj, steps):
    """The plain version's walk, replayed: ``(tie, taken)``.  ``tie`` marks
    the rays that meet |u₁·μ̄ − σ| < 1e-5·μ̄ at a step where the ray is still
    tracking and inside its exit (an ulp of ``expf`` or ``log1pf`` may flip
    such a step); ``taken`` (int64) counts the steps each ray takes, those
    at which it is still tracking."""
    import torch

    from repro_torch.kernels.delta_tracking import ops as DO

    mu = torch.tensor(maj, dtype=torch.float32, device=t0.device)
    t, status = t0, torch.zeros_like(t0, dtype=torch.int32)
    tie = torch.zeros_like(t0, dtype=torch.bool)
    taken = torch.zeros_like(t0, dtype=torch.int64)
    for k in range(steps):
        active = status == DO.STILL
        taken += active
        t_new = t - torch.log1p(-u[:, k, 0]) / mu
        sigma = DO.density(o + t_new[:, None] * d, blobs)
        inside = active & (t_new < t_exit)
        tie |= inside & ((u[:, k, 1] * mu - sigma).abs() < 1e-5 * mu)
        hit = inside & (u[:, k, 1] * mu < sigma)
        t = torch.where(active, t_new, t)
        status = torch.where(active & ~inside, DO.EXITED, torch.where(hit, DO.HIT, status)).to(torch.int32)
    return tie, taken


# --------------------------------------------------------------- 2. forward
def _ray44_types():
    import dataclasses

    import torch

    from repro_torch.core import work_item

    @work_item
    @dataclasses.dataclass
    class Ray44:
        """The paper's Fig-8 payload: a 44-byte ray (11 × f32/i32)."""

        origin: torch.Tensor
        direction: torch.Tensor
        tmin: torch.Tensor
        pixel: torch.Tensor
        integral: torch.Tensor
        extra: torch.Tensor

    return Ray44


def _same_queue(a, b, *, all_lanes: bool) -> bool:
    import torch

    from repro_torch.core import types as T

    if not (torch.equal(a.count.cpu(), b.count.cpu()) and torch.equal(a.drops.cpu(), b.drops.cpu())):
        return False
    pa, _ = T.pack_payload(a.items, batch_dims=2)
    pb, _ = T.pack_payload(b.items, batch_dims=2)
    pa, pb = pa.cpu(), pb.cpu()
    if all_lanes:
        return torch.equal(pa, pb)
    lane = torch.arange(pa.shape[1])
    mask = lane[None, :] < a.count.cpu()[:, None]
    return torch.equal(pa[mask], pb[mask])


def phase_forward(dev, R=8, C=262144, S=65536, reps=10, timer_events=True):
    import torch

    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, WorkQueue, forward_work
    from repro_torch.core import types as T

    Ray44 = _ray44_types()
    gen = torch.Generator(device=dev).manual_seed(44)
    f32 = lambda *s: torch.randn((R, C) + s, generator=gen, device=dev)
    pixel = torch.arange(R * C, dtype=torch.int32, device=dev).reshape(R, C)
    q = WorkQueue(
        items=Ray44(origin=f32(3), direction=f32(3), tmin=f32(), pixel=pixel, integral=f32(), extra=f32(2)),
        dest=_fig8_dest(gen, R, C, dev),
        count=torch.full((R,), C, dtype=torch.int32, device=dev),
        drops=torch.zeros(R, dtype=torch.int32, device=dev),
    )
    cfg = ForwardConfig(R, C, peer_capacity=S)
    comm = StackedCollectives()
    KN.reset_launch_counts()
    new_q, total = forward_work(q, cfg, comm=comm)
    launches = KN.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(pack_and_histogram=1, gather_rows=1, unmarshal=1)
    if dev.type == "cuda":
        check(launches == want, f"one padded round launched K3, K1, K2 once each: {launches}")
    kinds = sorted((c.kind, c.shape) for c in comm.calls.elements())
    check(kinds == sorted([("all_to_all", (R, R, 1)), ("all_to_all", (R, R, S, 11)), ("psum", (R,))]),
          f"call recorder: one payload and one count all_to_all + the psum: {kinds}")

    oq, ototal = forward_work(q, ForwardConfig(R, C, exchange="onehot"))
    check(_same_queue(new_q, oq, all_lanes=False) and int(total) == int(ototal),
          f"padded round == onehot oracle on {dev.type}: count, drops, total {int(total)}, lanes < count")
    cpu_q = WorkQueue(items=T.tree_map(lambda t: t.cpu(), q.items), dest=q.dest.cpu(),
                      count=q.count.cpu(), drops=q.drops.cpu())
    cq, ctotal = forward_work(cpu_q, cfg)
    check(_same_queue(new_q, cq, all_lanes=True) and int(total) == int(ctotal),
          "round on the card == the same round on the CPU (plain versions), every lane")
    print(f"  round: {R}x{C} rays of 44 B, S={S}: delivered {int(total)}, "
          f"drops {int(new_q.drops.sum())}", flush=True)

    # the scatter round: K4 plans, K5 marshals, K2 compacts; no K1, no K3
    scfg = ForwardConfig(R, C, peer_capacity=S, marshal="scatter")
    scomm = StackedCollectives()
    KN.reset_launch_counts()
    sq, stotal = forward_work(q, scfg, comm=scomm)
    launches = KN.launch_counts()
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(rank_and_histogram=1, scatter_rows=1, unmarshal=1)
        check(launches == want, f"one scatter round launched K4, K5, K2 once each and no K1, K3: {launches}")
    skinds = sorted((c.kind, c.shape) for c in scomm.calls.elements())
    check(skinds == kinds, f"scatter round: one payload and one count all_to_all + the psum: {skinds}")
    check(_same_queue(sq, new_q, all_lanes=False) and int(stotal) == int(total),
          "scatter round == sort round: count, drops, total, lanes < count")
    check(_same_queue(sq, oq, all_lanes=False) and int(stotal) == int(ototal),
          "scatter round == onehot oracle: count, drops, total, lanes < count")

    if not timer_events:
        return {"delivered": int(total)}
    out = {"delivered": int(total)}
    for label, c in (("sort", cfg), ("scatter", scfg)):
        whole, split = _time_round(q, c, reps)
        out[label] = {"round_ms": whole, "stages_ms": split}
        print(f"  {label} round median {whole:.3f} ms; stages of forward_work (median ms, sum "
              f"{sum(split.values()):.3f}): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              flush=True)
    return out


def _print_split(label, whole, split):
    print(f"  {label}: median {whole:.3f} ms; stages (median ms, sum {sum(split.values()):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)


def _time_round(q, cfg, reps):
    """Median round time, then the stage split of the same ``forward_work``
    call, with a CUDA event recorded at each stage boundary (``on_stage``)."""
    import torch

    from repro_torch.core import forward_work

    whole = cuda_ms(lambda: forward_work(q, cfg), reps=reps)
    splits, marked = {}, []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marked.append((name, ev))

    for i in range(reps + 3):
        marked.clear()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        forward_work(q, cfg, on_stage=mark)
        marked[-1][1].synchronize()
        if i >= 3:
            prev = start
            for name, ev in marked:
                splits.setdefault(name, []).append(prev.elapsed_time(ev))
                prev = ev
    return whole, {k: statistics.median(v) for k, v in splits.items()}


# -------------------------------------------------------------- 3. lossless
def _chaos_ray_type():
    import dataclasses

    import torch

    from repro_torch.core import work_item

    @work_item
    @dataclasses.dataclass
    class ChaosRay:
        """The Fig-8 ray's 11 words, the scenario's uid in the first."""

        uid: torch.Tensor  # () i32
        ballast: torch.Tensor  # (10,) f32, derived from the uid

    return ChaosRay


def _ballast(uid):
    import torch

    return uid.to(torch.float32)[..., None] * torch.arange(1, 11, device=uid.device) * 0.25


class ScenarioDrive:
    """A schedule of ``repro_torch.chaos`` driven through ``run_until_done``'s
    pieces, as ``repro.chaos.run_scenario`` drives it: round 0's emissions
    seed the queue; body round ``rnd`` folds its arrivals into per-rank
    (count, Σuid, Σuid²) mod 2³² checksums (and counts arrivals whose
    ballast lost its bits) and emits schedule row ``rnd + 1`` (K6 under
    ``enqueue``).  ``step()`` runs one forwarding round; ``observe()`` reads
    the retained rows, their largest age, and how many of them sit on a
    rank other than their source (parked after a later tier)."""

    def __init__(self, sc, cfg, dev):
        import torch

        from repro_torch.core import DISCARD, StackedCollectives, enqueue, make_queue
        from repro_torch.core import termination as TERM

        self.sc, self.cfg, self.dev, self.TERM = sc, cfg, dev, TERM
        R, E, C = sc.num_ranks, sc.emits_per_round, cfg.capacity
        ChaosRay = _chaos_ray_type()
        proto = ChaosRay(uid=torch.zeros((), dtype=torch.int32), ballast=torch.zeros(10))
        dests = torch.from_numpy(sc.dests).to(dev)
        me = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
        lane = torch.arange(C, device=dev)[None, :]
        e_idx = torch.arange(E, device=dev)

        def emit(rnd):
            q = make_queue(proto, C, num_ranks=R, device=dev)
            row = dests[min(rnd, sc.rounds - 1)]
            mask = (row >= 0) & (rnd < sc.rounds)
            uid = ((rnd * R + me) * E + e_idx).to(torch.int32)
            return enqueue(q, ChaosRay(uid=uid, ballast=_ballast(uid)), torch.where(mask, row, DISCARD), mask)

        def round_fn(q_in, acc, rnd):
            valid = lane < q_in.count[:, None]
            u = q_in.items.uid.to(torch.int64)
            bad = (valid[:, :, None] & (q_in.items.ballast != _ballast(q_in.items.uid))).sum(1).sum(1)
            z = torch.zeros_like(u)
            acc = acc + torch.stack([valid.sum(1), torch.where(valid, u, z).sum(1),
                                     torch.where(valid, u * u, z).sum(1), bad], dim=1)
            return emit(rnd + 1), acc & 0xFFFFFFFF

        self.round_fn, self.emit, self.lane, self.me = round_fn, emit, lane, me
        self.comm = StackedCollectives()
        self.carry = None

    def start(self):
        import torch

        q0 = self.emit(0)
        acc0 = torch.zeros(self.sc.num_ranks, 4, dtype=torch.int64, device=self.dev)
        self.carry = self.TERM.drive_start(q0, acc0, self.cfg, comm=self.comm)

    def running(self, max_rounds=64):
        return self.carry["rnd"] < max_rounds and int(self.carry["total"]) > 0

    def step(self):
        self.carry = self.TERM.drive_segment(self.round_fn, self.carry, self.cfg,
                                             seg_end=self.carry["rnd"] + 1, comm=self.comm)

    def observe(self):
        import torch

        q = self.carry["q"]
        held = (self.lane < q.count[:, None]) & (q.dest >= 0)
        src = (q.items.uid.to(torch.int64) // self.sc.emits_per_round) % self.sc.num_ranks
        return (int(held.sum()), int(self.carry["age"].max()), int((held & (src != self.me)).sum()))

    def result(self):
        import numpy as np

        q, acc, rounds, done, _age = self.TERM.drive_finalize(self.carry, self.cfg)
        acc = acc.cpu().numpy()
        return {"delivered": acc[:, :3].astype(np.uint32), "bad_ballast": int(acc[:, 3].sum()),
                "drops": int(q.drops.sum()), "rounds": rounds, "done": done,
                "resident": int(q.count.sum())}

    def run(self, max_rounds=64):
        """The whole drive through ``run_until_done`` (one host sync a
        round); returns ``(result, wall seconds)``."""
        import time as _time

        import torch

        from repro_torch.core import run_until_done

        q0 = self.emit(0)
        acc0 = torch.zeros(self.sc.num_ranks, 4, dtype=torch.int64, device=self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = _time.perf_counter()
        q, acc, rounds, done, _age = run_until_done(self.round_fn, q0, acc0, self.cfg, max_rounds=max_rounds)
        acc = acc.cpu()
        wall = _time.perf_counter() - t0
        return {"delivered": acc[:, :3].numpy().astype("uint32"), "bad_ballast": int(acc[:, 3].sum()),
                "drops": int(q.drops.sum()), "rounds": rounds, "done": done,
                "resident": int(q.count.sum())}, wall


def _same_result(a, b) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _same_state(a, b):
    """Two drives' carries hold the same queue, drops and ages, bit for bit."""
    import torch

    from repro_torch.core import types as T

    qa, qb = a.carry["q"], b.carry["q"]
    same = (torch.equal(qa.count, qb.count) and torch.equal(qa.drops, qb.drops)
            and torch.equal(a.carry["age"], b.carry["age"]) and int(a.carry["total"]) == int(b.carry["total"]))
    if not same:
        return False
    mask = a.lane < qa.count[:, None]
    pa, _ = T.pack_payload(qa.items, batch_dims=2)
    pb, _ = T.pack_payload(qb.items, batch_dims=2)
    return torch.equal(pa[mask], pb[mask]) and torch.equal(qa.dest[mask], qb.dest[mask])


def phase_lossless(dev, R=8, C=262144, E=32768, S=8192, FIG8_S=65536, reps=10,
                   HIER_CAPS=(((2, 4), (32768, 16384)), ((2, 2, 2), (32768, 32768, 32768))),
                   oracle_numbers=(11, 246311, 3), cpu_witness=True, timer=cuda_ms, stage_split=True):
    """``overflow="retain"`` and the hierarchical route on the card:
    (a) the flat padded retain drive of ``rotating_hotspot(R, 8, E)`` in both
    marshals against the port's numpy oracle, forward for forward; (b) one
    hierarchical drop round of the Fig-8 rays on 2×4 and 2×2×2 against the
    flat onehot round and the CPU, with its collective budget and times
    beside the flat padded round's; (c) the scenario of (a) through the
    hierarchical retain drive at tight tier capacities, sort and scatter in
    lockstep, rows parked after a later tier.  Round times are medians of
    ``reps``; with ``stage_split`` (CUDA events at the ``on_stage`` marks)
    each comes with its stage split, and the seed round of (a) is timed so
    too.  Returns ``(record, launches per path)``."""
    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, WorkQueue, forward_work
    from repro_torch.core import types as T

    out, paths = {}, {}
    sc = TC.rotating_hotspot(R, 8, E)
    expected = TC.expected_by_rank(sc)
    t0 = time.perf_counter()
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=C)
    oracle_s = time.perf_counter() - t0
    peak = max(sim["retained_trace"])
    print(f"  oracle: rotating_hotspot({R}, 8, {E}), capacity {C}, peer_capacity {S}: {sim['rounds']} "
          f"rounds, retained peak {peak}, age max {sim['age_max']}, drops {sim['drops']} ({oracle_s:.1f} s)",
          flush=True)
    check((sim["rounds"], peak, sim["age_max"]) == oracle_numbers and sim["drops"] == 0 and sim["done"],
          f"oracle: (rounds, retained peak, age max) {(sim['rounds'], peak, sim['age_max'])} == "
          f"{oracle_numbers}, 0 drops")
    check(np.array_equal(sim["delivered"], expected), "oracle delivers expected_by_rank")

    # (a) the flat retain drive, each marshal: observed forward by forward,
    # then (warm) through run_until_done, timed, its launches counted
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(R, C, peer_capacity=S, marshal=marshal, overflow="retain")
        d = ScenarioDrive(sc, cfg, dev)
        d.start()
        trace = [d.observe()]
        while d.running():
            d.step()
            trace.append(d.observe())
        res = d.result()
        ok = ([t[0] for t in trace] == sim["retained_trace"] and [t[1] for t in trace] == sim["age_trace"]
              and res["rounds"] == sim["rounds"] and res["done"] and res["drops"] == 0
              and np.array_equal(res["delivered"], expected) and res["bad_ballast"] == 0)
        check(ok, f"(a) flat retain drive, {marshal}: rounds {res['rounds']}, retained and age traces, "
                  f"drops {res['drops']}, done, checksums == oracle and expected_by_rank")
        check(d.comm.count("all_to_all") == 2 * (res["rounds"] + 1),
              f"(a) {marshal}: one payload and one count all_to_all a forward")
        KN.reset_launch_counts()
        res2, wall = d.run()
        launches = KN.launch_counts()
        paths[f"lossless_flat_{marshal}"] = launches
        f = res2["rounds"] + 1
        check(_same_result(res2, res), f"(a) {marshal}: run_until_done == the observed drive")
        if dev.type == "cuda":
            # a forward: the plan, the send pass, the spill gather (K1), K2;
            # an enqueue (K6) seeds the drive and ends every body round
            want = dict.fromkeys(launches, 0)
            want.update(compact_positions=f, unmarshal=f)
            if marshal == "sort":
                want.update(pack_and_histogram=f, gather_rows=2 * f)
            else:
                want.update(rank_and_histogram=f, scatter_rows=f, gather_rows=f)
            check(launches == want, f"(a) {marshal}: launches over {f} forwards {launches}")
        print(f"  (a) {marshal}: {res['rounds']} rounds, wall {wall:.4f} s, {1e3 * wall / f:.3f} ms a "
              f"forwarding round (round_fn included); launches {launches}", flush=True)
        out[f"flat_retain_{marshal}"] = {"rounds": res["rounds"], "wall_s": wall, "ms_per_round": 1e3 * wall / f,
                                         "retained_trace": [t[0] for t in trace], "age_trace": [t[1] for t in trace]}
        if stage_split:  # the seed forward: round 0's emissions, the most spilled
            whole, split = _time_round(d.emit(0), cfg, reps)
            out[f"flat_retain_{marshal}"].update(seed_round_ms=whole, seed_stages_ms=split)
            _print_split(f"(a) {marshal} seed round ({sim['retained_trace'][0]} rows retained)", whole, split)
    out["oracle"] = {"rounds": sim["rounds"], "retained_peak": peak, "age_max": sim["age_max"], "seconds": oracle_s}

    # (b) one hierarchical drop round of the Fig-8 rays, default tier capacities
    Ray44 = _ray44_types()
    gen = torch.Generator(device=dev).manual_seed(45)
    f32 = lambda *s: torch.randn((R, C) + s, generator=gen, device=dev)
    q = WorkQueue(
        items=Ray44(origin=f32(3), direction=f32(3), tmin=f32(),
                    pixel=torch.arange(R * C, dtype=torch.int32, device=dev).reshape(R, C),
                    integral=f32(), extra=f32(2)),
        dest=_fig8_dest(gen, R, C, dev), count=torch.full((R,), C, dtype=torch.int32, device=dev),
        drops=torch.zeros(R, dtype=torch.int32, device=dev),
    )
    cpu_q = WorkQueue(items=T.tree_map(lambda t: t.cpu(), q.items), dest=q.dest.cpu(),
                      count=q.count.cpu(), drops=q.drops.cpu())
    oq, ototal = forward_work(q, ForwardConfig(R, C, exchange="onehot"))
    times, splits = {}, {}

    def timed(label, c):
        if stage_split:
            times[label], splits[label] = _time_round(q, c, reps)
            _print_split(f"(b) {label}", times[label], splits[label])
        else:
            times[label] = timer(lambda: forward_work(q, c), reps=reps)

    for marshal in ("sort", "scatter"):
        timed(f"flat_padded_{marshal}", ForwardConfig(R, C, peer_capacity=FIG8_S, marshal=marshal))
    for sizes, _caps in HIER_CAPS:
        tiers = [l for l in range(len(sizes)) if sizes[l] > 1]
        for marshal in ("sort", "scatter"):
            cfg = ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes, marshal=marshal)
            comm = StackedCollectives()
            KN.reset_launch_counts()
            hq, htotal = forward_work(q, cfg, comm=comm)
            launches = KN.launch_counts()
            name = "x".join(map(str, sizes))
            paths[f"hier_round_{name}_{marshal}"] = launches
            check(_same_queue(hq, oq, all_lanes=False) and int(htotal) == int(ototal),
                  f"(b) {name} {marshal} round == flat onehot round: count, drops, total {int(htotal)}, lanes < count")
            a2a = sorted((c.tier, len(c.shape)) for c in comm.calls.elements() if c.kind == "all_to_all")
            check(a2a == sorted([(l, 3) for l in tiers] + [(l, 4) for l in tiers]) and comm.count("psum") == 1,
                  f"(b) {name} {marshal}: one count and one payload all_to_all per tier {tiers}: {a2a}")
            if cpu_witness:
                cq, ctotal = forward_work(cpu_q, cfg)
                check(_same_queue(hq, cq, all_lanes=True) and int(htotal) == int(ctotal),
                      f"(b) {name} {marshal} round on {dev.type} == the same round on the CPU, every lane")
            if dev.type == "cuda":
                # the first tier's send pass is K1 (sort) or K5 (scatter), every
                # later tier gathers its buffer (K1), K2 compacts the last one
                want = dict.fromkeys(launches, 0)
                want.update(unmarshal=1)
                if marshal == "sort":
                    want.update(pack_and_histogram=1, gather_rows=len(tiers))
                else:
                    want.update(rank_and_histogram=1, scatter_rows=1, gather_rows=len(tiers) - 1)
                check(launches == want, f"(b) {name} {marshal}: launches {launches}")
            timed(f"hier_{name}_{marshal}", cfg)
    print("  (b) median round ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    out["round_ms"], out["stages_ms"] = times, splits
    out["hier_delivered"] = int(ototal)
    del oq, hq, cpu_q

    # (c) the hierarchical retain drive at tight tier capacities; sort and
    # scatter in lockstep, equal after every forward
    for sizes, caps in HIER_CAPS:
        name = "x".join(map(str, sizes))
        drives = {m: ScenarioDrive(sc, ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes,
                                                     level_capacities=caps, marshal=m, overflow="retain"), dev)
                  for m in ("sort", "scatter")}
        KN.reset_launch_counts()
        for d in drives.values():
            d.start()
        same, trace = _same_state(drives["sort"], drives["scatter"]), [drives["sort"].observe()]
        while drives["sort"].running() and drives["scatter"].running():
            for d in drives.values():
                d.step()
            same = same and _same_state(drives["sort"], drives["scatter"])
            trace.append(drives["sort"].observe())
        launches = KN.launch_counts()
        paths[f"lossless_hier_{name}"] = launches
        res = {m: d.result() for m, d in drives.items()}
        parked = sum(t[2] for t in trace)
        print(f"  (c) {name} caps {caps}: {res['sort']['rounds']} rounds, retained peak {max(t[0] for t in trace)}, "
              f"age max {max(t[1] for t in trace)}, rows parked after a later tier {parked} "
              f"(peak {max(t[2] for t in trace)}); launches (sort + scatter) {launches}", flush=True)
        r = res["sort"]
        check(np.array_equal(r["delivered"], expected) and r["drops"] == 0 and r["done"] and r["resident"] == 0
              and r["bad_ballast"] == 0,
              f"(c) {name} retain drive: checksums == expected_by_rank, 0 drops, done")
        check(parked > 0, f"(c) {name}: {parked} rows parked after a later tier (> 0)")
        check(same and _same_result(res["sort"], res["scatter"]), f"(c) {name}: scatter drive == sort drive after every forward")
        res2, wall = drives["sort"].run()  # warm: the whole sort drive through run_until_done
        check(_same_result(res2, r), f"(c) {name}: run_until_done == the observed drive")
        print(f"  (c) {name} sort drive: wall {wall:.4f} s, {1e3 * wall / (r['rounds'] + 1):.3f} ms a "
              "forwarding round (round_fn included)", flush=True)
        out[f"hier_retain_{name}"] = {"caps": caps, "rounds": r["rounds"], "parked_after_later_tier": parked,
                                      "retained_trace": [t[0] for t in trace], "age_trace": [t[1] for t in trace],
                                      "parked_trace": [t[2] for t in trace], "sort_wall_s": wall,
                                      "ms_per_round": 1e3 * wall / (r["rounds"] + 1)}
    return out, paths


# ----------------------------------------------------------- 4. streamlines
def profile_drive(run, dev, kernel=None):
    """Device-busy share of one drive under ``torch.profiler``: summed
    device time of every kernel and copy over the drive's wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound), and, given a ``kernel`` name, that kernel's share of the
    device time.  Returns None when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_events(prof)
    dev_us = lambda e: e.self_device_time_total
    busy_us = sum(dev_us(e) for e in stats)
    if busy_us <= 0:
        print("  device-busy share: not measured (the profiler saw no device time)", flush=True)
        return None
    top = sorted(stats, key=dev_us, reverse=True)[:6]
    share = busy_us / 1e6 / wall
    print(f"  profiled drive: wall {wall:.3f} s, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * share:.1f}%), top device time: "
          + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms" for e in top), flush=True)
    out = {"wall_s": wall, "device_busy_ms": busy_us / 1e3, "busy_share": share,
           "top": [(e.key[:200], dev_us(e) / 1e3) for e in top]}
    if kernel is not None:
        k_us = sum(dev_us(e) for e in stats if kernel in e.key)
        out[f"{kernel}_share"] = k_us / busy_us
        print(f"  {kernel}: {k_us / 1e3:.1f} ms, {100 * k_us / busy_us:.1f}% of the device time", flush=True)
    return out


def phase_streamlines(dev, fields=(("ABC", 0, 131072), ("tornado", 1, 16384), ("Taylor-Green", 2, 16384)),
                      max_steps=64, exact=True, profile=True):
    import numpy as np

    from repro_torch import kernels as KN
    from repro_torch.apps import streamlines as sl

    main_launches, out = None, {}
    for name, fid, n in fields:
        cfg = sl.StreamlineConfig(num_particles=n, max_steps=max_steps, dt=0.1, field_id=fid)
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        traces, lengths, stats = sl.run(cfg, num_ranks=8, device=dev)
        wall = time.perf_counter() - t0
        run_launches = KN.launch_counts()
        if main_launches is None:
            main_launches = run_launches  # the main path: reset just before, read just after
        orc = sl.oracle(cfg, device=dev)
        after_oracle = KN.launch_counts()
        same_mask = np.array_equal(np.isfinite(traces), np.isfinite(orc))
        m = np.isfinite(traces) & np.isfinite(orc)
        err = float(np.abs(traces[m] - orc[m]).max()) if m.any() else 0.0
        rounds = stats["rounds"]
        print(f"  {name}: N={n} rounds {rounds} mean streamline length {lengths.mean():.2f} "
              f"wall {wall:.3f} s oracle max err {err!r}", flush=True)
        check(same_mask, f"{name}: finite masks of run and oracle identical")
        check(err == 0.0 if exact else err <= 5e-4, f"{name}: multi-rank traces == single-rank oracle (max err {err!r})")
        check(stats["drops"] == 0, f"{name}: drops == 0")
        if dev.type == "cuda":
            check(after_oracle["rk4_step"] == rounds + max_steps,
                  f"{name}: K8 launches {after_oracle['rk4_step']} == body rounds {rounds} + oracle steps {max_steps}")
            for k in ("pack_and_histogram", "gather_rows", "unmarshal"):
                check(run_launches[k] == rounds + 1,
                      f"{name}: {k} launches {run_launches[k]} == forwarding rounds {rounds + 1}")
            # one enqueue builds the first queue, one per body round re-emits
            check(run_launches["compact_positions"] == rounds + 1,
                  f"{name}: K6 launches {run_launches['compact_positions']} == enqueue calls {rounds + 1}")
        out[name] = {"n": n, "rounds": rounds, "mean_length": float(lengths.mean()),
                     "wall_s": wall, "oracle_max_err": err}
        if profile and dev.type == "cuda" and name == fields[0][0]:
            out[name]["profile"] = profile_drive(lambda: sl.run(cfg, num_ranks=8, device=dev), dev)
    return out, main_launches


# ----------------------------------------------------------------- 5. vopat
def phase_vopat(dev, size=1024, R=8, profile=True, N_WORDS=2097152, CPU_SIZE=64):
    """The VoPaT main path: ``render`` through ``run_until_done`` with the
    scatter marshal, held against the R=1 render and the R=8 sort render,
    and against the CPU (the uniforms, and a ``CPU_SIZE``² render)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.apps import rng, vopat

    scene = vopat.VopatScene(width=size, height=size, spp=1, max_bounces=4, albedo=0.85, num_blobs=6)
    render = lambda r, marshal: vopat.render(scene, num_ranks=r, marshal=marshal, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    img, st = render(R, "scatter")  # ends in a copy to the host: synchronised
    wall = time.perf_counter() - t0
    launches = KN.launch_counts()
    rounds = st["rounds"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")
    print(f"  {size}x{size}, R={R}, scatter: rounds {rounds} wall {wall:.3f} s "
          f"({1e3 * wall / (rounds + 1):.2f} ms per forwarding round) drops {st['drops']} "
          f"queue capacity {st['capacity']} peak device memory {peak:.2f} GiB", flush=True)
    check(st["drops"] == 0, f"vopat: drops == 0 ({st['drops']})")
    if dev.type == "cuda":
        for k in ("rank_and_histogram", "scatter_rows", "unmarshal"):
            check(launches[k] == rounds + 1, f"vopat: {k} launches {launches[k]} == forwarding rounds {rounds + 1}")
        check(launches["compact_positions"] == rounds + 1,
              f"vopat: K6 launches {launches['compact_positions']} == enqueue calls {rounds + 1}")
        check(launches["gather_rows"] == 0 and launches["pack_and_histogram"] == 0,
              f"vopat: the scatter drive launched no K1 and no K3: {launches}")
    t1 = time.perf_counter()
    img1, st1 = render(1, "sort")
    wall1 = time.perf_counter() - t1
    t1 = time.perf_counter()
    img_sort, st_sort = render(R, "sort")
    wall_sort = time.perf_counter() - t1
    print(f"  R=1 render: rounds {st1['rounds']} wall {wall1:.3f} s; R={R} sort render: rounds "
          f"{st_sort['rounds']} wall {wall_sort:.3f} s; image mean {img.mean():.6f}", flush=True)
    check(np.array_equal(img, img1), f"vopat: R={R} scatter image == R=1 image, bit for bit")
    check(np.array_equal(img, img_sort), f"vopat: R={R} scatter image == R={R} sort image, bit for bit")
    check(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
          f"vopat: image finite and in [0, 1] (min {img.min()}, max {img.max()})")
    check(img.std() > 0.01, f"vopat: image is not constant (std {img.std():.4f})")

    # witnesses that share no arithmetic with the card: the uniforms'
    # threefry words on the CPU (bit for bit), and a small render on the CPU
    # (>= 99% of pixels within 1e-5, means within 1e-4: the tolerance of
    # tests/test_torch_vopat.py, since the card's expf/logf may differ by ulps)
    gen = torch.Generator().manual_seed(2024)
    pix = torch.randint(0, 2**31 - 1, (N_WORDS,), generator=gen, dtype=torch.int32)
    ev = torch.randint(0, 2**31 - 1, (N_WORDS,), generator=gen, dtype=torch.int32)
    u_dev = rng.event_uniforms(rng.key_from_seed(scene.seed, device=dev), pix.to(dev), ev.to(dev), 3).cpu()
    u_cpu = rng.event_uniforms(rng.key_from_seed(scene.seed), pix, ev, 3)
    check(torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32)),
          f"vopat: uniforms of {N_WORDS} (pixel, event) pairs on {dev.type} == on the CPU, bit for bit")
    small = dataclasses.replace(scene, width=CPU_SIZE, height=CPU_SIZE)
    img_dev, _ = vopat.render(small, num_ranks=R, marshal="scatter", device=dev)
    img_cpu, _ = vopat.render(small, num_ranks=R, marshal="scatter", device="cpu")
    close = float((np.abs(img_dev - img_cpu) <= 1e-5).mean())
    mean_gap = abs(float(img_dev.mean()) - float(img_cpu.mean()))
    print(f"  {CPU_SIZE}x{CPU_SIZE} render on {dev.type} against the CPU: max abs diff "
          f"{float(np.abs(img_dev - img_cpu).max())!r}, share within 1e-5 {close!r}, "
          f"mean gap {mean_gap!r}", flush=True)
    check(close >= 0.99 and mean_gap <= 1e-4,
          f"vopat: {CPU_SIZE}x{CPU_SIZE} R={R} scatter render on {dev.type} == CPU render "
          f"({100 * close:.2f}% of pixels within 1e-5, mean gap {mean_gap:.2e})")
    out = {"size": size, "num_ranks": R, "rounds": rounds, "wall_s": wall,
           "ms_per_round": 1e3 * wall / (rounds + 1), "peak_gib": peak, "r1_wall_s": wall1,
           "sort_wall_s": wall_sort, "image_mean": float(img.mean()),
           "cpu_witness": {"size": CPU_SIZE, "max_abs_diff": float(np.abs(img_dev - img_cpu).max()),
                           "share_within_1e-5": close, "mean_gap": mean_gap}}
    if profile and dev.type == "cuda":
        out["profile"] = profile_drive(lambda: render(R, "scatter"), dev)
    return out, launches


# ----------------------------------------------------------------- 6. nbody
def phase_nbody(dev, N=262144, R=8, steps=8, WITNESS_N=512, profile=True):
    """The N-body main path: ``run`` at R=8 against the direct-sum oracle,
    the R=1 run, launches per run, and a small run on the card against the
    same run on the CPU.  G = 64/N keeps G·M_total at the value of the
    64-particle, G = 1 system under which the reference set its 1e-2 bound
    (``tests/test_apps.py``); at the 256-particle example's G·M_total of 256
    the reference itself misses that bound (``examples/nbody_sim.py``)."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as KN
    from repro_torch.apps import nbody

    cfg = nbody.NBodyConfig(num_particles=N, steps=steps, dt=5e-4, theta=0.3, eps2=1e-3, g=64.0 / N)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    pos, vel, st = nbody.run(cfg, num_ranks=R, device=dev)  # ends in copies to the host
    wall = time.perf_counter() - t0
    launches = KN.launch_counts()
    po, vo = nbody.oracle(cfg, device=dev)
    err = float(np.abs(pos - po).max())
    t1 = time.perf_counter()
    p1, _, st1 = nbody.run(cfg, num_ranks=1, device=dev)
    wall1 = time.perf_counter() - t1
    err1 = float(np.abs(p1 - po).max())
    print(f"  N={N}, R={R}, {steps} steps: wall {wall:.3f} s ({1e3 * wall / steps:.1f} ms per step), "
          f"totals {st['totals']}, drops {st['drops']}, max |pos - oracle| {err!r}, "
          f"rms |vel - oracle| {float(np.sqrt(((vel - vo) ** 2).mean()))!r}; R=1: wall {wall1:.3f} s, "
          f"max |pos - oracle| {err1!r}", flush=True)
    # K9 runs over every lane of every rank's queue (capacity N), as the
    # reference does; the final owners say how many of those pairs are live
    cell = lambda a, g: np.clip((a * g).astype(np.int32), 0, g - 1)
    gx, gy, gz = st["dims"]
    live = np.bincount(cell(pos[:, 0], gx) + gx * (cell(pos[:, 1], gy) + gy * cell(pos[:, 2], gz)),
                       minlength=R)
    m_src = N + 2 * max(16, 9 * R)
    live_share = float((live * (live + m_src - N)).sum()) / (R * N * m_src)
    print(f"  particles per rank at the end {live.tolist()}; K9 computes {R * N * m_src:.3e} pairs a step, "
          f"{100 * live_share:.2f}% of them between live lanes", flush=True)
    check(st["totals"] == [N] * steps and st["drops"] == 0,
          f"nbody: every particle conserved (totals {N} each step, drops {st['drops']})")
    check(bool(np.isfinite(pos).all() and np.isfinite(vel).all()), "nbody: positions and velocities finite")
    check(err < 1e-2, f"nbody: R={R} positions within 1e-2 of the direct-sum oracle ({err:.3e})")
    check(st1["totals"] == [N] * steps and err1 <= 1e-5, f"nbody: R=1 positions within 1e-5 of the oracle ({err1!r})")
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(pairwise_accel=steps, pack_and_histogram=4 * steps, gather_rows=4 * steps,
                    unmarshal=4 * steps, compact_positions=4 * steps + 1)
        check(launches == want, f"nbody: K9 once a step, K3/K1/K2 four times, K6 once per enqueue: {launches}")

    # a witness off the card: the same small run on the CPU (plain versions)
    small = dataclasses.replace(cfg, num_particles=WITNESS_N, g=64.0 / WITNESS_N)
    t2 = time.perf_counter()
    pd, vd, sd = nbody.run(small, num_ranks=R, device=dev)
    wall_small = time.perf_counter() - t2  # a step's fixed cost: launches of four small rounds
    pc, vc, sc = nbody.run(small, num_ranks=R, device="cpu")
    gap_p, gap_v = float(np.abs(pd - pc).max()), float(np.abs(vd - vc).max())
    print(f"  N={WITNESS_N} R={R} on {dev.type}: wall {wall_small:.3f} s ({1e3 * wall_small / steps:.2f} ms "
          f"per step); against the CPU: max |pos| gap {gap_p!r}, max |vel| gap {gap_v!r}", flush=True)
    check(sd == sc and gap_p <= 1e-5 and gap_v <= 1e-4,
          f"nbody: N={WITNESS_N} run on {dev.type} == CPU run (totals, drops; pos 1e-5, vel 1e-4)")
    out = {"n": N, "num_ranks": R, "steps": steps, "g": cfg.g, "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
           "oracle_max_err": err, "r1_wall_s": wall1, "live_per_rank": live.tolist(), "k9_live_pair_share": live_share, "r1_oracle_max_err": err1,
           "cpu_witness": {"n": WITNESS_N, "pos_gap": gap_p, "vel_gap": gap_v, "wall_s": wall_small}}
    if profile and dev.type == "cuda":
        out["profile"] = profile_drive(lambda: nbody.run(cfg, num_ranks=R, device=dev), dev,
                                       kernel="pairwise_accel")
    return out, launches


# ------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    print(smi, flush=True)
    t_build = build.build()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}; "
          f"kernel build {t_build:.1f} s; card {torch.cuda.get_device_name(0)} [{smi}]", flush=True)
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": t_build}

    run = {"kernels": lambda: phase_kernels(dev), "forward": lambda: phase_forward(dev),
           "lossless": lambda: phase_lossless(dev),
           "streamlines": lambda: phase_streamlines(dev), "vopat": lambda: phase_vopat(dev),
           "nbody": lambda: phase_nbody(dev)}
    kernels, paths = {}, {}  # paths: launches per path, counted from 0
    for title in run:
        print(f"# phase {title}", flush=True)
        t0 = time.perf_counter()
        try:
            res = run[title]()
        except Exception:  # report every phase; any failure fails the run below
            traceback.print_exc()
            FAILURES.append(f"phase {title} raised")
            continue
        if title == "kernels":
            kernels, more = res
            paths.update(more)
        elif title == "lossless":
            record[title], more = res
            paths.update(more)
        elif title in ("streamlines", "vopat", "nbody"):
            record[title], paths[title] = res
        else:
            record[title] = res
        print(f"# phase {title} done in {time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    for k in KERNELS:
        launches[k] = sum(paths.get(p, {}).get(k, 0) for p in LAUNCH_PATHS[k])
        check(launches[k] > 0, f"{k}: {launches[k]} launches on {' + '.join(LAUNCH_PATHS[k])}")
    report = []
    for k, (source, replaces) in KERNELS.items():
        r = kernels.get(k)
        if r is None:
            continue
        report.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["device_ms"], "plain_ms": r["plain_device_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_device_ms"],
            "device_ms": r["device_ms"], "call_ms": r["call_ms"],
            "kernels_a_call": kernels_a_call(r["events"]), "device_events": r["events"],
            "l2_warm": r["l2_warm"],
        })
    record["kernels"] = report
    record["kernel_details"] = kernels
    record["paths"] = paths
    record["failures"] = FAILURES
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    if len(report) != len(KERNELS):
        FAILURES.append("a kernel has no measurement")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
