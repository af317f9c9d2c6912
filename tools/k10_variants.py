#!/usr/bin/env python3
"""K10 ``track``'s designs side by side on one NVIDIA card.

    python3 tools/k10_variants.py

Builds ``tools/k10_variants.cu`` (which includes the port's
``csrc/delta_tracking.cu``, so one library holds the shipped kernel, the
kernel the port shipped before, verbatim, and the variants between them)
and the shipped source alone at four other block shapes, all with the
port's ``nvcc`` flags and ``-Xptxas -v`` (registers and spills a kernel,
printed), then, at the smoke's K10 inputs (``chip_smoke.k10_inputs``: the
VoPaT scene's 777,924 camera rays, K = 8, 6 blobs):

  - holds every design bit for bit against the shipped one (``t`` and
    status), the shipped one against the plain version under the smoke's
    check, and the shipped one against itself on ``args[k:]`` (k = 0..3) and
    on a permutation of the rays (lane invariance);
  - holds the kernel's two divisions bit for bit against ``__fdiv_rn``:
    over every float x in [0, 64] as ``(−x) / μ̄`` and as ``(−0.5·x) / s²`` at
    the scene's majorant and each of its blob sizes (the largest ``r²`` and
    ``|log1p(−u₀)|`` the rays meet are printed beside that range), and on
    2^26 random pairs over those ranges and 2^26 over [2^-80, 2^70];
  - counts the steps the rays take (the plain version's walk) and from them
    the bytes bound, and the lane efficiency of one thread a ray (warps of
    32 consecutive rays) and of lane refill at the grids it runs;
  - counts the static SASS instructions of each kernel's step loop
    (``cuobjdump --dump-sass``: the smallest loop holding every ``expf``,
    rare paths included) and of the shipped step's fast path (a kernel
    built without the rare exact pass, never launched), and the issue time
    of that count over the steps taken; writes the SASS of four kernels to
    ``chiprun_out/k10_sass.txt``;
  - times, by device time (``chip_smoke.device_ms``), the parent and the
    shipped kernel in turns (parent, shipped, shipped, parent), then each
    variant twice: ``at_use`` (a step's uniforms as two 4-byte loads at the
    step), ``refill`` (lane refill over a span of rays a warp),
    ``refill_next`` (the same with each lane's next ray held in registers,
    also at 2 blocks an SM), ``resident`` (a grid of the resident blocks in
    a grid-stride loop), ``loop`` (the blob loop at run time) and the block
    shapes;
  - reads the SM clock and board power while the shipped kernel runs back
    to back.

Prints one JSON line and writes it to ``chiprun_out/k10_variants.json``.
Exits non-zero without a card or when any check fails.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import struct
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SM_ISSUE_LANES_PER_S = 132 * 128 * 1.98e9  # H100 SXM: 4 schedulers x 32 lanes an SM, boost clock
SHAPES = ((256, 1), (256, 4), (128, 8), (128, 12))  # (threads, min blocks an SM); shipped: 256, 6
KINDS = (("parent_kernel", "parent"), ("at_use_kernelILi(\\d+)E", "at_use"),
         ("fast_only_kernelILi(\\d+)E", "fast_only"), ("refill_kernelILi(\\d+)ELb0E", "refill"),
         ("refill_kernelILi(\\d+)ELb1E", "refill_next"), ("track_kernelILi(\\d+)E", "shipped"))


def _build():
    """The variants' library, and the shipped source alone at each block
    shape of SHAPES, all built at once.  Returns the variants' library,
    cuobjdump, registers a kernel, and the shape libraries."""
    from repro_torch import compat
    from repro_torch.kernels import build

    nvcc = compat.nvcc_path()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {None: (build.BUILD_DIR / "k10_variants.so", ROOT / "tools" / "k10_variants.cu", ())}
    for threads, blocks in SHAPES:
        jobs[(threads, blocks)] = (build.BUILD_DIR / f"k10_shape_{threads}_{blocks}.so",
                                   build.CSRC / "delta_tracking.cu",
                                   (f"-DRAFI_TRACK_THREADS={threads}", f"-DRAFI_TRACK_MIN_BLOCKS={blocks}"))
    procs = {key: subprocess.Popen([nvcc, *build.NVCC_FLAGS, *defs, "-Xptxas", "-v", "-shared", "-o",
                                    str(out), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for key, (out, src, defs) in jobs.items()}
    logs = {key: p.communicate()[0] for key, p in procs.items()}
    for key, p in procs.items():
        if p.returncode:
            print(logs[key], flush=True)
            raise RuntimeError(f"nvcc failed on {jobs[key][1]} {jobs[key][2]} (rc {p.returncode})")
    regs = _registers(logs[None])
    for shape in SHAPES:
        regs[f"shipped {shape[0]} threads, {shape[1]} blocks/SM"] = _registers(logs[shape]).get("shipped G=6")
    return (jobs[None][0], pathlib.Path(nvcc).with_name("cuobjdump"), regs,
            {shape: jobs[shape][0] for shape in SHAPES})


def _kind(fn):
    for pat, name in KINDS:
        m = re.search(pat, fn)
        if m:
            return name + (f" G={m.group(1)}" if m.groups() else "")
    return None


def _registers(log):
    """Registers and spill bytes of each track kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kind(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def _sass_step_loops(lib, cuobjdump, g, listing=None):
    """For each track kernel: the static SASS count of its step loop (the
    smallest loop, by backward branch, that holds every MUFU.EX2 inside a
    loop), its instructions by opcode, and an estimate of a step's count
    at ``g`` blobs where the blob loop runs at run time (the step loop less
    its inner loops, plus ``g`` times an inner loop's count per EX2)."""
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _kind(m.group(1))
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    if listing is not None:
        listing.write_text("\n".join(f"// {fn}\n" + "\n".join(f"{a:05x} {t}" for a, t in ins)
                                      for fn, ins in funcs.items()
                                      if fn in ("parent", f"shipped G={g}", f"fast_only G={g}",
                                                f"refill_next G={g}")))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", text)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        ex2 = [a for a, t in ins if "MUFU.EX2" in t and any(lo <= a <= hi for lo, hi in loops)]
        holding = [lh for lh in loops if all(lh[0] <= a <= lh[1] for a in ex2)]
        if not ex2 or not holding:
            continue
        lo, hi = min(holding, key=lambda lh: lh[1] - lh[0])
        body = [t for a, t in ins if lo <= a <= hi]
        ops = {}
        for t in body:
            op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        inner = [(a, b) for a, b in set(loops) if lo <= a and b <= hi and (a, b) != (lo, hi)]
        inner = [lh for lh in inner if not any(o != lh and o[0] <= lh[0] and lh[1] <= o[1] for o in inner)]
        step = len(body)
        for a, b in inner:
            n_in = sum(1 for x, _ in ins if a <= x <= b)
            e_in = sum(1 for x, t in ins if a <= x <= b and "MUFU.EX2" in t)
            step -= n_in
            if e_in:
                step += g * n_in / e_in / len([1 for a2, b2 in inner
                                                if any(a2 <= x <= b2 and "MUFU.EX2" in t for x, t in ins)])
        out[fn] = {"static_step_loop": len(body), "inner_loops": len(inner), "per_step_estimate": step,
                   "ex2": len(ex2), "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def sm_clock(fn, seconds=2.0):
    """The SM clock and board power (``nvidia-smi``, every 100 ms) while
    ``fn`` runs back to back: ``(median MHz, min MHz, max MHz, median W)``."""
    import statistics
    import time

    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, text=True)
    end = time.time() + seconds
    while time.time() < end:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    rows = [[float(x) for x in line.split(",")] for line in proc.communicate()[0].splitlines()
            if line.strip() and "," in line]
    mhz, watts = [r[0] for r in rows[2:]] or [0.0], [r[1] for r in rows[2:]] or [0.0]
    return statistics.median(mhz), min(mhz), max(mhz), statistics.median(watts)


def lane_efficiency_one_a_ray(taken):
    """Lane efficiency of one thread a ray, warps of 32 consecutive rays: a
    warp runs as long as its longest ray."""
    import torch

    n = taken.numel()
    pad = torch.zeros(-(-n // 32) * 32, dtype=taken.dtype, device=taken.device)
    pad[:n] = taken
    return float(taken.sum()) / (32 * float(pad.view(-1, 32).max(1).values.sum()))


def lane_efficiency_refill(taken, warps):
    """Lane efficiency of the shipped lane refill: ``warps`` warps, each a
    span of ceil(N / warps) rays, 32 in flight; an iteration of a warp is a
    step of every live lane."""
    import torch

    dev, n = taken.device, taken.numel()
    span = -(-n // warps)
    q = torch.zeros(warps * span, dtype=torch.int64, device=dev)
    q[:n] = taken
    q = q.view(warps, span)
    end = torch.clamp(n - torch.arange(warps, device=dev) * span, 0, span)
    rem = torch.zeros(warps, 32, dtype=torch.int64, device=dev)
    nxt = torch.zeros(warps, dtype=torch.int64, device=dev)
    iters = torch.zeros(warps, dtype=torch.int64, device=dev)
    while True:
        idle = rem == 0
        rank = torch.cumsum(idle, 1) - idle.long()
        take = idle & (nxt[:, None] + rank < end[:, None])
        rem = torch.where(take, q.gather(1, (nxt[:, None] + rank).clamp(max=span - 1)), rem)
        nxt = torch.minimum(nxt + idle.sum(1), end)
        busy = (rem > 0).any(1)
        if not bool(busy.any()):
            break
        iters += busy
        rem = (rem - 1).clamp(min=0)
    return float(taken.sum()) / (32 * float(iters.sum()))


def _walk_ranges(o, d, t0, t_exit, u, blobs, maj, steps):
    """The largest r² (to any blob) and |log1p(−u₀)| at the steps the rays
    take in the plain version's walk: the ranges the divisions meet."""
    import torch

    from repro_torch.kernels.delta_tracking import ops as DO

    mu = torch.tensor(maj, dtype=torch.float32, device=t0.device)
    t, status = t0, torch.zeros_like(t0, dtype=torch.int32)
    r2_max = lg_max = 0.0
    for k in range(steps):
        active = status == DO.STILL
        lg = torch.log1p(-u[:, k, 0])
        t_new = t - lg / mu
        p = o + t_new[:, None] * d
        r2 = ((p[:, None, :] - blobs[None, :, :3]) ** 2).sum(-1)
        r2_max = max(r2_max, float(r2[active].max()))
        lg_max = max(lg_max, float(lg[active].abs().max()))
        sigma = DO.density(p, blobs)
        inside = active & (t_new < t_exit)
        hit = inside & (u[:, k, 1] * mu < sigma)
        t = torch.where(active, t_new, t)
        status = torch.where(active & ~inside, DO.EXITED, torch.where(hit, DO.HIT, status)).to(torch.int32)
    return r2_max, lg_max


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k10_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import kernels as KN
    from repro_torch.kernels.delta_tracking import ops as DO

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    lib_path, cuobjdump, regs, shape_libs = _build()
    print(f"registers and spills: {regs}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F, U32, U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint32, ctypes.c_uint64
    track = [P] * 8 + [I, I, I, I, F]
    lib.rafi_track_parent.argtypes = track + [P]
    lib.rafi_track_variant.argtypes = [ctypes.c_int] + track + [I, P]
    lib.rafi_track_blocks.argtypes = track + [I, ctypes.c_int, P]
    lib.rafi_div_sweep.argtypes = [U32, F, F, P, P]
    lib.rafi_div_random.argtypes = [U64, I, F, F, F, F, F, F, P, P]
    lib.rafi_track_blocks_per_sm.argtypes = [ctypes.c_int]

    dev = torch.device("cuda", 0)
    steps = 8
    args, maj = chip_smoke.k10_inputs(dev, torch.Generator(device=dev).manual_seed(1234), 1024, steps)
    n, g = args[0].shape[0], args[5].shape[0]

    def run(entry, *extra, a=args):
        t = torch.empty(a[0].shape[0], dtype=torch.float32, device=dev)
        s = torch.empty(a[0].shape[0], dtype=torch.int32, device=dev)
        KN.check_launch(entry(*extra, *(x.data_ptr() for x in a), t.data_ptr(), s.data_ptr(),
                              a[0].shape[0], a[4].shape[1], steps, a[5].shape[0],
                              float(torch.tensor(maj, dtype=torch.float32)), KN.stream_handle()),
                        "k10 variant")
        return t, s

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = {name: lib.rafi_track_blocks_per_sm(w) for w, name in enumerate(("shipped", "refill", "refill_next"))}
    variant = lambda which, blocks=0: lambda *x: lib.rafi_track_variant(which, *x[:-1], blocks, x[-1])
    shipped_at = lambda blocks, unrolled=1: lambda *x: lib.rafi_track_blocks(*x[:-1], blocks, unrolled, x[-1])
    designs = {
        "parent": lambda: run(lib.rafi_track_parent),
        "shipped": lambda: DO.track(*args, majorant=maj, steps=steps),
        "at_use": lambda: run(variant(0)),
        "refill": lambda: run(variant(1)),
        "refill_next": lambda: run(variant(2)),
        "refill_next 2/SM": lambda: run(variant(2, 2 * sms)),
        "resident": lambda: run(shipped_at(resident["shipped"] * sms)),
        "loop": lambda: run(shipped_at(0, 0)),
    }
    for (threads, blocks), path in shape_libs.items():
        shape_lib = ctypes.CDLL(str(path))
        shape_lib.rafi_track.argtypes = track + [P]
        designs[f"{threads} threads, {blocks} blocks/SM"] = lambda f=shape_lib.rafi_track: run(f)
    ok = True
    same = lambda x, y: torch.equal(x[0].view(torch.int32), y[0].view(torch.int32)) and torch.equal(x[1], y[1])
    want = designs["shipped"]()
    for name, fn in designs.items():
        eq = same(fn(), want)
        ok &= eq
        print(f"  {name}: t and status bit-equal to the shipped kernel: {eq}", flush=True)
    pt, ps = DO.track_plain(*args, majorant=maj, steps=steps)
    tie, taken = chip_smoke._woodcock_near_tie(*args, maj, steps)
    differ = want[1] != ps
    plain_ok = (not bool((differ & ~tie).any()) and int(differ.sum()) < 1e-4 * n
                and not bool((~torch.isclose(want[0], pt, rtol=1e-6, atol=0.0) & ~tie).any()))
    ok &= plain_ok
    print(f"  shipped against plain (t rtol 1e-6, statuses but near-ties, < 0.01%): {plain_ok}; "
          f"{int(differ.sum())} differ, {int(tie.sum())} near-ties", flush=True)
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    lane_inv = all(same(DO.track(*(x[k:] for x in args[:5]), args[5], majorant=maj, steps=steps),
                        (want[0][k:], want[1][k:])) for k in range(4))
    pa = tuple(x[perm] for x in args[:5]) + (args[5],)
    lane_inv &= same(DO.track(*pa, majorant=maj, steps=steps), (want[0][perm], want[1][perm]))
    ok &= lane_inv
    print(f"  shipped bit-equal to itself on args[k:] (k = 0..3) and on a permutation: {lane_inv}", flush=True)

    # the divisions: every float of the ranges at the scene's divisors, and random pairs
    r2_max, lg_max = _walk_ranges(*args, maj, steps)
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    x_hi_bits = struct.unpack("<I", struct.pack("<f", 64.0))[0]
    maj32 = float(torch.tensor(maj, dtype=torch.float32))
    for s in args[5][:, 3].tolist():
        KN.check_launch(lib.rafi_div_sweep(x_hi_bits, maj32, s, bad.data_ptr(), KN.stream_handle()), "sweep")
    sweep = bad.tolist()
    bad.zero_()
    KN.check_launch(lib.rafi_div_random(1, 2**26, 64.0, 30.0, 1.0, 64.0, 0.05, 0.15, bad.data_ptr(),
                                        KN.stream_handle()), "random")
    rand_scene = bad.tolist()
    bad.zero_()
    KN.check_launch(lib.rafi_div_random(2, 2**26, 2.0**70, 150.0, 2.0**-70, 2.0**70, 1e-3, 1e3,
                                        bad.data_ptr(), KN.stream_handle()), "random")
    rand_wide = bad.tolist()
    div_ok = r2_max <= 64.0 and lg_max <= 64.0 and sweep == [0, 0] and rand_scene == [0, 0] and rand_wide == [0, 0]
    ok &= div_ok
    print(f"  divisions against __fdiv_rn, mismatches (a / μ̄, blob term): every float x in [0, 64] at "
          f"μ̄ = {maj32!r} and the scene's {g} blob sizes {sweep} ({g} x {x_hi_bits + 1} values); "
          f"2^26 random pairs over the scene's ranges {rand_scene}, over [2^-80, 2^70] {rand_wide}; "
          f"the rays meet r² <= {r2_max:.4f} and |log1p(-u0)| <= {lg_max:.4f}", flush=True)

    # steps taken, the bound, lane efficiency, SASS
    total = int(taken.sum())
    nbytes, ops = chip_smoke.k10_work(taken, args[5])
    bound = chip_smoke.bound_ms(nbytes, ops)[0]
    hist = torch.bincount(taken, minlength=steps + 1).tolist()
    eff_one = lane_efficiency_one_a_ray(taken)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    sass = _sass_step_loops(lib_path, cuobjdump, g, ROOT / "chiprun_out" / "k10_sass.txt")
    print(f"  steps taken over 0..{steps} {hist}, mean {total / n:.4f}; bytes {nbytes} ({nbytes / n:.2f} a ray) "
          f"-> bound {bound:.4f} ms; lane efficiency, one thread a ray: {eff_one:.4f}", flush=True)
    eff = {name: lane_efficiency_refill(taken, sms * b * 8) for name, b in
           (("refill", resident["refill"]), ("refill_next", resident["refill_next"]), ("refill_next 2/SM", 2))}
    print(f"  resident blocks an SM {resident}; lane efficiency of the refill: {eff}", flush=True)
    for fn, v in sorted(sass.items()):
        lane = eff.get(fn.split(" G=")[0], eff_one)
        v["issue_ms"] = v["per_step_estimate"] * total / (SM_ISSUE_LANES_PER_S * lane) * 1e3
        v["lane_efficiency"] = lane
        print(f"  SASS {fn}: step loop {v['static_step_loop']} static instructions ({v['inner_loops']} inner "
              f"loops; about {v['per_step_estimate']:.0f} a step at G = {g}) -> issue {v['issue_ms']:.4f} ms "
              f"over {total} steps at lane efficiency {lane:.3f}, 1.98 GHz; bytes bound {bound:.4f} ms; "
              f"opcodes {v['opcodes']}", flush=True)

    times = {}
    for name in ("parent", "shipped", "shipped", "parent"):
        times.setdefault(name, []).append(chip_smoke.device_ms(designs[name])[0])
    others = [k for k in designs if k not in ("parent", "shipped")]
    for name in others + others[::-1]:
        times.setdefault(name, []).append(chip_smoke.device_ms(designs[name])[0])
    for name, v in times.items():
        print(f"  {name}: device ms {v} -> {100 * bound / min(v):.1f}% of the bound", flush=True)
    clock = sm_clock(designs["shipped"])
    print(f"  while the shipped kernel runs back to back: SM clock median {clock[0]:.0f} MHz "
          f"(min {clock[1]:.0f}, max {clock[2]:.0f}), board power median {clock[3]:.1f} W", flush=True)
    out = {"card": smi, "ok": ok, "rays": n, "blobs": g, "steps": steps, "steps_histogram": hist,
           "mean_steps": total / n, "bytes": nbytes, "bound_ms": bound, "device_ms": times,
           "registers": regs, "sass": sass, "lane_efficiency": {"one_a_ray": eff_one, "refill": eff},
           "resident_blocks_per_sm": resident, "sm_clock_mhz_min_max_and_watts": clock,
           "divisions": {"sweep": sweep, "random_scene": rand_scene, "random_wide": rand_wide,
                         "r2_max": r2_max, "log1p_max": lg_max}}
    (ROOT / "chiprun_out" / "k10_variants.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
