#!/usr/bin/env python3
"""Where K4 ``rank_and_histogram``'s time goes, on one NVIDIA card.

    python3 tools/k4_phases.py

Builds four variants of the port's ``csrc/bucket_scatter.cu`` (patched
copies under ``build/k4_phases/``, the port's ``nvcc`` flags, all started
together) and times each by device time (``chip_smoke.device_ms``) at the
Fig-8 shape (8, 262,144) and at VoPaT's (8, 1,048,576), in turns (the list,
then the list reversed):

  - ``shipped``: the kernel as the port builds it (checked bit-equal to the
    plain version);
  - ``no_bulk_copy``: the tile staged in shared memory by 4-byte loads
    instead of one bulk copy (bit-equal too);
  - ``no_lookback``: every tile's prefix taken as 0 (wrong ranks past the
    first tile): what the look-back costs;
  - ``stamps``: the shipped kernel with thread 0 of each block reading
    ``%globaltimer`` at its start and ``clock64`` at the phase boundaries,
    which are printed as mean, median and largest cycles a block: the copy's
    issue, the wait for it, the 32 steps, the scan and publish, the
    look-back, and the rank stores.

Writes ``chiprun_out/k4_phases.json``.  Exits non-zero without a card or
when a variant that should be bit-equal is not.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {"shipped": [], "no_bulk_copy": ["-DNO_BULK_COPY"], "no_lookback": ["-DNO_LOOKBACK"],
            "stamps": ["-DSTAMPS"]}
PHASES = ["copy issued", "copy waited", "32 steps", "scan + publish", "look-back", "rank stores"]


def _patched_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/bucket_scatter.cu").read_text()

    def rep(old, new):
        nonlocal src
        if old not in src:
            raise RuntimeError(f"csrc/bucket_scatter.cu changed; update the patch for: {old[:60]!r}")
        src = src.replace(old, new, 1)

    rep('#include "lookback.cuh"', '''#include "''' + str(ROOT / "src/repro_torch/kernels/csrc/lookback.cuh") + '''"
#ifdef STAMPS
__device__ unsigned long long g_stamps[1 << 17];
#define STAMP(k) if (threadIdx.x == 0) g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + (k)] = \\
    (k) == 0 ? globaltimer() : clock64();
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define STAMP(k)
#endif
extern "C" int k4_stamps(void* out, long long words) {
#ifdef STAMPS
  return (int)cudaMemcpyFromSymbol(out, g_stamps, words * 8);
#else
  return 0;
#endif
}''')
    rep("  __shared__ alignas(8) unsigned long long bar;", "  __shared__ alignas(8) unsigned long long bar;\n  STAMP(0) STAMP(1)")
    rep("  __syncthreads();  // counts zeroed", "  STAMP(2)\n  __syncthreads();  // counts zeroed")
    rep("  // 2. step k of warp w", "  STAMP(3)\n  // 2. step k of warp w")
    rep("  __syncthreads();\n\n  // 3. per bucket", "  __syncthreads();\n  STAMP(4)\n\n  // 3. per bucket")
    rep("  __syncthreads();\n\n  // 4. per bucket", "  __syncthreads();\n  STAMP(5)\n\n  // 4. per bucket")
    rep("    const int prefix = lookback::exclusive_prefix(",
        "#ifdef NO_LOOKBACK\n    const int prefix = 0;\n#else\n    const int prefix = lookback::exclusive_prefix(")
    rep("agg, epoch, lane);\n", "agg, epoch, lane);\n#endif\n")
    rep("  __syncthreads();\n\n  // 5. rank", "  __syncthreads();\n  STAMP(6)\n\n  // 5. rank")
    rep("    if (i < n) r_row[i] = tile[d] + wcount[d] + (v & 1023);\n  }\n",
        "    if (i < n) r_row[i] = tile[d] + wcount[d] + (v & 1023);\n  }\n  STAMP(7)\n")
    rep("(uintptr_t)dest % 16 == 0 && cap % 4 == 0);",
        "\n#ifdef NO_BULK_COPY\n      false);\n#else\n      (uintptr_t)dest % 16 == 0 && cap % 4 == 0);\n#endif")
    return src


def _build():
    from repro_torch import compat
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k4.cu").write_text(_patched_source())
    procs = {v: subprocess.Popen([compat.nvcc_path(), *build.NVCC_FLAGS, *flags, "-shared", "-o",
                                  str(out / f"{v}.so"), str(out / "k4.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, flags in VARIANTS.items()}
    libs = {}
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{v}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int64
        lib.rafi_rank_and_histogram.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        lib.k4_stamps.argtypes = [P, ctypes.c_longlong]
        libs[v] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import kernels as KN
    from repro_torch.kernels.bucket_scatter import ops as BS

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    libs = _build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    out, ok = {"card": smi, "shapes": {}}, True
    for rows, cap in ((8, 262144), (8, 1048576)):
        dest = chip_smoke._fig8_dest(gen, rows, cap, dev)
        count = torch.full((rows,), cap, dtype=torch.int32, device=dev)
        count[1::3] = cap // 3
        want = BS.rank_and_histogram_plain(dest, count, num_ranks=rows)
        got = (torch.empty_like(dest), torch.empty_like(dest),
               torch.empty(rows, rows + 1, dtype=torch.int32, device=dev))

        def call(lib):
            status, epoch = KN.lookback_status(dev, rows * (rows + 1) * (cap // 1024))
            rc = lib.rafi_rank_and_histogram(dest.data_ptr(), count.data_ptr(), *(g.data_ptr() for g in got),
                                             status.data_ptr(), status.numel(), rows, cap, rows, epoch,
                                             KN.stream_handle())
            KN.check_launch(rc, "rank_and_histogram")

        times = {v: [] for v in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for v in order:
                call(libs[v])
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                if v in ("shipped", "no_bulk_copy", "stamps") and not same:
                    ok = False
                    print(f"  {v} at {(rows, cap)}: NOT bit-equal to the plain version", flush=True)
                times[v].append(chip_smoke.device_ms(lambda: call(libs[v]))[0])
        blocks = rows * (cap // 8192)
        buf = torch.zeros(blocks * 8, dtype=torch.int64)
        KN.check_launch(libs["stamps"].k4_stamps(buf.data_ptr(), blocks * 8), "k4_stamps")
        st = buf.numpy().reshape(blocks, 8).astype(np.float64)
        cycles = np.diff(st[:, 1:], axis=1)
        start_us = (st[:, 0] - st[:, 0].min()) / 1e3
        phases = {name: {"mean": float(cycles[:, k].mean()), "median": float(np.median(cycles[:, k])),
                         "max": float(cycles[:, k].max())} for k, name in enumerate(PHASES)}
        out["shapes"][str((rows, cap))] = {"device_ms": times, "phase_cycles": phases,
                                           "block_start_us_max": float(start_us.max())}
        print(f"({rows}, {cap}): device ms " + ", ".join(f"{v} {t}" for v, t in times.items()), flush=True)
        for name, c in phases.items():
            print(f"  {name:15s} cycles a block: mean {c['mean']:.0f}, median {c['median']:.0f}, "
                  f"largest {c['max']:.0f}", flush=True)
        print(f"  last block started {start_us.max():.2f} us after the first", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k4_phases.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
