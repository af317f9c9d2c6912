#!/usr/bin/env python3
"""K8 ``rk4_step``'s two I/O designs side by side on one NVIDIA card.

    python3 tools/k8_io_variants.py

Builds ``tools/k8_direct_quad.cu`` (which includes the port's
``csrc/rk4_advect.cu``, so one library holds both entry points: the
shipped bulk-copy ``rafi_rk4_step`` and ``rafi_rk4_step_quad``, 4
particles a thread in 16-byte accesses straight from device memory) with
the port's ``nvcc`` flags and ``-Xptxas -v`` (registers and spills a
kernel, printed), then:

  - holds the 4-a-thread design bit for bit against the shipped one on all
    three fields, at a ragged N and on a view off a 16-byte boundary;
  - counts the SASS instructions of each kernel (``cuobjdump --dump-sass``
    of the built library): a static count, both I/O paths, four particles
    and each ``sincosf``'s slow path included, so an upper bound on the
    instructions a particle executes; printed beside the byte bound and the
    issue time of that count;
  - times both designs on the ABC field at the streamlines shape
    (1,048,576 particles) and at the smoke shape (2,097,152) by device time
    (``chip_smoke.device_ms``), in turns: shipped, quad, quad, shipped.

Prints one JSON line and writes it to ``chiprun_out/k8_io_variants.json``.
Exits non-zero without a card or when the two designs disagree.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SM_ISSUE_LANES_PER_S = 132 * 128 * 1.98e9  # H100 SXM: 4 schedulers x 32 lanes an SM, boost clock


def _build():
    from repro_torch import compat
    from repro_torch.kernels import build

    nvcc = compat.nvcc_path()
    out = build.BUILD_DIR / "k8_io_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out),
                          str(ROOT / "tools" / "k8_direct_quad.cu")], capture_output=True, text=True)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed (rc {res.returncode})")
    return out, pathlib.Path(nvcc).with_name("cuobjdump")


def _sass_counts(lib, cuobjdump):
    """Static SASS instructions of each rk4 kernel, by demangled-ish name."""
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        if name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] = counts.get(name, 0) + 1
    out = {}
    for fn, v in counts.items():
        m = re.search(r"rk4_(quad_)?kernelILi(\d)E", fn)
        if m:
            out[f"{'quad' if m.group(1) else 'shipped'} field {m.group(2)}"] = v
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k8_io_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import kernels as KN
    from repro_torch.kernels.rk4_advect import ops as RO

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    lib_path, cuobjdump = _build()
    lib = ctypes.CDLL(str(lib_path))
    P, F = ctypes.c_void_p, ctypes.c_float
    for fn in (lib.rafi_rk4_step, lib.rafi_rk4_step_quad):
        fn.argtypes = [P, P, P, ctypes.c_int64, ctypes.c_int, F, F, F, F, F, F, P]
        fn.restype = ctypes.c_int

    def run(fn, pos, field=RO.ABC, dt=0.1):
        new_pos, vel = torch.empty_like(pos), torch.empty_like(pos)
        h, dt6 = (float(torch.tensor(v, dtype=torch.float32)) for v in (0.5 * dt, dt / 6.0))
        KN.check_launch(fn(pos.data_ptr(), new_pos.data_ptr(), vel.data_ptr(), pos.shape[0], field,
                           h, dt, dt6, 1.0, 0.8, 0.6, KN.stream_handle()), "rk4")
        return new_pos, vel

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    big = torch.rand((2097152 + 7, 3), generator=gen, device=dev) * 6.283185307179586
    same = True
    for field in (RO.ABC, RO.TORNADO, RO.TAYLOR_GREEN):
        for pos in (big[:1048576 + 3], big[1:1048576 + 1]):  # ragged; a view 12 B off
            a = run(lib.rafi_rk4_step, pos, field)
            b = run(lib.rafi_rk4_step_quad, pos, field)
            same &= all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"4-a-thread design bit-equal to the shipped one on all three fields: {same}", flush=True)

    sass = _sass_counts(lib_path, cuobjdump)
    out = {"card": smi, "bit_equal": same, "sass_static_instructions": sass, "shapes": {}}
    for n in (1048576, 2097152):
        pos = big[:n].contiguous()
        times = {"shipped": [], "quad": []}
        for which in ("shipped", "quad", "quad", "shipped"):
            fn = lib.rafi_rk4_step if which == "shipped" else lib.rafi_rk4_step_quad
            times[which].append(chip_smoke.device_ms(lambda: run(fn, pos))[0])
        bound = chip_smoke.bound_ms(36 * n)[0]
        per_particle = sass["shipped field 0"] / 4
        issue_ms = per_particle * n / SM_ISSUE_LANES_PER_S * 1e3
        out["shapes"][n] = {"device_ms": times, "bytes_bound_ms": bound,
                            "static_sass_a_particle": per_particle, "issue_ms_at_that_count": issue_ms}
        print(f"N={n}: device ms shipped (bulk copy) {times['shipped']} 4 a thread {times['quad']}; bytes bound "
              f"{bound:.4f} ms; static SASS a particle (ABC) {per_particle:.0f} -> issue time "
              f"{issue_ms:.4f} ms at 1.98 GHz", flush=True)
    print(f"static SASS instructions a kernel: {sass}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k8_io_variants.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
