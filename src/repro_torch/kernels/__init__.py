"""Hand-written Hopper kernels for the forwarding hot path and app cores.

Layout mirrors ``repro/kernels``: one subpackage per TPU kernel family, each
with an ``ops.py`` that holds the wrapper, the plain PyTorch version (the
counterpart of the JAX ``ref.py``) and the wrapper's launch counter.  The
CUDA C++ sources live in ``csrc/`` and are built by ``build.py``.

  sort_keys/       K3 pack_and_histogram (§4.2.1 key pack + histogram)
  bucket_scatter/  K4 rank_and_histogram (the sort-free plan: in-bucket
                   rank + histogram), K5 scatter_rows (the scatter
                   marshal's send pass)
  compact/         K6 compact_positions (the prefix sum behind enqueue)
  marshal/         K1 gather_rows (the sort marshal's send gather),
                   K2 unmarshal (receive compaction), K7 marshal (the
                   two-pass marshal's segment copy)
  rk4_advect/      K8 rk4_step (§5.4 RK4 particle advection)
  nbody_forces/    K9 pairwise_accel (§5.5 softened all-pairs gravity)
  delta_tracking/  K10 track (§5.1 Woodcock steps through Gaussian blobs;
                   no app calls it)

Dispatch is by the tensors' device and never falls back: CPU tensors run
the plain version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = [
    "check_launch", "kernel_wrappers", "launch_counts", "reset_launch_counts",
    "stream_handle", "use_plain",
]


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when every tensor lies on a CUDA device (launch the kernel).  Anything
    else raises: there is no third path and no fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(
        f"kernel inputs on {sorted(kinds)}: CPU tensors run the plain "
        "version, CUDA tensors the kernel; nothing else is supported"
    )


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def kernel_wrappers() -> Dict[str, object]:
    """The wrappers of all ten kernels, by kernel name."""
    from repro_torch.kernels.bucket_scatter import ops as bs_ops
    from repro_torch.kernels.compact import ops as compact_ops
    from repro_torch.kernels.delta_tracking import ops as dt_ops
    from repro_torch.kernels.marshal import ops as marshal_ops
    from repro_torch.kernels.nbody_forces import ops as nb_ops
    from repro_torch.kernels.rk4_advect import ops as rk4_ops
    from repro_torch.kernels.sort_keys import ops as sk_ops

    return {
        "gather_rows": marshal_ops.gather_rows,
        "unmarshal": marshal_ops.unmarshal,
        "pack_and_histogram": sk_ops.pack_and_histogram,
        "rank_and_histogram": bs_ops.rank_and_histogram,
        "scatter_rows": bs_ops.scatter_rows,
        "compact_positions": compact_ops.compact_positions,
        "marshal": marshal_ops.marshal,
        "rk4_step": rk4_ops.rk4_step,
        "pairwise_accel": nb_ops.pairwise_accel,
        "track": dt_ops.track,
    }


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per wrapper (plain-version calls not counted)."""
    return {k: w.launches for k, w in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
