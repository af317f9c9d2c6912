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
the plain version, CUDA tensors launch the kernel or raise; meta tensors
(a shape-only run) trace the plain version.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "check_launch", "kernel_wrappers", "launch_counts", "lookback_status",
    "reset_launch_counts", "stream_handle", "use_plain",
]

LOOKBACK_EPOCHS = 2**30 - 1  # epochs 1 .. 2^30 - 1 fit beside the flag in a status word
# per CUDA device: [status words (int64 scratch), the last call's epoch];
# calls on one device are ordered by its current stream
_LOOKBACK: Dict[int, list] = {}


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when every tensor lies on a CUDA device (launch the kernel).

    Every tensor on ``meta`` is also plain: a meta tensor has a shape and a
    dtype but no data, so there is nothing a kernel could be launched on,
    and a shape-only run (``launch.dryrun``) can only trace the plain
    version.  Anything else (mixed devices included) raises: there is no
    other path and no fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
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


def lookback_status(device: torch.device, words: int) -> Tuple[torch.Tensor, int]:
    """The device's look-back status words (at least ``words``) and a new
    epoch for this call: the scratch of ``csrc/lookback.cuh``, shared by K4
    and K6.  A new scratch starts at epoch 1, which the kernels' entry
    points clear first; so does every 2^30 - 1-th call."""
    ent = _LOOKBACK.get(device.index)
    if ent is None or ent[0].numel() < words:
        ent = [torch.empty(max(words, 1024), dtype=torch.int64, device=device), 0]
        _LOOKBACK[device.index] = ent
    ent[1] = ent[1] % LOOKBACK_EPOCHS + 1
    return ent[0], ent[1]


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
