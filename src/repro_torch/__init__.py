"""RaFI on PyTorch — the work-forwarding infrastructure on an NVIDIA H100.

The port of ``repro`` (JAX on a TPU) to PyTorch and hand-written Hopper
kernels.  R logical ranks run in one process over rank-stacked tensors with
a leading axis R (see ``core.collectives``); every Pallas kernel on the
ported path has a CUDA C++ counterpart under ``kernels/csrc``.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
