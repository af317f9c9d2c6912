"""Optimizer of the training path (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.grad_compress import compress_gradients  # noqa: F401
