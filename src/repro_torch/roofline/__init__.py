"""repro_torch.roofline — the plain roofline models and the call recorder's
wire reading (:mod:`repro_torch.roofline.analysis`)."""
from repro_torch.roofline import analysis

__all__ = ["analysis"]
