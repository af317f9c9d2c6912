"""repro_torch.roofline — the plain roofline models, the call recorder's
wire reading and a step's roofline terms
(:mod:`repro_torch.roofline.analysis`), the dry run's tables
(:mod:`repro_torch.roofline.report`) and its inspector
(:mod:`repro_torch.roofline.inspect`)."""
from repro_torch.roofline import analysis

__all__ = ["analysis"]
