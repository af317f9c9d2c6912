"""Data for the training path (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator  # noqa: F401
