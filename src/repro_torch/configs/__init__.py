"""Architecture configs (copies of ``repro.configs``), registered by name."""
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

__all__ = ["ARCHS", "get_config", "get_smoke_config"]
