"""rwkv6-3b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892; hf].  Runs long_500k (O(1)-state decode)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", kind="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=0, head_dim=64,
    d_ff=8960, vocab_size=65536,
    pattern=("rwkv",), source="arXiv:2404.05892",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", kind="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=0, head_dim=16,
    d_ff=128, vocab_size=256, pattern=("rwkv",), dtype="float32", remat=False,
)
