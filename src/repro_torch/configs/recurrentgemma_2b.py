"""recurrentgemma-2b — RG-LRU + local attention, 1 attention : 2 recurrent
[arXiv:2402.19427; hf].  Runs long_500k (bounded-window attention +
O(1)-state recurrence)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", kind="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, rope_theta=1e4, window=2048,
    pattern=("recurrent", "recurrent", "local"),
    tie_embeddings=True, scale_embed=True, act="gelu",
    source="arXiv:2402.19427",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", kind="hybrid",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, window=8,
    pattern=("recurrent", "recurrent", "local"),
    tie_embeddings=True, scale_embed=True, act="gelu",
    dtype="float32", remat=False,
)
