"""gemma3-1b — dense, 5:1 local:global attention, 128k-capable
[hf:google/gemma-3-1b-pt; unverified]. Local window 512, global layers use
the 1e6 RoPE base, local layers 1e4 (see models.transformer._theta_for).
long_500k is SKIPPED: the global layers are full attention (not
sub-quadratic) — DESIGN.md §Arch-applicability."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", kind="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144, rope_theta=1e6, window=512,
    pattern=("local", "local", "local", "local", "local", "global"),
    tie_embeddings=True, scale_embed=True, act="gelu",
    source="hf:google/gemma-3-1b-pt",
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", kind="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, rope_theta=1e6, window=8,
    pattern=("local", "local", "local", "local", "local", "global"),
    tie_embeddings=True, scale_embed=True, act="gelu",
    dtype="float32", remat=False,
)
