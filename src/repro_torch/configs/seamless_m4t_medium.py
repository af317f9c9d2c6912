"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596; hf].
Audio frontend is a STUB: the encoder consumes precomputed frame embeddings
(B, T, D) from input_specs().  12L encoder + 12L decoder."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", kind="encdec",
    num_layers=12, encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206, rope_theta=1e4, frontend="audio",
    pattern=("global",), source="arXiv:2308.11596", dp_over_model=True,
)

SMOKE = ModelConfig(
    name="seamless-smoke", kind="encdec",
    num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, frontend="audio",
    pattern=("global",), dtype="float32", remat=False,
)
