"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].
The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings alongside text tokens; the backbone consumes
embeddings directly (frontend="vision")."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", kind="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    rope_kind="mrope", frontend="vision", fsdp=True, microbatches=4,
    pattern=("global",), source="arXiv:2409.12191",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", kind="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, qkv_bias=True, rope_kind="mrope",
    frontend="vision", pattern=("global",), dtype="float32", remat=False,
)
