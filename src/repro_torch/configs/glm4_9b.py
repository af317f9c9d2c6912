"""glm4-9b — dense GQA decoder, RoPE [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", kind="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552, qkv_bias=True, rope_theta=1e4,
    pattern=("global",), source="hf:THUDM/glm-4-9b", fsdp=True, microbatches=2,
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", kind="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, qkv_bias=True,
    pattern=("global",), dtype="float32", remat=False,
)
