"""qwen2.5-14b — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-14B; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", kind="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    pattern=("global",), source="hf:Qwen/Qwen2.5-14B", fsdp=True, microbatches=2,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", kind="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, qkv_bias=True, rope_theta=1e6,
    pattern=("global",), dtype="float32", remat=False,
)
