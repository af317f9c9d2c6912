"""qwen2-7b — dense GQA decoder with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", kind="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    pattern=("global",), source="arXiv:2407.10671; hf", fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke", kind="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, qkv_bias=True, rope_theta=1e6,
    pattern=("global",), dtype="float32", remat=False,
)
