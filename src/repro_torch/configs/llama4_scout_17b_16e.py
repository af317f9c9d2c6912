"""llama4-scout-17b-16e — MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  All layers MoE
(simplification of the interleaved dense/MoE stack — DESIGN.md).  The MoE
dispatch plane is the paper's forwarding technique (rafi_ep)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e", kind="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, rope_theta=5e5,
    num_experts=16, top_k=1, moe_dispatch="rafi_ep",
    pattern=("moe",), source="hf:meta-llama/Llama-4-Scout-17B-16E", fsdp=True, microbatches=4,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", kind="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_experts=4, top_k=1, moe_dispatch="rafi_ep",
    pattern=("moe",), dtype="float32", remat=False,
)
