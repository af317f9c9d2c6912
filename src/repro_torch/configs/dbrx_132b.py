"""dbrx-132b — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base; unverified].  top-4 ⇒ each token emits FOUR work
items into the forwarding plane (§3.3: "threads can emit more than one")."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", kind="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352, rope_theta=5e5,
    num_experts=16, top_k=4, moe_dispatch="rafi_ep",
    pattern=("moe",), source="hf:databricks/dbrx-base", fsdp=True, microbatches=4,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", kind="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, num_experts=4, top_k=2, moe_dispatch="rafi_ep",
    pattern=("moe",), dtype="float32", remat=False,
)
