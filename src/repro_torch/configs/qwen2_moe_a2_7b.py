"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared-expert units
(shared hidden 4x1408 = 5632, matching Qwen1.5-MoE-A2.7B)
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  Experts pad 60 -> 64 for the model-axis
shard (DESIGN.md §5); padded experts are router-masked."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # per-expert hidden
    vocab=151936,
    n_experts=60,
    n_shared_experts=4,
    moe_top_k=4,
    qkv_bias=True,             # qwen1.5 lineage keeps QKV bias
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
