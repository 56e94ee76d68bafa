"""granite-moe-3b-a800m — 40 routed experts top-8, no shared experts
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  NOTE: the assignment line
says both "MoE 40e top-8" and "32 experts" — we implement the explicit
shape spec (40 experts, top-8) and record the discrepancy here.  Experts
pad 40 -> 48 for the model-axis shard."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                  # per-expert hidden
    vocab=49155,
    n_experts=40,
    n_shared_experts=0,
    moe_top_k=8,
    act="swiglu",
    norm="rmsnorm",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
