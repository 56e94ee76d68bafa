"""qwen3-4b — dense GQA with qk-norm, head_dim 128 [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,            # qwen3 fixes head_dim=128 (q proj 2560 -> 4096)
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)
