"""qwen1.5-4b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,         # MHA (kv == q heads)
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
