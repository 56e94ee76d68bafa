"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer; 3
global-attention layers (first/middle/last), sliding-window elsewhere
[arXiv:2411.13676; hf].  Meta-tokens from the paper are not modelled
(DESIGN.md §8)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_conv=4,
    sliding_window=1024,
    global_layers=(0, 16, 31),
    act="swiglu",
    norm="rmsnorm",
    source="arXiv:2411.13676; hf",
)
