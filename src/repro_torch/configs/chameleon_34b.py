"""chameleon-34b — early-fusion VLM; VQ image tokens live in the 65536
vocab so the frontend stub is an ordinary embedding lookup
[arXiv:2405.09818; unverified].  Chameleon uses qk-norm for stability."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    source="arXiv:2405.09818; unverified",
)
