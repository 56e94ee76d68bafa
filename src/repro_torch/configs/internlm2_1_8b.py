"""internlm2-1.8b — dense GQA decoder LM [arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297; hf",
)
