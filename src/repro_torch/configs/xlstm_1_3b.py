"""xlstm-1.3b — sLSTM + mLSTM residual stack, 7:1 ratio (every 8th block
sLSTM); d_ff=0: the projection lives inside the mixer blocks
[arXiv:2405.04517; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_head=512,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
    act="swiglu",
    norm="rmsnorm",
    source="arXiv:2405.04517; unverified",
)
