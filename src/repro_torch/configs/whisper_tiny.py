"""whisper-tiny — enc-dec; conv frontend STUBBED (input_specs provides
precomputed frame embeddings, DESIGN.md §7) [arXiv:2212.04356; unverified].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                # decoder layers
    n_encoder_layers=4,
    encoder_len=1500,          # 30 s of audio at 50 Hz after conv stride
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    learned_pos=True,
    tie_embeddings=True,       # whisper ties decoder embed/unembed
    source="arXiv:2212.04356; unverified",
)
