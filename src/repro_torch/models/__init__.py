"""Dense and MoE transformer forward, prefill and decode (port of
``repro.models``)."""
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig"]
