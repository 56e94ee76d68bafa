"""AdamW with f32 master weights, LR schedules and gradient clipping
(port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, clip_by_quantile
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup_cosine",
    "clip_by_global_norm",
    "clip_by_quantile",
]
