"""Serving: the runahead sampler, one-shot generation, and continuous
serving over a dense or paged KV cache with fused horizons and
speculative decoding (port of ``repro.serving``).  Importing it builds
no kernel: the kernel libraries load at their first launch."""
from repro_torch.serving.sampler import (
    SamplerConfig,
    SlotSamplers,
    sample,
    sample_slots,
    verify_slots,
)
from repro_torch.serving.draft import DraftSource, NGramDrafter
from repro_torch.serving.engine import generate
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Completion, Request, RunaheadServer

__all__ = [
    "SamplerConfig",
    "SlotSamplers",
    "sample",
    "sample_slots",
    "verify_slots",
    "DraftSource",
    "NGramDrafter",
    "generate",
    "ContinuousScheduler",
    "Request",
    "Completion",
    "RunaheadServer",
]
