"""Batched generation engine: prefill once, decode with the runahead
sampler (port of ``repro.serving.engine``).  The decode loop is a Python
loop over ``decode_step``; the position is a host integer, so the loop
never reads a value back from the device until the caller does."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import decode_step, prefill
from repro_torch.serving.sampler import SamplerConfig, sample


def generate(
    cfg: ModelConfig,
    params,
    prompt: torch.Tensor,              # (B, S) integer
    n_new: int,
    generator: torch.Generator | None,
    *,
    context: int | None = None,
    sampler: SamplerConfig = SamplerConfig(),
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Returns generated tokens (B, n_new) int64.

    The first token comes from the prefill logits; each of the remaining
    ``n_new - 1`` comes from one decode step, so ``n_new`` tokens cost
    ``n_new - 1`` decode steps.
    """
    B, S = prompt.shape
    context = context or (S + n_new)
    logits, cache = prefill(cfg, params, prompt, context,
                            compute_dtype=compute_dtype)
    toks = [sample(logits, generator, sampler)]
    for pos in range(S, S + n_new - 1):
        logits, cache = decode_step(cfg, params, toks[-1], pos, cache,
                                    compute_dtype=compute_dtype)
        toks.append(sample(logits, generator, sampler))
    return torch.stack(toks, dim=1)[:, :n_new]
