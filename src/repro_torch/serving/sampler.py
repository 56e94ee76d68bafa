"""Token sampler built on runahead bisection (port of
``repro.serving.sampler``, one-shot half).

Every monotone solve in the sampling pipeline goes through the batched
engine instead of a vocab sort:

  top-k        count(logits > tau) = k
  top-p        mass(probs >= tau) = p
  temperature  H(softmax(z/T)) = H_target       (entropy-calibrated)

``SamplerConfig.backend`` selects the engine backend for all three solves:
``"torch"`` is the oracle; ``"hopper"`` routes every evaluation through
the hand-written CUDA kernels, and top-k through the fused multi-round
kernel.

The draw is Gumbel-max, ``argmax(z + g)``, the same rule as
``jax.random.categorical``; the noise ``g`` comes from the caller's
``torch.Generator`` (or from ``noise``, so a test can feed both packages
the same numbers).  Per-slot sampling for continuous batching is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.applications import entropy_temperature, topk_mask, topp_mask
from repro_torch.core.solver import true_div

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    target_entropy: float | None = None   # overrides temperature if set
    top_k: int = 0                        # 0 = off
    top_p: float = 0.0                    # 0 = off
    greedy: bool = False                  # argmax after the mask pipeline
    spec_k: int = 5                       # speculation depth (paper's k)
    rounds: int = 8
    backend: str = "torch"                # "torch" | "hopper": ALL solves


def masked_logits(logits: torch.Tensor, sc: SamplerConfig = SamplerConfig()
                  ) -> torch.Tensor:
    """The (B, V) f32 logits the draw samples from: clamped, tempered and
    masked (dropped entries hold NEG_INF)."""
    z = logits.float()
    # Clamp to a finite dynamic range: padded-vocab columns arrive as -1e30,
    # which would blow the bisection bracket to 1e30 wide.  exp(-80) is
    # numerically zero relative to the max in f32, so this is exact for
    # softmax and top-k purposes.
    z = torch.maximum(z, z.amax(dim=-1, keepdim=True) - 80.0)
    kw = dict(spec_k=sc.spec_k, rounds=sc.rounds, backend=sc.backend)
    if sc.target_entropy is not None:
        t = entropy_temperature(z, sc.target_entropy, **kw)
        z = z / t[:, None]
    elif sc.temperature != 1.0:
        z = true_div(z, sc.temperature)
    if sc.top_k > 0:
        z = torch.where(topk_mask(z, sc.top_k, **kw), z, NEG_INF)
    if sc.top_p > 0.0:
        probs = torch.softmax(z, dim=-1)
        z = torch.where(topp_mask(probs, sc.top_p, **kw), z, NEG_INF)
    return z


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)) on ``generator.device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(
    logits: torch.Tensor,                 # (B, V) f32
    generator: torch.Generator | None,
    sc: SamplerConfig = SamplerConfig(),
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample next tokens (B,) int64.  ``noise`` (B, V) replaces the
    generator's Gumbel draw; greedy configs need neither."""
    z = masked_logits(logits, sc)
    if sc.greedy:
        return torch.argmax(z, dim=-1)
    if noise is None:
        noise = gumbel_noise(z.shape, generator)
    return torch.argmax(z + noise, dim=-1)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
