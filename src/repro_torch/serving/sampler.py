"""Token sampler built on runahead bisection (port of
``repro.serving.sampler``: the one-shot and the per-slot halves).

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
the same numbers).

Per-slot sampling (continuous batching): each slot carries its own knobs
(``SlotSamplers``, (B,) tensors routed into the engine's batch axis) and
its own generator.  Row b of ``sample_slots`` is the token a B=1
``sample`` with that slot's config and generator draws: the masked
logits are the same bits, and the slot's generator gives the same
(1, V) Gumbel draw.  ``verify_slots`` and ``SlotSamplers.tile`` wait for
the speculative slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

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


# ---------------------------------------------------------------------------
# per-slot sampling (continuous batching)
# ---------------------------------------------------------------------------

class SlotSamplers(NamedTuple):
    """Per-slot sampler parameters, one (B,) tensor per knob.

    ``target_entropy`` uses NaN for "off" (fall back to ``temperature``);
    ``top_k`` uses 0, ``top_p`` uses 0.0, the same sentinels as
    SamplerConfig.  ``spec_k`` / ``rounds`` / ``backend`` stay uniform
    across slots (they shape the solve).
    """

    temperature: torch.Tensor       # (B,) f32
    target_entropy: torch.Tensor    # (B,) f32, NaN = off
    top_k: torch.Tensor             # (B,) int64, 0 = off
    top_p: torch.Tensor             # (B,) f32, 0.0 = off
    greedy: torch.Tensor            # (B,) bool, argmax instead of a draw

    @staticmethod
    def stack(configs: Sequence[SamplerConfig], device) -> "SlotSamplers":
        """Stack scalar configs into slot tensors on ``device`` (host-side,
        at admission: one host-to-device copy per knob)."""
        uniform = {(c.spec_k, c.rounds, c.backend) for c in configs}
        if len(uniform) > 1:
            raise ValueError(
                f"spec_k/rounds/backend must be uniform across slots, "
                f"got {sorted(uniform)}")
        nan = float("nan")

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=device)

        return SlotSamplers(
            temperature=col([c.temperature for c in configs], torch.float32),
            target_entropy=col([nan if c.target_entropy is None
                                else c.target_entropy for c in configs],
                               torch.float32),
            top_k=col([c.top_k for c in configs], torch.int64),
            top_p=col([c.top_p for c in configs], torch.float32),
            greedy=col([c.greedy for c in configs], torch.bool),
        )


def _masked_slot_logits(
    logits: torch.Tensor,              # (R, V) f32, R rows
    slots: SlotSamplers,               # (R,) per-row knobs
    *,
    spec_k: int,
    rounds: int,
    backend: str,
    enable: tuple[bool, bool, bool],
    top_k_static: int | None,
) -> torch.Tensor:
    """The per-row transform pipeline (entropy temperature / top-k /
    top-p).  ``enable`` = (entropy, top_k, top_p) gates each solve: one
    that no slot uses is skipped; per-row sentinels handle the mixed case
    inside an enabled solve (an off row's solve result is discarded by a
    ``where``, so its values pass through bit-unchanged)."""
    z = logits.float()
    z = torch.maximum(z, z.amax(dim=-1, keepdim=True) - 80.0)
    kw = dict(spec_k=spec_k, rounds=rounds, backend=backend)
    en_entropy, en_topk, en_topp = enable

    if en_entropy:
        has_target = ~torch.isnan(slots.target_entropy)
        # off rows solve a dummy target; their t is discarded by the where
        target = torch.where(has_target, slots.target_entropy, 1.0)
        t = entropy_temperature(z, target, **kw)
        denom = torch.where(has_target, t, slots.temperature)
    else:
        denom = slots.temperature
    z = z / denom[:, None]

    if en_topk and top_k_static is not None:
        z = torch.where(topk_mask(z, top_k_static, **kw), z, NEG_INF)
    elif en_topk:
        on = slots.top_k > 0
        k_eff = torch.where(on, slots.top_k, 1)
        mask = topk_mask(z, k_eff, **kw)
        z = torch.where(mask | ~on[:, None], z, NEG_INF)
    if en_topp:
        on = slots.top_p > 0.0
        p_eff = torch.where(on, slots.top_p, 0.5)
        probs = torch.softmax(z, dim=-1)
        mask = topp_mask(probs, p_eff, **kw)
        z = torch.where(mask | ~on[:, None], z, NEG_INF)
    return z


def sample_slots(
    logits: torch.Tensor,                   # (B, V) f32
    generators: Sequence[torch.Generator | None],
    slots: SlotSamplers,
    *,
    spec_k: int = 5,
    rounds: int = 8,
    backend: str = "torch",
    enable: tuple[bool, bool, bool] = (True, True, True),
    top_k_static: int | None = None,
    greedy_only: bool = False,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample next tokens (B,) int64, one independent stream per slot.

    ``generators[b]`` is slot b's own generator: a row whose generator is
    None (a greedy or idle slot) draws nothing and samples with zero
    noise; ``noise`` (B, V) replaces every draw (tests).  ``enable`` and
    ``top_k_static`` (every live slot shares one top_k > 0, which takes
    the static-k fast paths) and ``greedy_only`` (every live slot is
    greedy: no draw at all) come from the scheduler; the masked logits
    are the same bits either way.
    """
    z = _masked_slot_logits(logits, slots, spec_k=spec_k, rounds=rounds,
                            backend=backend, enable=enable,
                            top_k_static=top_k_static)
    g = torch.argmax(z, dim=-1)
    if greedy_only:
        return g
    if noise is None:
        V = z.shape[-1]
        noise = torch.cat([
            gumbel_noise((1, V), gen) if gen is not None
            else z.new_zeros((1, V)) for gen in generators])
    drawn = torch.argmax(z + noise, dim=-1)
    return torch.where(slots.greedy, g, drawn)
