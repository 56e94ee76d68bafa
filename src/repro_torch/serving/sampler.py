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
(1, V) Gumbel draw.

Speculative verify (``verify_slots``): the (B, L, V) grid goes through the
same per-row pipeline as B·L rows (``SlotSamplers.tile``), so each
solve runs once for every draft depth of every slot.  Greedy slots
accept the leading run of ``draft == argmax``; sampled slots accept by
rejection sampling on their own noise: per live sampled slot one (L-1)
coin draw and one (1, L, V) uniform draw from its generator, in slot
order (``draw_verify_uniforms``).  The JAX package draws threefry bits
instead, so sampled speculative streams are the port's own: deterministic
per seed and distributed as the target, not equal to JAX's.
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
    return gumbel_from_uniform(u)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)), u clamped to the least normal float32.  A CUDA graph
    cannot draw from a generator that changes between replays, so the
    graphed decode paths draw ``u`` before each replay (``torch.rand``
    into a static buffer, the same draw ``gumbel_noise`` makes) and
    transform it inside the graph, elementwise, on a tensor of the same
    shape: the same noise, bit for bit."""
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

    def tile(self, reps: int) -> "SlotSamplers":
        """Repeat every knob ``reps`` times along the batch axis: row
        b*reps+r carries slot b's knobs, the layout of a flattened
        (B, reps, V) verify grid."""
        return SlotSamplers(*(f.repeat_interleave(reps, dim=0)
                              for f in self))


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


def draw_slot_uniforms(out: torch.Tensor,
                       generators: Sequence[torch.Generator | None]) -> None:
    """Row b of ``out`` (B, V) gets ``generators[b]``'s (1, V) uniform
    draw, the one ``sample_slots`` makes for that slot; rows whose
    generator is None are left as they are."""
    for b, gen in enumerate(generators):
        if gen is not None:
            torch.rand((1, out.shape[-1]), generator=gen, out=out[b:b + 1])


def slot_noise(u: torch.Tensor) -> torch.Tensor:
    """The (B, V) Gumbel noise of ``draw_slot_uniforms``'s rows, row by
    row as ``sample_slots`` transforms each slot's (1, V) draw.  Rows left
    undrawn give finite noise that nothing reads: they are idle slots,
    whose tokens are dead, or greedy ones, which take the argmax."""
    return torch.cat([gumbel_from_uniform(u[b:b + 1])
                      for b in range(u.shape[0])])


def draw_verify_uniforms(coins: torch.Tensor, uniforms: torch.Tensor,
                         generators: Sequence[torch.Generator | None]
                         ) -> None:
    """Row b of ``coins`` (B, L-1) and ``uniforms`` (B, L, V) gets
    ``generators[b]``'s draws for one verify step, the coins first: the
    draws ``verify_slots`` makes for that slot.  Rows whose generator is
    None are left as they are."""
    for b, gen in enumerate(generators):
        if gen is None:
            continue
        if coins.shape[1]:
            torch.rand(coins.shape[1:], generator=gen, out=coins[b])
        torch.rand((1,) + uniforms.shape[1:], generator=gen,
                   out=uniforms[b:b + 1])


def verify_slots(
    grid: torch.Tensor,                     # (B, L, V) f32 verify logits
    draft: torch.Tensor,                    # (B, L-1) drafted tokens
    generators: Sequence[torch.Generator | None],
    slots: SlotSamplers,
    *,
    spec_k: int = 5,
    rounds: int = 8,
    backend: str = "torch",
    enable: tuple[bool, bool, bool] = (True, True, True),
    top_k_static: int | None = None,
    greedy_only: bool = False,
    coins: torch.Tensor | None = None,
    uniforms: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept or reject a drafted run per slot: the paper's sign check at
    the sequence level.

    ``grid[:, l]`` scores the token at position pos+l+1 given the fed
    prefix [t_0, d_1..d_l]; ``draft[:, l]`` is d_{l+1}.  The whole grid
    goes through one ``_masked_slot_logits`` as B·L rows.  Per row:

      * greedy slots accept d_{l+1} while it equals argmax(grid[:, l]):
        the accepted prefix plus the first correction are the serial
        greedy stream;
      * sampled slots accept d with probability p(d) (the masked softmax;
        a drafter is a point mass, so min(1, p/q) = p(d)), compared with
        the slot's coin; on rejection the replacement is drawn from p
        with d removed, and on full acceptance a bonus token from the
        last row, each a Gumbel-max draw on the slot's (L, V) uniforms.

    ``generators[b]`` is slot b's generator (None: greedy or idle), from
    which ``draw_verify_uniforms`` draws when ``coins`` (B, L-1) and
    ``uniforms`` (B, L, V) are not given; the scheduler's graphs read
    buffers it filled before the replay.  ``greedy_only``: no draw and no
    rejection arm.  Returns (out (B, L), n_acc (B,)): row b emits
    ``out[b, :n_acc[b] + 1]``.
    """
    B, L, V = grid.shape
    zm = _masked_slot_logits(
        grid.reshape(B * L, V), slots.tile(L), spec_k=spec_k, rounds=rounds,
        backend=backend, enable=enable,
        top_k_static=top_k_static).reshape(B, L, V)
    g = torch.argmax(zm, dim=-1)                             # (B, L)
    match_g = draft == g[:, :L - 1]                          # (B, L-1)
    if greedy_only:
        return g, torch.cumprod(match_g.long(), dim=1).sum(dim=1)

    if coins is None:
        coins = grid.new_zeros((B, L - 1))
        uniforms = grid.new_zeros((B, L, V))
        draw_verify_uniforms(coins, uniforms, generators)
    p = torch.softmax(zm, dim=-1)
    q_d = p[:, :L - 1].gather(-1, draft[..., None].long())[..., 0]
    match_s = coins < q_d
    # residual: p with the draft removed (the Gumbel-max draw renormalises
    # it); depth L-1 has no draft and draws from the full row
    hit = (torch.arange(V, device=grid.device)[None, None, :]
           == torch.nn.functional.pad(draft, (0, 1), value=-1)[..., None])
    z_res = torch.where(hit, NEG_INF, zm)
    s = torch.argmax(z_res + gumbel_from_uniform(uniforms), dim=-1)

    greedy = slots.greedy[:, None]
    match = torch.where(greedy, match_g, match_s)
    n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)    # (B,)
    cols = torch.arange(L, device=grid.device)[None, :]
    draft_pad = torch.nn.functional.pad(draft, (0, 1))
    out_s = torch.where(cols < n_acc[:, None], draft_pad, s)
    return torch.where(greedy, g, out_s), n_acc
