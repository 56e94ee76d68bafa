"""Public wrappers of the hand-written kernels, with fixed geometry.

A wrapper takes the kernel's plain PyTorch version for tensors on the CPU
and launches the CUDA kernel for tensors on a CUDA device; anything else
raises.  There is no fallback: a CUDA tensor that the kernel cannot take
raises in the launcher.  ``LAUNCHES`` counts each wrapper's kernel
launches (plain integers, one per wrapper call that launched), so a run
can show that it went through the kernels; ``reset_launches`` zeroes them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import blocks
from repro_torch.kernels import flash_fwd as _ff
from repro_torch.kernels import multi_count as _mc
from repro_torch.kernels import multi_entropy as _me
from repro_torch.kernels import multi_mass as _mm
from repro_torch.kernels import paged_attend as _pa
from repro_torch.kernels import runahead_threshold as _rt
from repro_torch.kernels import taylor_eval as _te

LAUNCHES: dict[str, int] = {
    "taylor_sincos_eval": 0,
    "multi_count": 0,
    "runahead_topk_threshold": 0,
    "multi_mass": 0,
    "multi_entropy_moments": 0,
    "paged_attend": 0,
    "flash_fwd": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU operands, False for CUDA ones; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def multi_count(logits: torch.Tensor, taus: torch.Tensor,
                below: bool = False) -> torch.Tensor:
    """counts[b, m] = #{v : logits[b, v] > taus[b, m]} (f32); with
    ``below``, #{v : logits[b, v] < taus[b, m]}."""
    if _on_cpu(logits, taus):
        return _mc.multi_count_plain(logits, taus, below)
    out = _mc.multi_count_cuda(logits, taus, below)
    LAUNCHES["multi_count"] += 1
    return out


def multi_mass(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[b, m] = sum of probs[b, v] where probs[b, v] >= taus[b, m]."""
    if _on_cpu(probs, taus):
        return _mm.multi_mass_plain(probs, taus)
    out = _mm.multi_mass_cuda(probs, taus)
    LAUNCHES["multi_mass"] += 1
    return out


def multi_entropy_moments(z_shifted: torch.Tensor, ts: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, w) accumulator pair for logits already shifted to max 0."""
    if _on_cpu(z_shifted, ts):
        return _me.multi_entropy_moments_plain(z_shifted, ts)
    out = _me.multi_entropy_moments_cuda(z_shifted, ts)
    LAUNCHES["multi_entropy_moments"] += 1
    return out


def multi_entropy(logits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """H[b, m] = entropy of softmax(logits[b] / ts[b, m])."""
    z = logits.float()
    z = z - z.amax(dim=-1, keepdim=True)
    s, w = multi_entropy_moments(z, ts)
    return _me.entropy_from_moments(s, w)


def runahead_topk_threshold(logits: torch.Tensor, *, k_target: int,
                            rounds: int = 8, spec_k: int = 5
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-round runahead top-k bracket, one launch per call."""
    if _on_cpu(logits):
        return _rt.runahead_topk_threshold_plain(
            logits, k_target=k_target, rounds=rounds, spec_k=spec_k)
    out = _rt.runahead_topk_threshold_cuda(
        logits, k_target=k_target, rounds=rounds, spec_k=spec_k)
    LAUNCHES["runahead_topk_threshold"] += 1
    return out


def taylor_sincos_eval(x: torch.Tensor, *, terms: int) -> torch.Tensor:
    """sin(cos(x)) by ``terms``-term Taylor series at every point of a
    (M,) vector, in float32: the paper's f, one launch per call."""
    if _on_cpu(x):
        return _te.taylor_sincos_plain(x, terms=terms)
    out = _te.taylor_sincos_cuda(x, terms=terms)
    LAUNCHES["taylor_sincos_eval"] += 1
    return out


def paged_attend(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 table: torch.Tensor, pos: torch.Tensor, q: torch.Tensor, *,
                 context: int) -> torch.Tensor:
    """Paged decode/verify attention, (B, L, n_heads, hd) in q's dtype."""
    if _on_cpu(pool_k, pool_v, table, pos, q):
        return _pa.paged_attend_plain(pool_k, pool_v, table, pos, q,
                                      context=context)
    out = _pa.paged_attend_cuda(pool_k, pool_v, table, pos, q,
                                context=context)
    LAUNCHES["paged_attend"] += 1
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, n_rep: int = 1) -> torch.Tensor:
    """Causal flash attention, (B, S, H, D) in q's dtype; k, v carry
    H // n_rep heads.  Differentiable: the backward is the chunked
    ``flash_attend``'s vjp at the JAX wrapper's fixed geometry, q chunk
    ``divisor_chunk(S, Q_CHUNK)`` and kv chunk ``divisor_chunk(S,
    KV_CHUNK)`` (the plain version's tiles too)."""
    on_cpu = _on_cpu(q, k, v)
    S = q.shape[1]
    out = _ff.FlashFwd.apply(q, k, v, window, n_rep,
                             blocks.divisor_chunk(S, blocks.Q_CHUNK),
                             blocks.divisor_chunk(S, blocks.KV_CHUNK))
    if not on_cpu:
        LAUNCHES["flash_fwd"] += 1
    return out
