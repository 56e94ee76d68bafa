"""LM-stack monotone solves on the batched engine (port of
``repro.core.applications``).

Every solve is phrased as a root-find and routed through
``repro_torch.core.solver``: one ``multi_eval`` answers all
``(B, 2**spec_k - 1)`` candidates in one pass over the operand, and the
batch axis is native.  Backends: ``"torch"`` (the oracle, any device) and
``"hopper"`` (hand-written CUDA kernels on the card, their plain versions
on the CPU).

Every function accepts a single row ``(V,)`` or a batch ``(B, V)`` and
returns correspondingly unbatched / batched results.
"""
from __future__ import annotations

import torch

from repro_torch.core import solver

Tensor = torch.Tensor


def _rows(x: Tensor) -> tuple[Tensor, bool]:
    """Promote (V,) -> (1, V); report whether to squeeze results."""
    if x.ndim == 1:
        return x[None, :], True
    if x.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D operand, got shape {tuple(x.shape)}")
    return x, False


def _maybe_squeeze(out, squeeze: bool):
    if not squeeze:
        return out
    if isinstance(out, tuple):
        return tuple(o[0] for o in out)
    return out[0]


# ---------------------------------------------------------------------------
# top-k threshold
# ---------------------------------------------------------------------------

def topk_threshold(logits: Tensor, k, *, spec_k: int = 5, rounds: int = 8,
                   backend: str = "torch") -> tuple[Tensor, Tensor]:
    """Bracket the k-th largest logit per row: returns (lo, hi) with
    count(row > lo) >= k > count(row > hi).  ``k`` is an int or a (B,)
    tensor."""
    z, squeeze = _rows(logits)
    out = solver.solve_kind("count_above", z, k=k, backend=backend,
                            rounds=rounds, spec_k=spec_k)
    return _maybe_squeeze(out, squeeze)


def topk_mask(logits: Tensor, k, **kw) -> Tensor:
    """Boolean mask of the top-k logits per row (``row > hi``)."""
    z, squeeze = _rows(logits)
    lo, hi = topk_threshold(z, k, **kw)
    return _maybe_squeeze(z > hi[:, None], squeeze)


# ---------------------------------------------------------------------------
# top-p (nucleus) threshold
# ---------------------------------------------------------------------------

def topp_threshold(probs: Tensor, p, *, spec_k: int = 5, rounds: int = 8,
                   backend: str = "torch") -> tuple[Tensor, Tensor]:
    """Bracket tau such that the mass of {row >= tau} crosses p per row."""
    pr, squeeze = _rows(probs)
    out = solver.solve_kind("mass_at_or_above", pr, p=p, backend=backend,
                            rounds=rounds, spec_k=spec_k)
    return _maybe_squeeze(out, squeeze)


def topp_mask(probs: Tensor, p, **kw) -> Tensor:
    """Nucleus mask ``row >= lo``: f(lo) < 0 guarantees mass > p."""
    pr, squeeze = _rows(probs)
    lo, hi = topp_threshold(pr, p, **kw)
    return _maybe_squeeze(pr >= lo[:, None], squeeze)


# ---------------------------------------------------------------------------
# entropy-calibrated temperature
# ---------------------------------------------------------------------------

def entropy_temperature(logits: Tensor, target_entropy, *, t_lo: float = 0.05,
                        t_hi: float = 20.0, spec_k: int = 4, rounds: int = 8,
                        backend: str = "torch") -> Tensor:
    """Solve softmax temperature T per row with H(softmax(row / T)) = target."""
    z, squeeze = _rows(logits)
    lo, hi = solver.solve_kind(
        "entropy_at_temperature", z, target=target_entropy, t_lo=t_lo,
        t_hi=t_hi, backend=backend, rounds=rounds, spec_k=spec_k)
    return _maybe_squeeze((lo + hi) / 2, squeeze)


# ---------------------------------------------------------------------------
# quantile and MoE expert capacity
# ---------------------------------------------------------------------------

def quantile(x: Tensor, q, *, spec_k: int = 5, rounds: int = 8,
             backend: str = "torch") -> Tensor:
    """Approximate q-quantile of a flat tensor by count bisection."""
    xf = x.float().reshape(1, -1)
    lo, hi = solver.solve_kind("count_below", xf, q=q, backend=backend,
                               rounds=rounds, spec_k=spec_k)
    return (lo[0] + hi[0]) / 2


def capacity_threshold(scores: Tensor, capacity: int, *, spec_k: int = 4,
                       rounds: int = 6, backend: str = "torch") -> Tensor:
    """Per-expert router threshold keeping at most `capacity` tokens:
    count(scores[e] > tau[e]) <= capacity, guaranteed by the bracket."""
    s, squeeze = _rows(scores)
    lo, hi = topk_threshold(s, capacity, spec_k=spec_k, rounds=rounds,
                            backend=backend)
    return _maybe_squeeze(hi, squeeze)


# ---------------------------------------------------------------------------
# batched-name compatibility aliases (batch is the native axis)
# ---------------------------------------------------------------------------

def topk_mask_batched(logits: Tensor, k, **kw) -> Tensor:
    return topk_mask(logits, k, **kw)


def topp_mask_batched(probs: Tensor, p, **kw) -> Tensor:
    return topp_mask(probs, p, **kw)


def entropy_temperature_batched(logits: Tensor, target, **kw) -> Tensor:
    return entropy_temperature(logits, target, **kw)
