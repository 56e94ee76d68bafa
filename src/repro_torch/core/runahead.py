"""Runahead bisection, the paper's contribution (port of
``repro.core.runahead``).

The paper (§IV): with ``2**k - 1`` helper threads, speculatively evaluate f
at *all* interior points of the uniform ``2**k``-partition of the current
interval.  The sign bits of those evaluations answer the next ``k`` serial
bisection steps, so ``k`` steps collapse into one parallel round: ``n``
iterations take ``ceil(n / k)`` rounds.

On the card the helper threads are one evaluator call over the round's
``2**k - 1`` points (``multi_eval``; for the paper's f, the kernel K1).
The grid and the walk are the batched engine's own
(``core/solver.py``: ``_midpoint_tree``, ``_select_walk``), applied to a
batch of one problem: the JAX package's scalar versions of the two
(``repro/core/runahead.py``) compute the same values, which
``tests/test_torch_paper.py`` checks.

Two selection rules:
  * ``select="walk"`` (default): the serial sign-bit trajectory, exactly.
    Handles several roots in the interval as serial does.
  * ``select="xor"``: the paper's literal rule, the first adjacent sign
    flip.  The same as "walk" whenever the sign vector is monotone (one
    bracketed root), which the paper assumes.

The round loop (``_runahead_rows``) is a Python loop over device tensors
and never reads a value back to the host.  On the card a solve is one
CUDA-graph replay of it, one graph per (f or multi_eval, iterations,
spec_k, select, shape, dtype, device), in the serial solves' graph cache
(``core/bisect.py``), so a speed-up against serial compares like with
like.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core.bisect import GRAPHS
from repro_torch.core.solver import (
    _midpoint_tree,
    _select_walk,
    _sign_bit,
    _solve_rounds,
)

Tensor = torch.Tensor


class RunaheadState(NamedTuple):
    lo: Tensor             # current interval low endpoint
    hi: Tensor             # current interval high endpoint
    sign_lo: Tensor        # sign bit of f(lo)  (True = negative)
    last_mid: Tensor       # last midpoint "examined" (Algorithm 1's `root`)


def _select_xor(signs: Tensor, sign_lo: Tensor, k: int):
    """Paper's literal rule over (B,) rows: first adjacent sign flip in
    [sign(lo), interior signs..., sign(hi)].

    The hi-edge sign is by construction the complement of sign(lo) for a
    bracketed root (Algorithm 1 never evaluates f(b); neither do we).
    Returns (lo_idx, hi_idx), each (B,) int64.
    """
    full = torch.cat([sign_lo[:, None], signs, ~sign_lo[:, None]], dim=1)
    flips = full[:, :-1] != full[:, 1:]                # (B, 2**k) XOR
    i = torch.argmax(flips.to(torch.uint8), dim=1)      # first flip
    return i, i + 1


def _take(rows: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(rows, 1, idx[:, None])[:, 0]


def _runahead_rows(
    evaluate: Callable[[Tensor], Tensor],
    state: RunaheadState,
    iterations: int,
    k: int,
    select: str,
) -> RunaheadState:
    """``ceil(iterations / k)`` rounds over (B,) problems; ``evaluate``
    maps a (B, 2**k - 1) grid of points to f there."""
    lo, hi, sl, last_mid = state
    for r in range(-(-iterations // k)):
        grid = _midpoint_tree(lo, hi, k)                 # (B, 2**k + 1)
        signs = _sign_bit(evaluate(grid[:, 1:-1]))       # (B, 2**k - 1)
        if select == "walk":
            steps = min(iterations - r * k, k)
            li, hi_i, _, lm = _select_walk(signs, sl, k, steps)
        else:
            li, hi_i = _select_xor(signs, sl, k)
            lm = (li + hi_i) // 2
        # sign of f at the new lo: index 0 is the old lo (sign carried),
        # interior index i has signs[i - 1]
        sl = _take(torch.cat([sl[:, None], signs], dim=1), li)
        lo, hi, last_mid = _take(grid, li), _take(grid, hi_i), _take(grid, lm)
    return RunaheadState(lo, hi, sl, last_mid)


def _check_select(select: str) -> None:
    if select not in ("walk", "xor"):
        raise ValueError(f"unknown select {select!r}")


def find_root_runahead(
    f: Callable[[Tensor], Tensor],
    a,
    b,
    iterations: int,
    spec_k: int,
    select: str = "walk",
    multi_eval: Callable[[Tensor], Tensor] | None = None,
) -> Tensor:
    """Runahead bisection resolving `iterations` serial steps, k per round.

    Args:
      f: scalar function, evaluated on the (2**spec_k - 1,) vector of a
         round's speculative points; ignored if ``multi_eval`` is given.
      iterations: number of *serial-equivalent* bisection steps to resolve;
         rounds = ceil(iterations / spec_k), the last one a partial walk
         if spec_k does not divide it.
      spec_k: speculation depth; 2**spec_k - 1 points per round (the
         paper's thread count).
      select: "walk" (serial-exact) or "xor" (paper's adjacent-flip rule).
      multi_eval: optional evaluator of a *vector* of points in one pass.

    Returns the last midpoint examined, the contract of Algorithm 1.
    """
    _check_select(select)
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    key = ("runahead", f, multi_eval, iterations, spec_k, select, a.shape,
           b.shape, a.dtype, a.device)
    return GRAPHS.run(key, functools.partial(
        _runahead, f, multi_eval, iterations=iterations, spec_k=spec_k,
        select=select), a, b)


def _runahead(f, multi_eval, a: Tensor, b: Tensor, *, iterations: int,
              spec_k: int, select: str) -> Tensor:
    """The body of a scalar runahead solve: the sign at a, then the
    rounds on a batch of one."""
    evaluate = multi_eval if multi_eval is not None else f
    sign_lo = _sign_bit(f(a) if multi_eval is None else evaluate(a[None])[0])
    state = RunaheadState(a[None], b[None], sign_lo[None], ((a + b) / 2)[None])
    final = _runahead_rows(lambda g: evaluate(g[0])[None], state, iterations,
                           spec_k, select)
    return final.last_mid[0]


def runahead_solve(
    multi_eval: Callable[[Tensor], Tensor],
    lo,
    hi,
    *,
    rounds: int,
    spec_k: int,
    sign_lo=None,
) -> tuple[Tensor, Tensor]:
    """Generic SCALAR interval solve: returns the final (lo, hi) bracket.

    ``multi_eval`` takes the vector of 2**spec_k - 1 speculative points and
    returns f at each in one pass.  A B=1 view of the batched engine
    (``core/solver.py::_solve_rounds``).
    """
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)

    def batched_eval(taus: Tensor) -> Tensor:            # (1, M) -> (1, M)
        return multi_eval(taus[0])[None]

    lo_f, hi_f = _solve_rounds(
        batched_eval, lo[None], hi[None], rounds=rounds, spec_k=spec_k,
        sign_lo=None if sign_lo is None else torch.as_tensor(sign_lo)[None])
    return lo_f[0], hi_f[0]


def find_root_runahead_batched(
    f: Callable[[Tensor], Tensor],
    a,
    b,
    iterations: int,
    spec_k: int,
    select: str = "walk",
) -> Tensor:
    """Runahead over a ``(B,)`` batch of independent problems: every
    round evaluates the elementwise ``f`` on one (B, 2**k - 1) grid."""
    _check_select(select)
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    if a.ndim != 1 or b.shape != a.shape:
        raise ValueError(f"a and b must be (B,) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    key = ("runahead_batched", f, iterations, spec_k, select, a.shape,
           a.dtype, a.device)
    return GRAPHS.run(key, functools.partial(
        _runahead_batched, f, iterations=iterations, spec_k=spec_k,
        select=select), a, b)


def _runahead_batched(f, a: Tensor, b: Tensor, *, iterations: int,
                      spec_k: int, select: str) -> Tensor:
    """The body of a batched runahead solve."""
    state = RunaheadState(a, b, _sign_bit(f(a)), (a + b) / 2)
    return _runahead_rows(f, state, iterations, spec_k, select).last_mid


def serial_equivalent_iterations(rounds: int, spec_k: int) -> int:
    """Paper §IV.B: rounds r at speculation k resolve r*k serial steps."""
    return rounds * spec_k
