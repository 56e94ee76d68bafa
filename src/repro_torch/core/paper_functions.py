"""The paper's evaluation function: Taylor-series trig (Table 1; port of
``repro.core.paper_functions``).

f(x) = sin(cos(x)), with sin and cos evaluated by their Taylor series at a
configurable term count: the term count is the *latency knob* of the
Fig. 6/7 sensitivity study.  Terms follow the recurrences

  sin: t_{i+1} = -t_i * x^2 / ((2i+2)(2i+3)),   t_0 = x
  cos: t_{i+1} = -t_i * x^2 / ((2i+1)(2i+2)),   t_0 = 1

in the JAX package's order: the product ``-t * x2`` first, then one true
division by the denominator, which is formed in the input's dtype (it
rounds once it passes 2**24 in float32, near i = 2048, and must round in
the same place).  The denominators are a device tensor, so the division
is an IEEE division on every device (PyTorch divides by a Python scalar
through its reciprocal on the card).  ``-t * x2`` is computed as
``t * (-x2)``: negation is exact, so the two are the same bits.

This is the plain version, one small tensor op per step; the card
evaluates the same recurrences in one launch with the hand-written kernel
K1 (``repro_torch.kernels.taylor_eval``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _denominators(n: int, first: int, like: Tensor) -> Tensor:
    """(2i + first)(2i + first + 1) for i < n, in ``like``'s dtype."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    return (2 * i + first) * (2 * i + (first + 1))


def _series(x: Tensor, t0: Tensor, terms: int, first: int) -> Tensor:
    neg_x2 = -(x * x)
    den = _denominators(terms - 1, first, x)
    acc, t = t0, t0
    for i in range(terms - 1):
        t = t * neg_x2 / den[i]
        acc = acc + t
    return acc


def taylor_sin(x, terms: int) -> Tensor:
    x = torch.as_tensor(x)
    return _series(x, x, terms, 2)


def taylor_cos(x, terms: int) -> Tensor:
    x = torch.as_tensor(x)
    return _series(x, torch.ones_like(x), terms, 1)


def make_paper_f(terms: int):
    """f(x) = sin(cos(x)) with `terms`-term Taylor series (paper Table 1).

    Elementwise, so it serves both the serial baseline and the runahead
    speculative grid.  The paper's default is terms = 10**4.
    """

    def f(x: Tensor) -> Tensor:
        return taylor_sin(taylor_cos(x, terms), terms)

    return f


# Paper Table 1 experiment constants.
PAPER_INTERVAL = (1.0, 2.0)
PAPER_TERMS = 10_000
PAPER_EPS_CPU = 2.0 ** -6
