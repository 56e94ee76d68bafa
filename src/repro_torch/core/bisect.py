"""Serial bisection root-finding, the paper's baseline (Algorithm 1; port
of ``repro.core.bisect``).

Faithful to the paper:
  * fixed iteration count, NO early exit even when the exact root is hit;
  * each iteration evaluates f once at the midpoint;
  * the returned ``root`` is the *last midpoint examined* (Algorithm 1
    returns the loop variable ``root``, not the interval centre).

Two sign conventions, as in the paper:

  * ``mode="product"``: Algorithm 1 literal, ``f(a) * f(root) < 0``.  An
    exact zero at the midpoint takes the ``else`` branch (a <- root).
  * ``mode="signbit"``: the runahead array semantics (paper §IV.A), a
    value's bit is '1' iff it is negative.  An exact zero counts as
    positive, so ``f(root) == 0`` sends the root to the left half.

``repro_torch.core.runahead`` is trajectory-equivalent to
``mode="signbit"``, bit for bit.

The loop is a Python loop over device tensors: no value is read back to
the host, so a solve on the card runs without a host sync.  ``f`` takes a
tensor of any shape and is applied elementwise, so the batched view is the
same loop over a ``(B,)`` batch axis.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.solver import _sign_bit

Tensor = torch.Tensor


def _endpoints(a, b) -> tuple[Tensor, Tensor]:
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a, b


def find_root_serial(
    f: Callable[[Tensor], Tensor],
    a,
    b,
    iterations: int,
    mode: str = "product",
) -> Tensor:
    """Algorithm 1 of the paper.  Returns the last midpoint examined."""
    if mode not in ("product", "signbit"):
        raise ValueError(f"unknown mode {mode!r}")
    a, b = _endpoints(a, b)
    fa = f(a)
    root = (a + b) / 2
    for _ in range(iterations):
        root = (a + b) / 2
        froot = f(root)
        if mode == "product":
            go_left = fa * froot < 0
        else:
            go_left = _sign_bit(fa) != _sign_bit(froot)
        # go_left: the root is bracketed by (a, root), so b <- root
        a, b, fa = (torch.where(go_left, a, root),
                    torch.where(go_left, root, b),
                    torch.where(go_left, fa, froot))
    return root


def find_root_serial_batched(
    f: Callable[[Tensor], Tensor],
    a,
    b,
    iterations: int,
    mode: str = "product",
) -> Tensor:
    """Algorithm 1 over a ``(B,)`` batch of independent problems.

    ``f`` must be elementwise: it gets one query point per problem.
    """
    a, b = _endpoints(a, b)
    if a.ndim != 1 or b.shape != a.shape:
        raise ValueError(f"a and b must be (B,) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return find_root_serial(f, a, b, iterations, mode)


def iterations_for_error(a: float, b: float, eps: float) -> int:
    """Paper §III.A: ceil(log2((b - a) / eps)) iterations reach error < eps."""
    return int(math.ceil(math.log2((b - a) / eps)))
