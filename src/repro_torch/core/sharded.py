"""Chip-level runahead bisection: the speculative points spread over the
ranks of a mesh axis (port of ``repro.core.sharded``; the paper's Fig. 6).

Each rank along ``axis`` plays a block of the paper's helper threads: it
evaluates its chunk of the ``2**k - 1`` speculative points, and ONE
all-gather of the values (2**k - 1 floats) is the paper's thread join.
The collective's latency is the multicore substrate's join cost, which
sets the Fig. 6 crossover.

A thin B=1 view of the batched engine (``repro_torch.core.solver``), as
``runahead_solve`` is: the round loop, the midpoint tree and the
serial-exact sign walk are the engine's (``_solve_rounds`` with an
``iterations`` budget and the last midpoint); only the point-sharded
``multi_eval`` (my chunk, evaluate, gather) lives here.

  * 2**k - 1 points don't split evenly over D ranks, so the grid is
    padded (``_pad_fill``, a repeat of the last point); the padded
    evaluations' signs are computed and DISCARDED: the gathered vector is
    cut to 2**k - 1 before the walk reads it (the uneven-split tests
    poison the pad to prove it).
  * Every rank runs the same walk on the same gathered values, so the
    new interval agrees everywhere with no broadcast.
  * The step is built once per (f, iterations, spec_k, mesh, axis,
    dtype) and kept: pass the same ``f`` object to reuse it.  It runs
    eagerly: a collective does not go into a CUDA graph under gloo.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.solver import _sign_bit, _solve_rounds

Tensor = torch.Tensor


def _pad_fill(interior: Tensor, n_fill: int) -> Tensor:
    """Pad values for the uneven split: repeats of the last interior point.

    Any value is legal here, since the padded signs never reach the walk;
    tests monkeypatch this with poison (NaN) to assert the discard.
    """
    return interior[-1:].expand(n_fill)


@functools.lru_cache(maxsize=64)
def _cached_sharded_solve(f: Callable[[Tensor], Tensor], iterations: int,
                          spec_k: int, mesh, axis: str, dtype: torch.dtype):
    """Build (once) the point-sharded solve for this configuration.

    Keyed on ``f`` BY IDENTITY: a fresh closure per call is a miss every
    time, and the cache then holds up to 64 stale closures.
    """
    n_pts = (1 << spec_k) - 1
    d = mesh.axis_size(axis)
    chunk = -(-n_pts // d)
    start = mesh.axis_index(axis) * chunk

    def multi_eval(taus: Tensor) -> Tensor:        # (1, 2**k - 1)
        pts = torch.cat([taus[0], _pad_fill(taus[0], chunk * d - n_pts)])
        vals = f(pts[start:start + chunk])         # my chunk, evaluated
        return mesh.all_gather(vals, axis)[:n_pts][None]   # pad dropped

    def run(a: Tensor, b: Tensor, sign_lo: Tensor) -> Tensor:
        _, _, lm = _solve_rounds(
            multi_eval, a[None], b[None], rounds=0, spec_k=spec_k,
            sign_lo=sign_lo[None], iterations=iterations,
            return_last_mid=True)
        return lm[0]

    return run


def find_root_runahead_sharded(
    f: Callable[[Tensor], Tensor],
    a,
    b,
    iterations: int,
    spec_k: int,
    mesh,
    axis: str = "model",
) -> Tensor:
    """Runahead bisection with the speculative evaluations sharded over a
    mesh axis; every rank of the axis calls it and gets the same root.

    Returns the last midpoint examined (Algorithm 1's contract),
    trajectory-identical to ``find_root_serial(mode="signbit")``.
    """
    a = torch.as_tensor(a, device=mesh.device)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    sign_lo = _sign_bit(f(a[None])[0])
    solve = _cached_sharded_solve(f, iterations, spec_k, mesh, axis,
                                  a.dtype)
    return solve(a, b, sign_lo)
