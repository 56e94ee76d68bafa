"""Batched runahead solve engine, single-device half (port of
``repro.core.solver``).

The paper collapses ``k`` serial bisection steps into one parallel round by
evaluating all ``2**k - 1`` interior points of the uniform ``2**k``-partition
at once.  Batch is a native axis: the speculative grid is a ``(B, 2**k + 1)``
midpoint tree, one ``multi_eval`` call answers all ``(B, 2**k - 1)``
candidates, and the serial-exact sign walk runs on ``(B,)`` index vectors.

Problem *kinds* name the monotone function family; a registry maps
``(kind, backend)`` to a factory producing a :class:`MonotoneProblem`.  The
``"torch"`` backend (this module) is the broadcast-compare-reduce oracle;
the ``"hopper"`` backend (``repro_torch.kernels.solver_backends``, loaded
lazily) answers the same candidates with hand-written CUDA kernels and
supplies a whole-solve kernel for a static top-k target.

The round loop is a Python loop over device tensors that never copies a
bracket to the host (no ``.item()``, ``.cpu()``, ``.tolist()`` or
``bool(tensor)``), so a solve on the card runs without a host sync.

Sign convention (paper §IV.A): the stored bit is '1' iff the value is
negative; an exact zero counts positive.  The walk only compares bits, so
monotone non-increasing problems work unchanged.

Not ported yet: the mesh-sharded half and the tuner.  ``solve_kind`` runs
the caller's ``(rounds, spec_k)`` as given, which is the JAX package's
behaviour under ``tuning.disabled()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

Tensor = torch.Tensor
MultiEval = Callable[[Tensor], Tensor]          # taus (B, M) -> f values (B, M)


def _sign_bit(v: Tensor) -> Tensor:
    """Paper §IV.A: '1' if negative else '0'.  Exact zero counts positive."""
    return v < 0


@dataclasses.dataclass(frozen=True)
class MonotoneProblem:
    """A batch of monotone root-finds sharing one fused evaluator.

    multi_eval: evaluates f at a ``(B, M)`` grid of candidates in one pass,
        returning ``(B, M)`` values (M = 1 for the bracket-sign probe,
        ``2**spec_k - 1`` per round).  Candidate grids may be row-strided
        views.
    lo0 / hi0:  ``(B,)`` initial bracket endpoints.
    sign_bit:   the sign convention mapping values to walk bits.
    sign_lo:    optional precomputed ``(B,)`` bit of ``f(lo0)``; when None
        the engine spends one extra M=1 ``multi_eval`` probe on it.
    fused_solve: optional whole-solve override ``(rounds=, spec_k=) ->
        (lo, hi) | None``; None falls back to the generic round loop.
    """

    multi_eval: MultiEval
    lo0: Tensor
    hi0: Tensor
    sign_bit: Callable[[Tensor], Tensor] = _sign_bit
    sign_lo: Tensor | None = None
    fused_solve: Callable[..., tuple[Tensor, Tensor] | None] | None = None


# ---------------------------------------------------------------------------
# the batched round loop
# ---------------------------------------------------------------------------

def _midpoint_tree(lo: Tensor, hi: Tensor, k: int) -> Tensor:
    """(B,) brackets -> (B, 2**k + 1) bisection-tree grids.

    Every interior point is the exact float midpoint of its parents, level
    by level, so each row's grid is bit-identical to the midpoints serial
    bisection would generate along any root path.
    """
    n = 1 << k
    grid = torch.zeros(lo.shape + (n + 1,), dtype=torch.result_type(lo, hi),
                       device=lo.device)
    grid[..., 0] = lo
    grid[..., n] = hi
    for level in range(1, k + 1):
        d = 1 << (k - level)
        # odd multiples of d, from their neighbours at distance d
        grid[..., d:n:2 * d] = (grid[..., 0:n - d:2 * d]
                                + grid[..., 2 * d:n + 1:2 * d]) / 2
    return grid


def _select_walk(signs: Tensor, sign_lo: Tensor, k: int,
                 steps: int | None = None):
    """Serial-exact sign walk over (B,) index grids [0, 2**k].

    signs[b, i] is the bit of grid point i+1 (interior points only).
    ``steps`` (<= k) limits the walk to a partial round; None walks all k
    steps.  Returns (lo_idx, hi_idx, sign_lo_new, last_mid_idx), each (B,)
    int64; last_mid_idx starts at the interval midpoint 2**(k-1).
    """
    n = 1 << k
    batch = signs.shape[0]
    dev = signs.device
    l = torch.zeros((batch,), dtype=torch.int64, device=dev)
    h = torch.full((batch,), n, dtype=torch.int64, device=dev)
    lm = torch.full((batch,), n // 2, dtype=torch.int64, device=dev)
    sl = sign_lo
    for _ in range(k if steps is None else steps):
        mid = (l + h) // 2
        smid = torch.gather(signs, 1, (mid - 1)[:, None])[:, 0]
        go_left = sl != smid
        l = torch.where(go_left, l, mid)
        h = torch.where(go_left, mid, h)
        sl = torch.where(go_left, sl, smid)
        lm = mid
    return l, h, sl, lm


def _solve_rounds(
    multi_eval: MultiEval,
    lo0: Tensor,
    hi0: Tensor,
    *,
    rounds: int,
    spec_k: int,
    sign_lo: Tensor | None = None,
    sign_bit: Callable[[Tensor], Tensor] = _sign_bit,
    iterations: int | None = None,
) -> tuple[Tensor, Tensor]:
    """Run `rounds` speculative rounds natively over (B,) problems.

    ``iterations`` optionally caps the serial-step budget: rounds become
    ceil(iterations / spec_k) with a partial walk in the last round.
    """
    hi0 = hi0.to(lo0.dtype)
    if iterations is not None:
        rounds = -(-iterations // spec_k)
    if sign_lo is None:
        sign_lo = sign_bit(multi_eval(lo0[:, None])[:, 0])
    lo, hi, sl = lo0, hi0, sign_lo
    for r in range(rounds):
        grid = _midpoint_tree(lo, hi, spec_k)            # (B, 2**k + 1)
        signs = sign_bit(multi_eval(grid[:, 1:-1]))      # (B, 2**k - 1)
        steps = (None if iterations is None
                 else min(iterations - r * spec_k, spec_k))
        li, hi_i, sl, _ = _select_walk(signs, sl, spec_k, steps)
        lo = torch.gather(grid, 1, li[:, None])[:, 0]
        hi = torch.gather(grid, 1, hi_i[:, None])[:, 0]
    return lo, hi


def solve(
    problem: MonotoneProblem,
    *,
    rounds: int,
    spec_k: int,
    iterations: int | None = None,
) -> tuple[Tensor, Tensor]:
    """Solve a batch of monotone problems: final (lo, hi) brackets, (B,) each.

    ``rounds * spec_k`` serial-equivalent bisection steps per row.  A
    problem's ``fused_solve`` is preferred unless ``iterations`` caps the
    budget (the fused kernel always walks full rounds).
    """
    if problem.fused_solve is not None and iterations is None:
        out = problem.fused_solve(rounds=rounds, spec_k=spec_k)
        if out is not None:
            return out
    return _solve_rounds(
        problem.multi_eval, problem.lo0, problem.hi0,
        rounds=rounds, spec_k=spec_k, sign_lo=problem.sign_lo,
        sign_bit=problem.sign_bit, iterations=iterations,
    )


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

# (kind, backend) -> factory(operand, **params) -> MonotoneProblem
_REGISTRY: dict[tuple[str, str], Callable[..., MonotoneProblem]] = {}

# Backends whose factories live outside core/ register themselves on first
# use: core never imports the kernels at module scope.
_LAZY_BACKEND_MODULES = {"hopper": "repro_torch.kernels.solver_backends"}


def register(kind: str, backend: str):
    """Decorator: register a problem factory for (kind, backend)."""

    def deco(factory: Callable[..., MonotoneProblem]):
        _REGISTRY[(kind, backend)] = factory
        return factory

    return deco


def problem(kind: str, operand: Tensor, *, backend: str = "torch", **params
            ) -> MonotoneProblem:
    """Build the MonotoneProblem for `kind` on `operand` via `backend`."""
    module = _LAZY_BACKEND_MODULES.get(backend)
    if module is not None:
        importlib.import_module(module)
    try:
        factory = _REGISTRY[(kind, backend)]
    except KeyError:
        raise KeyError(
            f"no solver backend {backend!r} for kind {kind!r}; "
            f"registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(operand, **params)


def solve_kind(
    kind: str,
    operand: Tensor,
    *,
    backend: str = "torch",
    rounds: int,
    spec_k: int,
    **params,
) -> tuple[Tensor, Tensor]:
    """problem() + solve() in one call: the applications' entry point.

    Runs the caller's ``rounds * spec_k`` decomposition as given on one
    device.  ``backend="auto"`` needs the tuner, which is not ported yet.
    """
    if backend == "auto":
        raise ValueError("backend='auto' needs the solver tuner, which the "
                         "port does not have yet; use 'torch' or 'hopper'")
    return solve(problem(kind, operand, backend=backend, **params),
                 rounds=rounds, spec_k=spec_k)


# ---------------------------------------------------------------------------
# "torch" oracle backends: broadcast-compare-reduce, always available
# ---------------------------------------------------------------------------

def true_div(t: Tensor, d: float) -> Tensor:
    """``t / d`` as an IEEE division, as JAX computes it.

    PyTorch divides by a Python or CPU scalar by multiplying with its
    reciprocal, which can round differently; a divisor of ``t``'s own
    shape takes the true-division path on every device.
    """
    return t / torch.full_like(t, d)


def _known_negative_sign_lo(batch: int, known: bool, device) -> Tensor | None:
    """sign bit of f(lo0) when it is statically known to be negative:
    skips the engine's M=1 probe pass (one whole operand sweep)."""
    return torch.ones((batch,), dtype=torch.bool, device=device) if known else None


def _param_col(p, device, dtype=torch.float32) -> Tensor:
    """Problem parameter as a broadcast-ready column.

    Scalars become 0-d tensors made on ``device`` (a fill, not a host
    copy); per-row ``(B,)`` tensors become ``(B, 1)`` columns.
    """
    if not isinstance(p, torch.Tensor):
        return torch.full((), p, dtype=dtype, device=device)
    arr = p.to(device=device, dtype=dtype)
    if arr.ndim == 0:
        return arr
    if arr.ndim == 1:
        return arr[:, None]
    raise ValueError(f"problem parameter must be scalar or (B,), "
                     f"got shape {tuple(arr.shape)}")


@register("count_above", "torch")
def _count_above_torch(operand: Tensor, *, k) -> MonotoneProblem:
    """f(tau) = k - #{v : row[v] > tau}; monotone non-decreasing in tau.

    Counts are small integers, exact in f32 under any summation order, so
    this oracle is bit-identical to the kernel backend.
    """
    x = operand.float()
    lo0 = x.amin(dim=-1) - 1.0
    hi0 = x.amax(dim=-1) + 1.0
    k_col = _param_col(k, x.device)

    def multi_eval(taus: Tensor) -> Tensor:
        counts = (x[:, None, :] > taus[:, :, None]).sum(dim=-1)
        return k_col - counts.float()

    # f(lo0) = k - V: negative whenever k < V (the non-degenerate case).
    sign_lo = _known_negative_sign_lo(
        x.shape[0], isinstance(k, int) and k < x.shape[-1], x.device)
    return MonotoneProblem(multi_eval, lo0, hi0, sign_lo=sign_lo)


@register("mass_at_or_above", "torch")
def _mass_torch(operand: Tensor, *, p) -> MonotoneProblem:
    """f(tau) = p - sum(row[v] where row[v] >= tau); non-decreasing."""
    probs = operand
    lo0 = torch.zeros(probs.shape[:-1], dtype=probs.dtype, device=probs.device)
    hi0 = probs.amax(dim=-1) + 1e-6
    p_col = _param_col(p, probs.device, probs.dtype)

    def multi_eval(taus: Tensor) -> Tensor:
        keep = probs[:, None, :] >= taus[:, :, None]
        mass = torch.where(keep, probs[:, None, :], 0.0).sum(dim=-1)
        return p_col - mass

    return MonotoneProblem(multi_eval, lo0, hi0)


@register("entropy_at_temperature", "torch")
def _entropy_torch(operand: Tensor, *, target, t_lo: float = 0.05,
                   t_hi: float = 20.0) -> MonotoneProblem:
    """f(T) = target - H(softmax(row / T)); H increasing in T."""
    z = operand.float()
    batch = z.shape[0]
    lo0 = torch.full((batch,), t_lo, dtype=torch.float32, device=z.device)
    hi0 = torch.full((batch,), t_hi, dtype=torch.float32, device=z.device)
    target_col = _param_col(target, z.device)

    def multi_eval(ts: Tensor) -> Tensor:
        zt = z[:, None, :] / ts[:, :, None]                 # (B, M, V)
        logp = zt - torch.logsumexp(zt, dim=-1, keepdim=True)
        h = -(torch.exp(logp) * logp).sum(dim=-1)           # (B, M)
        return target_col - h

    return MonotoneProblem(multi_eval, lo0, hi0)


@register("count_below", "torch")
def _count_below_torch(operand: Tensor, *, q) -> MonotoneProblem:
    """f(c) = #{v : row[v] < c} / N - q; non-decreasing (quantile solve)."""
    x = operand.float()
    n = x.shape[-1]
    lo0 = x.amin(dim=-1) - 1.0
    hi0 = x.amax(dim=-1) + 1.0
    q_col = _param_col(q, x.device)

    def multi_eval(cs: Tensor) -> Tensor:
        below = (x[:, None, :] < cs[:, :, None]).sum(dim=-1)
        return true_div(below.float(), n) - q_col

    # f(lo0) = 0/N - q: negative for any positive static q.
    sign_lo = _known_negative_sign_lo(
        x.shape[0], isinstance(q, float) and q > 0, x.device)
    return MonotoneProblem(multi_eval, lo0, hi0, sign_lo=sign_lo)
