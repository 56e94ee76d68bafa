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

Autotuning: ``solve_kind`` asks ``repro_torch.core.tuning`` how to spend
the caller's serial-step budget ``rounds * spec_k`` (the decomposition,
the placement under a mesh and, for ``backend="auto"``, the backend), per
static configuration; every decision keeps the budget, so tuned solves
stay bit for bit equal to the serial sign-bit walk.

Mesh execution: under an active :func:`mesh_policy` the engine runs SPMD
over ``torch.distributed`` ranks (``launch/mesh.py``).  Every rank of the
policy's group calls ``solve_kind`` with the same global ``(B, V)``
operand and gets the same global ``(B,)`` brackets back, as JAX's
``out_specs`` make them.  Under ``"data"`` each rank solves its block of
rows with the plain factory (whole-solve kernels included, since it holds
whole rows); under ``"vocab"`` each rank solves its ``(B/d, V/m)`` block
with the sharded factory, whose evaluator partial-reduces its vocab
shard and joins the partials in one all-reduce over the vocab group a
round (the paper's thread join); the rows come back through one
all-gather over the data axes.  A policy with ``local_rows`` takes and
returns this rank's block of rows instead (the serving scheduler, whose
slots already live on their data rank).  The ranks of a group take the
decision together: the group's first rank decides and broadcasts it, so
no rank can pick a placement whose collectives the others never issue.
``core/sharded.py`` is the B=1 point-sharded view of the same loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Any, Callable

import torch

from repro_torch.core import tuning
from repro_torch.launch.shardings import local_block

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
    return_last_mid: bool = False,
):
    """Run `rounds` speculative rounds natively over (B,) problems.

    ``iterations`` optionally caps the serial-step budget: rounds become
    ceil(iterations / spec_k) with a partial walk in the last round.
    ``return_last_mid`` also returns the (B,) last midpoints examined
    (Algorithm 1's ``root``), which ``core/sharded.py`` returns.
    """
    hi0 = hi0.to(lo0.dtype)
    if iterations is not None:
        rounds = -(-iterations // spec_k)
    if sign_lo is None:
        sign_lo = sign_bit(multi_eval(lo0[:, None])[:, 0])
    lo, hi, sl = lo0, hi0, sign_lo
    lm = (lo0 + hi0) / 2
    for r in range(rounds):
        grid = _midpoint_tree(lo, hi, spec_k)            # (B, 2**k + 1)
        signs = sign_bit(multi_eval(grid[:, 1:-1]))      # (B, 2**k - 1)
        steps = (None if iterations is None
                 else min(iterations - r * spec_k, spec_k))
        li, hi_i, sl, lmi = _select_walk(signs, sl, spec_k, steps)
        lo = torch.gather(grid, 1, li[:, None])[:, 0]
        hi = torch.gather(grid, 1, hi_i[:, None])[:, 0]
        if return_last_mid:
            lm = torch.gather(grid, 1, lmi[:, None])[:, 0]
    if return_last_mid:
        return lo, hi, lm
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
# mesh execution policy: the engine's SPMD form
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPolicy:
    """How the engine maps a batch of solves onto a mesh of ranks.

    vocab_axis: mesh axis sharding the operand's reduction (vocab) dim:
        each rank evaluates every candidate against its vocab shard and
        partial-reduces locally; one all-reduce per round plays the
        paper's thread join.  None disables vocab sharding.
    data_axes:  mesh axes sharding the batch dim (rows are independent
        solves: pure data parallelism).  None derives every mesh axis
        except ``vocab_axis``, in mesh order.
    local_rows: the caller already holds this rank's block of rows over
        ``data_axes`` (B_local = B / d) and wants its block back; the
        serving scheduler's slots live on their data rank so.  False: the
        caller holds the global operand, replicated, and gets global
        brackets back.

    Hashable (the mesh by identity), so solves and graphs can key on it.
    """

    mesh: Any
    vocab_axis: str | None = "model"
    data_axes: tuple[str, ...] | None = None
    local_rows: bool = False

    def __post_init__(self):
        if self.data_axes is None:
            object.__setattr__(
                self, "data_axes",
                tuple(a for a in self.mesh.axis_names
                      if a != self.vocab_axis))

    def row_axes(self) -> tuple[str, ...]:
        """The data axes present in the mesh: the rows' axes."""
        return tuple(a for a in self.data_axes if a in self.mesh.axis_names)

    def group_axes(self) -> tuple[str, ...]:
        """The axes whose ranks take part in this policy's solves."""
        axes = self.row_axes()
        if self.vocab_axis in self.mesh.axis_names:
            axes += (self.vocab_axis,)
        return axes

    def data_ways(self) -> int:
        return self.mesh.axis_size(self.row_axes())


_policy_state = threading.local()


def current_policy() -> MeshPolicy | None:
    return getattr(_policy_state, "policy", None)


@contextlib.contextmanager
def mesh_policy(policy, **kw):
    """Activate a MeshPolicy (or build one from a mesh) for the enclosed
    solves; ``None`` is a no-op so callers can pass an optional mesh
    straight through."""
    if policy is not None and not isinstance(policy, MeshPolicy):
        policy = MeshPolicy(policy, **kw)
    prev = current_policy()
    _policy_state.policy = policy
    try:
        yield policy
    finally:
        _policy_state.policy = prev


@dataclasses.dataclass(frozen=True)
class VocabJoin:
    """The joins of a vocab-sharded problem: all-reduces over the vocab
    group of this rank (the same bits on every rank of it)."""

    mesh: Any
    axis: str

    def sum(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t, self.axis, "sum")

    def min(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t, self.axis, "min")

    def max(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t, self.axis, "max")


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

# (kind, backend) -> factory(operand, **params) -> MonotoneProblem
_REGISTRY: dict[tuple[str, str], Callable[..., MonotoneProblem]] = {}

# (kind, backend) -> factory(local_operand, *, join, global_v, **params)
# -> MonotoneProblem.  Runs on this rank's vocab shard: multi_eval must
# partial-reduce locally and join over ``join`` (a VocabJoin); bracket
# inits join with MIN and MAX so every rank of the vocab group agrees on
# the global bracket bit for bit.
_SHARDED_REGISTRY: dict[tuple[str, str], Callable[..., MonotoneProblem]] = {}

# Backends whose factories live outside core/ register themselves on first
# use: core never imports the kernels at module scope.
_LAZY_BACKEND_MODULES = {"hopper": "repro_torch.kernels.solver_backends"}


def register(kind: str, backend: str):
    """Decorator: register a problem factory for (kind, backend)."""

    def deco(factory: Callable[..., MonotoneProblem]):
        _REGISTRY[(kind, backend)] = factory
        return factory

    return deco


def register_sharded(kind: str, backend: str):
    """Decorator: register a vocab-sharded factory for (kind, backend)."""

    def deco(factory: Callable[..., MonotoneProblem]):
        _SHARDED_REGISTRY[(kind, backend)] = factory
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


# the order "auto" ranks backends in on the CPU: the oracle first, as the
# JAX package ranks ("jnp", "pallas")
_BACKEND_ORDER = ("torch", "hopper")


def kinds() -> list[str]:
    """The registered problem kinds, sorted."""
    return sorted({k for k, _ in _REGISTRY})


def backends_for(kind: str) -> list[str]:
    """The backends registered for `kind`, oracle first."""
    for module in _LAZY_BACKEND_MODULES.values():
        importlib.import_module(module)
    return [b for b in _BACKEND_ORDER if (kind, b) in _REGISTRY]


def _static_param(v) -> bool:
    """Python scalars are static: they select known-sign fast paths and
    K3's whole-solve route, and key the measurement's operands."""
    return v is None or isinstance(v, (bool, int, float, str))


def solve_kind(
    kind: str,
    operand: Tensor,
    *,
    backend: str = "torch",
    rounds: int,
    spec_k: int,
    tune: bool | None = None,
    **params,
) -> tuple[Tensor, Tensor]:
    """problem() + solve() in one call: the applications' entry point.

    The caller's ``rounds * spec_k`` fixes the serial-step budget; how it
    is spent is decided per static configuration by the tuner
    (``repro_torch.core.tuning``): the analytic model by default, measured
    winners under ``tune=True`` or ``tuning.autotune()``;
    ``tuning.disabled()`` runs ``(rounds, spec_k)`` as given, vocab-
    sharded where an active mesh policy can shard the vocab, else
    data-sharded where it can shard the rows.
    ``backend`` is a preference: binding for "torch" and "hopper", free
    for "auto", which ranks ("torch", "hopper") on CPU tensors and
    "hopper" alone on CUDA tensors (on the card the oracle is the
    reference, never a candidate).

    Under an active :func:`mesh_policy` the decision also picks the
    placement ("vocab", "data" or "single", as JAX's does), the ranks of
    the policy's group agree on it, and every rank of the group must call
    with the same operand shape and parameters.
    """
    z = operand
    if z.ndim != 2:
        if backend == "auto":
            backend = "hopper" if z.device.type == "cuda" else "torch"
        return solve(problem(kind, z, backend=backend, **params),
                     rounds=rounds, spec_k=spec_k)

    policy = current_policy()
    iterations = rounds * spec_k
    rows = z.shape[0] * (policy.data_ways()
                         if policy is not None and policy.local_rows else 1)
    options = _placement_options(policy, rows, z.shape[1])
    if backend == "auto":
        cand_backends = (("hopper",) if z.device.type == "cuda"
                         else tuple(backends_for(kind)) or ("torch",))
    else:
        cand_backends = (backend,)
    fixed = tuning.Decision(
        spec_k=spec_k, rounds=rounds,
        placement="vocab" if "vocab" in options else (
            "data" if "data" in options else "single"),
        backend=cand_backends[0], source="fixed")
    key = tuning.ConfigKey(
        kind=kind, batch=rows, vocab=z.shape[1],
        dtype=tuning.dtype_name(z.dtype), backend_pref=backend,
        device_count=policy.mesh.size if policy is not None else 1,
        device_kind=tuning.device_kind(z.device),
        iterations=iterations,
        # K3's whole-solve route (kernels/solver_backends.py)
        fused=(kind == "count_above" and "hopper" in cand_backends
               and isinstance(params.get("k"), int)),
    )
    statics = {k: p for k, p in params.items() if _static_param(p)}
    decision = _decide(
        policy, key, options=options, backends=cand_backends, fixed=fixed,
        measure=lambda cands: _measure_candidates(key, cands, statics,
                                                  z.device, policy),
        tune=tune)
    return _execute_decision(decision, kind, z, params, iterations, policy)


def _placement_options(policy: MeshPolicy | None, b: int, v: int
                       ) -> dict[str, tuple[int, int]]:
    """Legal placements -> (vocab_ways, data_ways) for a (b, v) operand
    (``b`` the global rows).

    JAX's divisibility rules: an axis that does not divide its dim is
    dropped.  "vocab" keeps the data axes too (the engine shards both);
    "single" is always legal.
    """
    opts: dict[str, tuple[int, int]] = {"single": (1, 1)}
    if policy is None:
        return opts
    mesh = policy.mesh
    va = policy.vocab_axis
    vw = 1
    if va is not None and va in mesh.axis_names and mesh.shape[va] > 1 \
            and v % mesh.shape[va] == 0:
        vw = mesh.shape[va]
    dw = policy.data_ways()
    if dw <= 1 or b % dw:
        dw = 1
    if dw > 1:
        opts["data"] = (1, dw)
    if vw > 1:
        opts["vocab"] = (vw, dw)
    return opts


def _decide(policy: MeshPolicy | None, key, *, options, backends, fixed,
            measure, tune):
    """``tuning.decide``, taken together by the ranks of the policy's
    group: its first rank decides and broadcasts the decision (and,
    under the measured tier, first the candidates, which every rank then
    times together, since a sharded candidate's joins need them all).
    A rank-dependent pick would leave ranks waiting in collectives the
    others never issue.  Every rank keeps what the group agreed on for
    the tuner's mode, and reports it in ``tuning.explain``."""
    kw = dict(options=options, backends=backends, fixed=fixed, tune=tune)
    axes = () if policy is None else policy.group_axes()
    if policy is None or policy.mesh.axis_size(axes) == 1:
        return tuning.decide(key, measure=measure, **kw)
    mesh = policy.mesh
    memo = (key, axes, tuple(options.items()), tuple(backends), fixed,
            tuning.mode_key(tune))
    hit = mesh.agreed.get(memo)
    if hit is not None:
        tuning.tuner().remember(key, hit)
        return hit

    def send(tag: int, decisions) -> None:
        mesh.broadcast_object((tag, decisions), axes, 0)

    if mesh.axis_index(axes) == 0:
        def measure_root(cands):
            send(1, cands)
            return measure(cands)

        decision = tuning.decide(key, measure=measure_root, **kw)
        send(0, [decision])
    else:
        while True:
            tag, ds = mesh.broadcast_object(None, axes, 0)
            if tag == 1:
                measure(ds)
                continue
            decision = ds[0]
            tuning.tuner().remember(key, decision)
            break
    mesh.agreed[memo] = decision
    return decision


def _execute_decision(decision, kind: str, operand: Tensor, params: dict,
                      iterations: int, policy: MeshPolicy | None = None
                      ) -> tuple[Tensor, Tensor]:
    """Run one solve the way a tuning Decision says to.

    The decision's (rounds, spec_k) always covers the budget; when it
    overshoots, ``iterations=`` makes the last round's walk partial, so
    the solve spends exactly the budget (and bypasses a whole-solve
    kernel, which walks whole rounds).  "single" under a policy with
    ``local_rows`` gathers the rows, solves them all on every rank and
    keeps this rank's.
    """
    iters_arg = (None if iterations == decision.rounds * decision.spec_k
                 else iterations)
    if decision.placement in ("vocab", "data") and policy is not None:
        out = _solve_kind_sharded(
            policy, kind, operand, backend=decision.backend,
            rounds=decision.rounds, spec_k=decision.spec_k,
            iterations=iters_arg, placement=decision.placement, **params)
        if out is not None:
            return out
    gather = (policy is not None and policy.local_rows
              and policy.data_ways() > 1)
    if gather:
        axes = policy.row_axes()
        operand = policy.mesh.all_gather(operand, axes)
        params = {k: (policy.mesh.all_gather(p, axes)
                      if _row_param(p) else p) for k, p in params.items()}
    lo, hi = solve(problem(kind, operand, backend=decision.backend,
                           **params),
                   rounds=decision.rounds, spec_k=decision.spec_k,
                   iterations=iters_arg)
    if gather:
        spec = (policy.row_axes(),)
        lo, hi = (local_block(lo, spec, policy.mesh),
                  local_block(hi, spec, policy.mesh))
    return lo, hi


def _row_param(p) -> bool:
    """A (B,) per-row parameter: it shards with the rows."""
    return isinstance(p, torch.Tensor) and p.ndim == 1


def _solve_kind_sharded(
    policy: MeshPolicy,
    kind: str,
    operand: Tensor,
    *,
    backend: str,
    rounds: int,
    spec_k: int,
    iterations: int | None = None,
    placement: str = "vocab",
    **params,
):
    """The SPMD solve under a placement; None when the policy cannot shard
    anything (then the caller runs "single").

    The rows shard over the policy's data axes (dropped when they do not
    divide), the reduction dim over ``vocab_axis`` (likewise, and only
    under "vocab").  With the vocab sharded each rank runs the
    _SHARDED_REGISTRY factory on its (B/d, V/m) block: local partial
    reductions, one join a round.  With the vocab whole the plain factory
    runs on the rank's rows, whole-solve kernels included.  Per-row (B,)
    parameters shard with the rows; Python scalars are the same on every
    rank.  Without ``local_rows`` the brackets come back whole through an
    all-gather over the data axes.
    """
    mesh = policy.mesh
    b, v = operand.shape
    va = policy.vocab_axis if placement == "vocab" else None
    if va is not None and (va not in mesh.axis_names
                           or mesh.shape[va] <= 1 or v % mesh.shape[va]):
        va = None
    data = policy.row_axes()
    dw = mesh.axis_size(data)
    rows = b * dw if policy.local_rows else b
    if dw <= 1 or rows % dw:
        data = ()
    if va is None and not data:
        return None

    cut = bool(data) and not policy.local_rows
    spec = (data,)
    if cut:
        operand = local_block(operand, spec, mesh)
        params = {k: (local_block(p, spec, mesh) if _row_param(p) else p)
                  for k, p in params.items()}
    module = _LAZY_BACKEND_MODULES.get(backend)
    if module is not None:
        importlib.import_module(module)
    if va is None:
        lo, hi = solve(_REGISTRY[(kind, backend)](operand, **params),
                       rounds=rounds, spec_k=spec_k, iterations=iterations)
    else:
        try:
            factory = _SHARDED_REGISTRY[(kind, backend)]
        except KeyError:
            raise KeyError(
                f"no SHARDED solver backend {backend!r} for kind {kind!r}; "
                f"registered: {sorted(_SHARDED_REGISTRY)}") from None
        local = local_block(operand, (None, va), mesh)
        prob = factory(local, join=VocabJoin(mesh, va), global_v=v,
                       **params)
        lo, hi = _solve_rounds(
            prob.multi_eval, prob.lo0, prob.hi0, rounds=rounds,
            spec_k=spec_k, sign_lo=prob.sign_lo, sign_bit=prob.sign_bit,
            iterations=iterations)
    if cut:
        lo, hi = mesh.all_gather(lo, data), mesh.all_gather(hi, data)
    return lo, hi


# kind -> (its target parameter, the value a measurement solves for at V)
_MEASURE_TARGETS = {
    "count_above": lambda v: ("k", max(1, v // 8)),
    "count_below": lambda v: ("q", 0.3),
    "mass_at_or_above": lambda v: ("p", 0.9),
    "entropy_at_temperature": lambda v: ("target", 2.0),
}


def _measure_candidates(key, candidates, statics: dict,
                        device: torch.device,
                        policy: MeshPolicy | None = None) -> list[dict]:
    """Time candidate Decisions on the live device: the tuner's measured
    tier.  A synthetic operand of the key's shape and dtype (seed 0, as
    the JAX package draws it) and the caller's static parameters; each
    candidate's whole solve timed by ``tuning.time_call`` (on the card a
    CUDA graph of solves between CUDA events, the median of 5; on the CPU
    ``perf_counter``, the median of 5).  A candidate that fails raises.
    The launches made here are not counted in ``ops.LAUNCHES``.

    Under a policy of more than one rank every rank of the group runs
    every candidate, in order (a sharded candidate's joins need them
    all), timed eagerly with a device sync at both ends (collectives do
    not go into a CUDA graph), and the group agrees on each time, its
    ranks' slowest; a sharded candidate's report carries its join term
    (``tuning.join_term_measured``) at one round's payload.
    """
    import numpy as np

    from repro_torch.kernels import ops

    tuning.check_not_capturing(f"solve candidates for {key.cache_key()}")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(key.batch, key.vocab)).astype(np.float32) * 2.0
    if key.kind == "mass_at_or_above":
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    x = torch.from_numpy(x).to(device=device,
                               dtype=getattr(torch, key.dtype))
    # the target the caller gave as a (B,) tensor (per-row targets, no
    # known sign at lo0, no whole-solve route) is a (B,) tensor here too
    params = dict(statics)
    name, value = _MEASURE_TARGETS[key.kind](key.vocab)
    if name not in params:
        params[name] = torch.full((key.batch,), value, device=device)
    axes = () if policy is None else policy.group_axes()
    meshed = policy is not None and policy.mesh.axis_size(axes) > 1
    if meshed and policy.local_rows:
        spec = (policy.row_axes(),)
        x = local_block(x, spec, policy.mesh)
        params = {k: (local_block(p, spec, policy.mesh) if _row_param(p)
                      else p) for k, p in params.items()}

    counted = dict(ops.LAUNCHES)
    try:
        reports = []
        for d in candidates:
            def run(d=d):
                return _execute_decision(d, key.kind, x, params,
                                         key.iterations, policy)
            if not meshed:
                reports.append({"seconds": tuning.time_call(run, device)})
                continue
            mesh = policy.mesh
            seconds = tuning.time_eager(run, device)
            seconds = float(mesh.all_reduce(
                torch.tensor([seconds], dtype=torch.float64,
                             device=mesh.device), axes, "max").item())
            report = {"seconds": seconds}
            if d.placement == "vocab":
                vw, dw = _placement_options(
                    policy, key.batch, key.vocab)["vocab"]
                m = (1 << d.spec_k) - 1
                report["join"] = tuning.join_term_measured(
                    mesh, policy.vocab_axis,
                    -(-key.batch // dw) * m * 4)
            reports.append(report)
        return reports
    finally:
        ops.LAUNCHES.update(counted)


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
        counts = (x[:, None, :] > taus[:, :, None]).sum(dim=-1,
                                                        dtype=torch.int32)
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
        below = (x[:, None, :] < cs[:, :, None]).sum(dim=-1,
                                                      dtype=torch.int32)
        return true_div(below.float(), n) - q_col

    # f(lo0) = 0/N - q: negative for any positive static q.
    sign_lo = _known_negative_sign_lo(
        x.shape[0], isinstance(q, float) and q > 0, x.device)
    return MonotoneProblem(multi_eval, lo0, hi0, sign_lo=sign_lo)


# ---------------------------------------------------------------------------
# "torch" vocab-sharded evaluators: run on each rank's vocab shard
# ---------------------------------------------------------------------------
#
# Each mirrors its oracle above on the LOCAL vocab shard: the reduction
# over the vocab becomes a local partial sum and one join over the vocab
# group (``VocabJoin``), and the bracket init joins with MIN and MAX so
# every rank agrees bit for bit.  Count partials are small integers, so
# the count kinds stay bit for bit equal to the unsharded oracle; mass and
# entropy joins reassociate float sums, which can only flip a walk
# decision when f sits within rounding of zero at a candidate.

@register_sharded("count_above", "torch")
def _count_above_torch_sharded(local: Tensor, *, join: VocabJoin,
                               global_v: int, k) -> MonotoneProblem:
    x = local.float()
    lo0 = join.min(x.amin(dim=-1)) - 1.0
    hi0 = join.max(x.amax(dim=-1)) + 1.0
    k_col = _param_col(k, x.device)

    def multi_eval(taus: Tensor) -> Tensor:
        counts = (x[:, None, :] > taus[:, :, None]).sum(dim=-1,
                                                        dtype=torch.int32)
        return k_col - join.sum(counts.float())

    sign_lo = _known_negative_sign_lo(
        x.shape[0], isinstance(k, int) and k < global_v, x.device)
    return MonotoneProblem(multi_eval, lo0, hi0, sign_lo=sign_lo)


@register_sharded("mass_at_or_above", "torch")
def _mass_torch_sharded(local: Tensor, *, join: VocabJoin, global_v: int,
                        p) -> MonotoneProblem:
    probs = local
    lo0 = torch.zeros(probs.shape[:-1], dtype=probs.dtype, device=probs.device)
    hi0 = join.max(probs.amax(dim=-1)) + 1e-6
    p_col = _param_col(p, probs.device, probs.dtype)

    def multi_eval(taus: Tensor) -> Tensor:
        keep = probs[:, None, :] >= taus[:, :, None]
        mass = torch.where(keep, probs[:, None, :], 0.0).sum(dim=-1)
        return p_col - join.sum(mass)

    return MonotoneProblem(multi_eval, lo0, hi0)


@register_sharded("entropy_at_temperature", "torch")
def _entropy_torch_sharded(local: Tensor, *, join: VocabJoin, global_v: int,
                           target, t_lo: float = 0.05, t_hi: float = 20.0
                           ) -> MonotoneProblem:
    z = local.float()
    batch = z.shape[0]
    lo0 = torch.full((batch,), t_lo, dtype=torch.float32, device=z.device)
    hi0 = torch.full((batch,), t_hi, dtype=torch.float32, device=z.device)
    target_col = _param_col(target, z.device)

    def multi_eval(ts: Tensor) -> Tensor:
        zt = z[:, None, :] / ts[:, :, None]                 # (B, M, V/m)
        m = join.max(zt.amax(dim=-1))                       # (B, M) global
        se = join.sum(torch.exp(zt - m[..., None]).sum(dim=-1))
        logp = zt - (m + torch.log(se))[..., None]
        h = -join.sum((torch.exp(logp) * logp).sum(dim=-1))
        return target_col - h

    return MonotoneProblem(multi_eval, lo0, hi0)


@register_sharded("count_below", "torch")
def _count_below_torch_sharded(local: Tensor, *, join: VocabJoin,
                               global_v: int, q) -> MonotoneProblem:
    x = local.float()
    lo0 = join.min(x.amin(dim=-1)) - 1.0
    hi0 = join.max(x.amax(dim=-1)) + 1.0
    q_col = _param_col(q, x.device)

    def multi_eval(cs: Tensor) -> Tensor:
        below = (x[:, None, :] < cs[:, :, None]).sum(dim=-1,
                                                      dtype=torch.int32)
        return true_div(join.sum(below.float()), global_v) - q_col

    sign_lo = _known_negative_sign_lo(
        x.shape[0], isinstance(q, float) and q > 0, x.device)
    return MonotoneProblem(multi_eval, lo0, hi0, sign_lo=sign_lo)
