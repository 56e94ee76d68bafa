"""Cost-model-driven solver autotuning (port of ``repro.core.tuning``).

Every knob of a solve is a *decision*, taken per static configuration:

  key = (kind, B, V, dtype, backend-preference, device_count, device_kind,
         iterations)

Two tiers, as in the JAX package:

  1. **Analytic cost model** (always on): per round, the evaluator's
     roofline time ``max(operations / peak, bytes / bandwidth)`` plus the
     backend's fixed cost a launch, the engine's fixed cost a round and
     its cost a walk step, minimised over ``spec_k`` under
     ``rounds * spec_k >= iterations`` (the caller's serial-step budget,
     which the tuner PRESERVES: that is what keeps every tuned solve bit
     for bit equal to the serial sign-bit walk).
  2. **Measured tier** (``tune=True``, :func:`autotune`, or
     ``REPRO_AUTOTUNE=1``): the top analytic candidates and the caller's
     fixed decision are timed on the live device (CUDA events around
     CUDA-graph replays on the card, ``perf_counter`` on the CPU; the
     median of 5) and the winner is kept in a schema-versioned JSON
     cache.

The kernel tier does the same for the geometry of the kernels K2-K6
(:class:`KernelKey` -> :class:`KernelDecision`), consulted by
``kernels/ops.py`` at each launch on the card: today's geometry unless
the cache holds a measured winner, every legal candidate timed under the
measured tier.

Without the measured tier, decisions still replay the winners a cache
holds (the default file, or the one ``REPRO_TORCH_TUNING_CACHE`` names);
a kernel geometry replayed from it changes the output bits of K4, K5 and
K6 within their tolerances.

Profiles.  ``PROFILES["cpu"]`` is the JAX package's CPU profile, with the
backend names ``jnp`` and ``pallas`` spelt ``torch`` and ``hopper``, so
that CPU decisions equal JAX's.  ``PROFILES["cuda"]`` is the H100's, with
each constant measured by ``chip_smoke.py`` phase 18 (its note gives the
card and the run).

Placements, under a mesh policy (``core/solver.py``): ``"single"``,
``"data"`` (rows over the data axes) and ``"vocab"`` (the reduction dim
over the vocab axis as well, one join a round), priced with the
(vocab_ways, data_ways) model of ``predict_cost``.  Where the JAX package
prices a sharded candidate's join from XLA's HLO (``join_term_from_hlo``),
the port times the collective itself on the live group
(:func:`join_term_measured`), and the measured tier times sharded
candidates on every rank of the group together (``core/solver.py``
decides on the group's first rank and broadcasts, so every rank takes
the same decision).  Unlike the JAX package, the port never swallows a
failure in the measured tier: candidates are filtered for legality
before they are timed, and a legal candidate that fails raises.  A
measurement callback that reports NaN for a candidate still drops it, as
in JAX.

Forcing and clearing decisions:

  * ``tuning.override(spec_k=3)``: force fields for enclosed solves;
  * ``tuning.disabled()`` or ``REPRO_DISABLE_TUNING=1``: pin the caller's
    fixed configuration and every kernel's fixed geometry;
  * ``tuning.clear_cache()``: drop in-memory and on-disk winners;
  * ``REPRO_TORCH_TUNING_CACHE=/path.json``: relocate the cache (the
    port's own file, never the JAX package's ``REPRO_TUNING_CACHE``).

Decisions are read when a solve or a launch runs.  On the card a CUDA
graph is captured after its body ran once eagerly (``core/graphs.py``),
so every key is decided before a capture, and a measurement asked for
during a capture raises.  A graph keeps the decision it was captured
with, as a compiled JAX step keeps the one it traced with.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.kernels import blocks
from repro_torch.kernels import paged_attend as _pa
from repro_torch.kernels import row_reduce as _rr
from repro_torch.kernels import runahead_threshold as _rt

SCHEMA_VERSION = 4
CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
DISABLE_ENV = "REPRO_DISABLE_TUNING"
AUTOTUNE_ENV = "REPRO_AUTOTUNE"
DEFAULT_CACHE = (Path(__file__).resolve().parents[3] / "build"
                 / "repro_torch" / "solver_tuning.json")

PLACEMENTS = ("single", "data", "vocab")

# Fixed host and sync cost of one decode step in units of one step's
# device time, as the JAX constant is; the JAX package's 4.3 was
# calibrated on a CPU box and is not the card's.  chip_smoke.py phase 14
# measures it on the continuous paged serve (qwen3-4b, 4 slots, graphed
# per-step decode) as (host ms per step - device ms per step) / device ms
# per step: host 13.706 ms and device 13.606 ms a step (the median of 8),
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit.  A graphed step is
# device-bound, so decide_step_horizon picks K = 1 for mean budgets under
# 140 tokens (K = 2 from 140, 4 at 1000).
DISPATCH_OVERHEAD = 0.0073

# Device ms of one graphed verify step of the continuous paged serve
# (qwen3-4b, 4 live slots, page 16, phase 9's sampler) at draft lengths
# L = 1, 2, 4, 8: chip_smoke.py phase 15's readings (the median of 9) on
# an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md, PR 21).  A
# verify step is priced from them as overhead + L rows
# (``verify_step_cost``: 0.600 ms a row beside 13.55 ms of overhead, 22.6
# rows), not as L serial steps; at the launcher's acceptance prior of 0.6
# that gives L = 5.
VERIFY_STEP_MS = {1: 13.916, 2: 14.896, 4: 16.130, 8: 18.250}


# ---------------------------------------------------------------------------
# decision + config key
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved solver configuration.

    ``rounds`` is always ``ceil(iterations / spec_k)`` for the caller's
    budget; the engine runs a partial walk in the last round when the
    budget does not divide.  ``draft_len`` and ``step_horizon`` are the
    serving knobs that ``decide_draft_len`` and ``decide_step_horizon``
    price; the solver tier carries them at 1.
    """

    spec_k: int
    rounds: int
    placement: str
    backend: str
    source: str = "model"       # model | measured | cache | fixed | override
    draft_len: int = 1
    step_horizon: int = 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "Decision":
        return Decision(
            spec_k=int(d["spec_k"]), rounds=int(d["rounds"]),
            placement=str(d["placement"]), backend=str(d["backend"]),
            source=str(d.get("source", "cache")),
            draft_len=int(d.get("draft_len", 1)),
            step_horizon=int(d.get("step_horizon", 1)),
        )


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    """The static configuration a decision is keyed by.

    ``dtype`` is spelt as JAX spells it (``float32``, ``bfloat16``).
    ``device_kind`` is ``"cpu"`` or the CUDA device's name, so that a
    winner measured on one card never steers another.  ``fused`` marks a
    ``count_above`` solve with a static target on the ``"hopper"``
    backend, which takes K3's whole-solve kernel when the decision spends
    the budget in whole rounds; it adds ``|fused`` to the cache key and
    nothing else.
    """

    kind: str
    batch: int
    vocab: int
    dtype: str
    backend_pref: str
    device_count: int
    device_kind: str
    iterations: int
    page_size: int = 0
    step_horizon: int = 0
    fused: bool = False

    def cache_key(self) -> str:
        key = "|".join((
            self.kind, f"B={self.batch}", f"V={self.vocab}", self.dtype,
            f"pref={self.backend_pref}", f"D={self.device_count}",
            self.device_kind or "cpu", f"iters={self.iterations}",
            f"page={self.page_size}", f"hz={self.step_horizon}",
        ))
        return key + "|fused" if self.fused else key


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``float32``: the JAX package's spelling."""
    return str(dtype).removeprefix("torch.")


@functools.cache
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_platform(device=None) -> tuple[str, str]:
    """(platform, device model string): ``("cuda", name)`` for a CUDA
    device, ``("cpu", "")`` for the CPU.  ``device`` None is device 0
    where torch sees a card, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", _cuda_name(device.index or 0)
    return "cpu", ""


def device_kind(device=None) -> str:
    """A key's ``device_kind``: ``"cpu"``, or the CUDA device's name."""
    platform, name = device_platform(device)
    return name if platform == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# tier 1: the analytic cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-substrate constants of the analytic model.

    The JAX package's fields (``flops`` ... ``vmem_bytes``) keep their
    meaning: per round, ``max(flops / peak, bytes / mem_bw)`` of the
    evaluator over the (B, M, V) candidate grid, of which
    ``broadcast_spill`` is written to memory, plus ``backend_overhead``
    and ``dispatch``.  The Hopper profile adds what the card's solves
    cost beyond that (each zero on the CPU, which keeps its decisions
    JAX's):

      walk_step       the engine's small kernels per walk step and tree
                      level, so a round costs ``spec_k`` of them;
      kind_flops      operations a (v, m) pair costs each kind, in units
                      of ``flops`` (the JAX table where a kind is absent);
      backend_spill   ``broadcast_spill`` per backend (the "torch"
                      oracle materialises its compare grid, the kernels
                      stream it);
      fused           per backend, (launch, per round, per round and
                      grid point) seconds of a whole-solve kernel (K3:
                      its CTAs count and exchange 2**spec_k bins a
                      round).
    """

    flops: float
    mem_bw: float
    join_alpha: float
    link_bw: float
    dispatch: float
    broadcast_spill: float
    backend_overhead: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    vmem_bytes: int = 16 * 1024 * 1024
    walk_step: float = 0.0
    kind_flops: Mapping[str, float] = dataclasses.field(default_factory=dict)
    backend_spill: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    fused: Mapping[str, tuple[float, float, float]] = dataclasses.field(
        default_factory=dict)


PROFILES: dict[str, HardwareProfile] = {
    # the JAX package's CPU profile, verbatim: host-platform "devices" are
    # threads of one socket, and the kernel backend runs interpreted (a
    # large fixed cost a call)
    "cpu": HardwareProfile(
        flops=8e9, mem_bw=12e9, join_alpha=350e-6, link_bw=2e9,
        dispatch=30e-6, broadcast_spill=1.0,
        backend_overhead={"torch": 0.0, "hopper": 400e-6},
        vmem_bytes=128 * 1024 * 1024,
    ),
    # NVIDIA H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s
    # of HBM, 227 KB of shared memory a block (the roofline of
    # PERF.md's kernel table).  The rest is chip_smoke.py phase 18's least-
    # squares fit at the served shape (B = 4, V = 151936, a budget of 40
    # steps) on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md,
    # PR 21): K2, K4 and K5 at M = 2**k - 1 candidates (the launch, and
    # each kind's operations a pair), graphed solves at every spec_k (the
    # engine's cost a round and a tree level and walk step), K3's whole
    # solve at the budget's divisors.  The "torch" oracle is never a
    # candidate on the card, and its cost there is not measured: a caller
    # that pins it gets its compare grid's spill (1.0, as on the CPU).
    # The join (the vocab placement's all-reduce a round) is phase 26's
    # fit of alpha * log2(ranks) + bytes / link_bw to f32 all-reduces of
    # 4 B to 1 MB over 2 and 4 ranks sharing one card through gloo over
    # CUDA tensors (each staged through the host), on an NVIDIA H100 80GB
    # HBM3 at a 700 W power limit (PERF.md, PR 25).  NCCL between GPUs is
    # not measured: these price the one-card mesh, where a join's
    # milliseconds keep every solve off the vocab placement.
    "cuda": HardwareProfile(
        flops=67e12, mem_bw=3.35e12, join_alpha=2050.25e-6, link_bw=1.828e8,
        dispatch=14.00e-6, broadcast_spill=0.0,
        backend_overhead={"hopper": 6.00e-6},
        vmem_bytes=227 * 1024,
        walk_step=15.59e-6,
        kind_flops={"count_above": 7.50, "count_below": 7.50,
                    "mass_at_or_above": 11.25,
                    "entropy_at_temperature": 24.61},
        backend_spill={"torch": 1.0},
        fused={"hopper": (30.07e-6, 2.10e-6, 32.9e-9)},
    ),
}

# Rough per-element evaluator cost in flops: count kinds are a compare +
# accumulate; entropy pays exp/log per element.
_KIND_FLOPS = {
    "count_above": 2.0,
    "count_below": 2.0,
    "mass_at_or_above": 3.0,
    "entropy_at_temperature": 12.0,
}


def profile_for(device_kind: str) -> HardwareProfile:
    """The profile of a key's ``device_kind``: a profile's own name
    (``"cpu"``, ``"cuda"``), else the CPU's for ``"cpu"`` or an empty
    string and the Hopper profile for any CUDA device's name."""
    if device_kind in PROFILES:
        return PROFILES[device_kind]
    return PROFILES["cpu" if device_kind in ("", "cpu") else "cuda"]


def predict_cost(
    key: ConfigKey,
    decision: Decision,
    ways: tuple[int, int],
    profile: HardwareProfile | None = None,
) -> float:
    """Predicted whole-solve seconds for `decision` under `key`.

    ways = (vocab_ways, data_ways) for the decision's placement.
    """
    profile = profile or profile_for(key.device_kind)
    vw, dw = ways
    m = (1 << decision.spec_k) - 1
    bloc = -(-key.batch // dw)
    vloc = -(-key.vocab // vw)
    fused = profile.fused.get(decision.backend)
    # K3's whole solve needs whole rows: never under a vocab split
    if (key.fused and fused is not None and vw == 1
            and decision.rounds * decision.spec_k == key.iterations):
        # the whole solve in one launch: a fixed cost, and a cost a round
        # that grows with the 2**spec_k bins its CTAs count and exchange
        launch, per_round, per_point = fused
        points = 1 << decision.spec_k
        return launch + decision.rounds * (per_round + per_point * points)
    itemsize = 2 if key.dtype in ("bfloat16", "float16") else 4
    elems = float(bloc) * vloc * m
    flops = elems * profile.kind_flops.get(key.kind,
                                           _KIND_FLOPS.get(key.kind, 4.0))
    spill = profile.backend_spill.get(decision.backend,
                                      profile.broadcast_spill)
    byts = float(bloc) * vloc * itemsize * (1.0 + spill * m)
    t_eval = max(flops / profile.flops, byts / profile.mem_bw)
    t_eval += profile.backend_overhead.get(decision.backend, 0.0)
    t_eval += profile.walk_step * decision.spec_k
    t_join = 0.0
    if vw > 1:
        payload = float(bloc) * m * 4 * vw
        t_join = profile.join_alpha * math.log2(vw) + payload / profile.link_bw
    return decision.rounds * (t_eval + t_join + profile.dispatch)


def decide_draft_len(
    *,
    acceptance: float,
    token_cost: float = 1.0,
    overhead: float | None = None,
    max_draft_len: int = 8,
) -> int:
    """Pick the serving speculation depth from observed acceptance.

    A verify step over L grid rows costs ``overhead + L * token_cost``
    (dispatch plus per-row forward work) and emits ``E(L) = (1 - a^L) /
    (1 - a)`` tokens in expectation when each drafted token survives with
    probability ``a`` (one guaranteed correction or bonus token plus a
    geometric run of accepted drafts).  Returns the L in [1,
    max_draft_len] maximising expected tokens per unit cost; ``a = 0``
    prices every draft as rejected work and returns 1.  ``overhead`` and
    ``token_cost`` share a unit; the default overhead is
    ``DISPATCH_OVERHEAD`` token costs.  On the card pass the verify
    step's own price, ``verify_step_cost()``.
    """
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    if max_draft_len < 1:
        raise ValueError(f"max_draft_len must be >= 1, got {max_draft_len}")
    if overhead is None:
        overhead = DISPATCH_OVERHEAD * token_cost
    a = min(acceptance, 1.0 - 1e-9)
    best_l, best_rate = 1, 0.0
    for length in range(1, max_draft_len + 1):
        expected = (1.0 - a ** length) / (1.0 - a)
        rate = expected / (overhead + length * token_cost)
        if rate > best_rate * (1.0 + 1e-12):
            best_l, best_rate = length, rate
    return best_l


def verify_step_cost(step_ms: Mapping[int, float] = VERIFY_STEP_MS
                     ) -> tuple[float, float]:
    """(token_cost, overhead) of a verify step, in ms: the least-squares
    line ``overhead + L * token_cost`` through measured device ms of one
    verify step at several L (default: ``VERIFY_STEP_MS``, the card's).
    The pair is what ``decide_draft_len`` takes."""
    ls = sorted(step_ms)
    if len(ls) < 2:
        raise ValueError("a line needs verify-step times at two L at least")
    mean_l = sum(ls) / len(ls)
    mean_t = sum(step_ms[L] for L in ls) / len(ls)
    slope = (sum((L - mean_l) * (step_ms[L] - mean_t) for L in ls)
             / sum((L - mean_l) ** 2 for L in ls))
    if slope <= 0:
        raise ValueError(f"verify steps do not grow with L: {dict(step_ms)}")
    return slope, mean_t - slope * mean_l


def decide_step_horizon(
    *,
    mean_remaining: float,
    token_cost: float = 1.0,
    overhead: float | None = None,
    load: float = 1.0,
    max_horizon: int = 64,
) -> int:
    """Pick K, the decode steps fused per serving dispatch.

    Fusing K steps divides the fixed per-step cost (``overhead``, in
    ``token_cost`` units) by K, but a request finishing mid-horizon rides
    frozen until the boundary, wasting ``(K - 1) / 2`` slot-iterations in
    expectation.  Against a mean per-request budget of ``mean_remaining``
    device iterations the useful fraction of slot work is
    ``m / (m + load * (K - 1) / 2)`` (``load``: 1.0 when a queue waits for
    every freed slot, 0.0 when slots would idle anyway), and the cost of
    an iteration ``token_cost + overhead / K``; K maximises their ratio,
    ties broken toward the smaller K (a queued request waits up to K
    iterations for a boundary).
    """
    if mean_remaining < 1:
        raise ValueError(
            f"mean_remaining must be >= 1, got {mean_remaining}")
    if max_horizon < 1:
        raise ValueError(f"max_horizon must be >= 1, got {max_horizon}")
    if not 0.0 <= load <= 1.0:
        raise ValueError(f"load must be in [0, 1], got {load}")
    if overhead is None:
        overhead = DISPATCH_OVERHEAD * token_cost
    best_k, best_rate = 1, 0.0
    for k in range(1, max_horizon + 1):
        idle = load * (k - 1) / 2.0
        useful = mean_remaining / (mean_remaining + idle)
        rate = useful / (token_cost + overhead / k)
        if rate > best_rate * (1.0 + 1e-12):
            best_k, best_rate = k, rate
    return best_k


def decide_page_size(
    *,
    context: int,
    shared_prefix_len: int = 0,
    candidates: Sequence[int] = (4, 8, 16, 32),
    table_overhead_rows: float = 1.0,
) -> int:
    """Pick the paged-KV page size for a deployment.

    Three costs, each in cache rows per request: fragmentation (the
    chain's tail page is half empty on average, ``page_size / 2``), lost
    sharing (only whole pages inside the common prompt prefix are shared,
    so ``shared_prefix_len % page_size`` rows are prefilled again per
    sibling) and table overhead (``table_overhead_rows`` per mapped
    page).  Ties pick the LARGER page (shorter chains).
    """
    if context < 1:
        raise ValueError(f"context must be >= 1, got {context}")
    if shared_prefix_len < 0:
        raise ValueError(
            f"shared_prefix_len must be >= 0, got {shared_prefix_len}")
    if not candidates:
        raise ValueError("candidates must be non-empty")

    def cost(p: int) -> float:
        return (p / 2.0
                + shared_prefix_len % p
                + table_overhead_rows * -(-context // p))

    return max(sorted(candidates), key=lambda p: (-cost(p), p))


def _candidates(
    key: ConfigKey,
    options: Mapping[str, tuple[int, int]],
    backends: Sequence[str],
    max_spec_k: int = 8,
) -> list[tuple[float, Decision]]:
    """All legal (predicted_cost, Decision) pairs, cheapest first."""
    profile = profile_for(key.device_kind)
    out = []
    for spec_k in range(1, min(max_spec_k, max(1, key.iterations)) + 1):
        rounds = -(-key.iterations // spec_k)
        for placement, ways in options.items():
            for backend in backends:
                d = Decision(spec_k=spec_k, rounds=rounds,
                             placement=placement, backend=backend)
                out.append((predict_cost(key, d, ways, profile), d))
    out.sort(key=lambda cd: cd[0])
    return out


@functools.lru_cache(maxsize=1024)
def _ranked_solves(key: ConfigKey, options: tuple, backends: tuple) -> tuple:
    """``_candidates`` once per key: every solve consults the tuner."""
    return tuple(_candidates(key, dict(options), backends))


# ---------------------------------------------------------------------------
# kernel tier: the geometry of K2-K6 on Hopper
# ---------------------------------------------------------------------------

# family -> its one geometry parameter (the kernel's launch argument)
KERNEL_PARAMS = {
    "multi_count": "nb",                 # K2: blocks per row
    "multi_mass": "nb",                  # K4
    "multi_entropy_moments": "nb",       # K5
    "runahead_topk": "clusters",         # K3: CTAs per row's cluster
    "paged_attend": "n_split",           # K6: runs of the page chain
}


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """The static configuration a kernel-geometry decision is keyed by.

    ``shape`` is the family's own signature tuple (see
    :func:`kernel_candidates`).  ``device_kind`` is the CUDA device's
    name: a geometry measured on one card never steers another, and the
    bits of K4, K5 and K6 (whose float sums follow the geometry) stay a
    function of the key and the cache, not of the card's SM count.
    """

    kernel: str
    shape: tuple[int, ...]
    dtype: str
    device_kind: str
    interpret: bool = False

    def cache_key(self) -> str:
        return "|".join((
            "kernel", self.kernel,
            "x".join(str(int(s)) for s in self.shape),
            self.dtype, self.device_kind or "cpu",
            "interp" if self.interpret else "compiled",
        ))


@dataclasses.dataclass(frozen=True)
class KernelDecision:
    """One resolved kernel geometry: a named parameter assignment.

    ``block`` is a sorted tuple of (param, value) pairs, hashable; read it
    as a dict via :attr:`params`.  Param names are the kernel launchers'
    own keywords (``nb``, ``clusters``, ``n_split``).
    """

    block: tuple[tuple[str, int], ...]
    source: str = "model"       # model | measured | cache | fixed

    @property
    def params(self) -> dict[str, int]:
        return dict(self.block)

    @staticmethod
    def make(params: Mapping[str, int],
             source: str = "model") -> "KernelDecision":
        return KernelDecision(
            block=tuple(sorted((str(k), int(v)) for k, v in params.items())),
            source=source)

    def to_json(self) -> dict:
        return {"block": dict(self.block), "source": self.source}

    @staticmethod
    def from_json(d: Mapping) -> "KernelDecision":
        return KernelDecision.make(dict(d["block"]),
                                   source=str(d.get("source", "cache")))

    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.block)


def kernel_candidates(key: KernelKey) -> list[KernelDecision]:
    """The geometries the kernel takes at the key's shape, each legal:
    today's first, then a fixed list of alternatives in ascending order.

    Key shapes per family:
      multi_count / multi_mass / multi_entropy_moments: (B, V, M)
      runahead_topk:  (B, V)
      paged_attend:   (B, n_kv, n_chain, page_size, L, R, head_dim)
    Unknown families (K1, K7) and shapes the kernel cannot take return
    [] (the caller's fixed geometry stands).

    The alternatives: blocks a row at 1/4, 1/2, 2 and 4 times today's
    (at most ``row_reduce.max_blocks``); K3's legal cluster sizes of 1 to
    16; K6's chain cut into 1 to 64 runs, none empty.  No model ranks
    them: the kernels' cost at the served shapes is a few microseconds
    of fixed cost per block (K2/K4/K5's ticket finish, K3's exchange of
    counts every round, K6's combine), which a roofline cannot order, and
    today's geometry (one wave over the card) is the analytic pick.  The
    measured tier times every candidate.
    """
    if key.kernel in ("multi_count", "multi_mass", "multi_entropy_moments"):
        B, V, M = key.shape
        top = _rr.max_blocks(V)
        base = _rr.blocks_per_row(B, V, _rr.CARD_SMS)
        values = [min(max(1, base * f // 4), top) for f in (1, 2, 8, 16)]
    elif key.kernel == "runahead_topk":
        B, V = key.shape
        values = [c for c in (1, 2, 4, 8, 16) if c in _rt.legal_clusters(V)]
        if not values:
            return []
        base = _rt.cluster_geometry(B, V)[0]
    elif key.kernel == "paged_attend":
        B, nkv, n_chain, P, L, R, D = key.shape
        itemsize = 2 if key.dtype in ("bfloat16", "float16") else 4
        if not blocks.fits_smem(_pa.smem_bytes(L, R, P, D, itemsize)):
            return []
        base = _pa.split_geometry(B, nkv, n_chain)[0]
        values = [_pa.split_runs(n_chain, n)[0]
                  for n in (1, 2, 4, 8, 16, 32, 64)]
    else:
        return []
    name = KERNEL_PARAMS[key.kernel]
    return [KernelDecision.make({name: v})
            for v in [base] + sorted(set(values) - {base})]


@functools.lru_cache(maxsize=1024)
def _kernel_geometries(key: KernelKey) -> tuple:
    """``kernel_candidates(key)`` once per key: launches consult the
    kernel tier on every eager call."""
    return tuple(kernel_candidates(key))


# ---------------------------------------------------------------------------
# measuring on the live device
# ---------------------------------------------------------------------------

def check_not_capturing(what: str) -> None:
    """Raise if the current CUDA stream is capturing a graph: a
    measurement there would be recorded into the caller's graph."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the tuner was asked to measure {what} during a CUDA-graph "
            "capture: run the body eagerly first (core/graphs.py does), so "
            "that every decision is taken before the capture")


def time_call(fn: Callable[[], object], device: torch.device,
              calls: int = 10, reps: int = 5) -> float:
    """Seconds of one ``fn()`` call: on the card, ``calls`` calls captured
    in one CUDA graph (after an eager warm-up call) and replayed ``reps``
    times between CUDA events, the median replay over ``calls``; on the
    CPU, a warm-up call and the median of ``reps`` ``perf_counter``
    timings."""
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3 / calls)
        del graph
        return statistics.median(times)


def time_eager(fn: Callable[[], object], device: torch.device,
               reps: int = 5) -> float:
    """Seconds of one eager ``fn()`` call, a device sync at both ends: a
    warm-up call, then the median of ``reps``.  For calls that issue
    collectives, which a CUDA graph cannot hold under gloo."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def join_term_measured(mesh, axis, payload_bytes: int, reps: int = 9
                       ) -> dict:
    """The join of a sharded solve round, timed on the live group: one
    f32 all-reduce of ``payload_bytes`` over ``axis``'s group, the
    median of ``reps`` after a warm-up, the group's slowest rank (every
    rank of the group must call).  The port's counterpart of JAX's
    ``join_term_from_hlo``, which reads the joins out of compiled HLO and
    prices them with the profile.  Leaves ``mesh.stats`` as it found it."""
    stats = dataclasses.replace(mesh.stats)
    n = max(1, int(payload_bytes) // 4)
    t = torch.zeros(n, dtype=torch.float32, device=mesh.device)
    seconds = time_eager(lambda: mesh.all_reduce(t, axis), mesh.device,
                         reps)
    seconds = float(mesh.all_reduce(
        torch.tensor([seconds], dtype=torch.float64, device=mesh.device),
        axis, "max").item())
    mesh.stats = stats
    return {"count": 1, "bytes": 4 * n, "seconds": seconds,
            "ranks": mesh.axis_size(axis)}


# ---------------------------------------------------------------------------
# state: thread-local modes + the persistent cache
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack(name: str) -> list:
    st = getattr(_tls, name, None)
    if st is None:
        st = []
        setattr(_tls, name, st)
    return st


@contextlib.contextmanager
def disabled():
    """Pin the caller's fixed configuration and every kernel's fixed
    geometry for enclosed solves and launches."""
    _stack("disabled").append(True)
    try:
        yield
    finally:
        _stack("disabled").pop()


@contextlib.contextmanager
def autotune(enabled: bool = True):
    """Enable the measured tier for enclosed solves and launches."""
    _stack("autotune").append(bool(enabled))
    try:
        yield
    finally:
        _stack("autotune").pop()


@contextlib.contextmanager
def override(
    *,
    spec_k: int | None = None,
    placement: str | None = None,
    backend: str | None = None,
):
    """Force decision fields for enclosed solves; None fields keep the
    tuner's choice.  ``rounds`` follows a forced ``spec_k``."""
    if placement is not None and placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    _stack("override").append(
        {"spec_k": spec_k, "placement": placement, "backend": backend})
    try:
        yield
    finally:
        _stack("override").pop()


def _is_disabled() -> bool:
    st = _stack("disabled")
    return bool(st and st[-1]) or bool(os.environ.get(DISABLE_ENV))


def _autotune_active(tune: bool | None) -> bool:
    if tune is not None:
        return bool(tune)
    st = _stack("autotune")
    if st:
        return bool(st[-1])
    return bool(os.environ.get(AUTOTUNE_ENV))


def _active_override() -> dict | None:
    st = _stack("override")
    return st[-1] if st else None


def mode_key(tune: bool | None = None) -> tuple:
    """What a decision depends on besides its key and the caller's sets:
    the modes in force and the store's generation (bumped when the cache
    is cleared or moved)."""
    ov = _active_override()
    return (_is_disabled(), _autotune_active(tune),
            None if ov is None else tuple(sorted(ov.items())),
            _TUNER.generation)


def _finite_positive(t) -> bool:
    return t == t and t > 0           # drops NaN (a dropped candidate)


class Tuner:
    """Decision store: in-memory + schema-versioned JSON persistence."""

    def __init__(self, cache_path: str | None = None):
        self._lock = threading.Lock()
        self._path = cache_path
        self._entries: dict[str, dict] = {}
        self._kernels: dict[str, dict] = {}
        self._loaded = False
        self.recent: dict[str, Decision] = {}   # last decisions, for logs
        self.recent_kernels: dict[str, KernelDecision] = {}
        self.generation = 0                     # bumped on clear / move

    # -- persistence --------------------------------------------------------

    def cache_path(self) -> str:
        if self._path is None:
            self._path = os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE)
        return self._path

    def set_cache_path(self, path: str | None):
        with self._lock:
            self.generation += 1
            self._path = path
            self._entries = {}
            self._kernels = {}
            self._loaded = False

    def _load_locked(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.cache_path()) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        # another schema: ignored wholesale, a bad entry must never steer
        # a solve or a launch
        if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
            return
        for name, store in (("entries", self._entries),
                            ("kernels", self._kernels)):
            if isinstance(data.get(name), dict):
                store.update(data[name])

    def _save_locked(self):
        path = self.cache_path()
        payload = {"schema": SCHEMA_VERSION, "entries": self._entries,
                   "kernels": self._kernels}
        d = os.path.dirname(path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass      # persistence is best-effort; decisions still served

    def clear_cache(self):
        """Drop every winner, in memory and on disk.  A CUDA graph
        captured before keeps the decisions it was captured with."""
        with self._lock:
            self.generation += 1
            self._entries = {}
            self._kernels = {}
            self._loaded = True
            try:
                os.unlink(self.cache_path())
            except OSError:
                pass

    # -- the decision procedure --------------------------------------------

    def decide(
        self,
        key: ConfigKey,
        *,
        options: Mapping[str, tuple[int, int]],
        backends: Sequence[str],
        fixed: Decision,
        measure: Callable[[Sequence[Decision]], Sequence[dict]] | None
            = None,
        tune: bool | None = None,
    ) -> Decision:
        """Resolve the Decision for `key`.

        options: legal placements -> (vocab_ways, data_ways); must contain
        "single".  backends: the candidates ("auto" expands upstream).
        fixed: the caller's configuration, returned when tuning is
        disabled and always in the measured candidate set.  measure: times
        candidate Decisions, one ``{"seconds": s}`` report each.
        """
        if _is_disabled():
            decision = dataclasses.replace(fixed, source="fixed")
            self.recent[key.cache_key()] = decision
            return decision

        ov = _active_override()
        decision = self._decide_inner(key, options, backends, fixed,
                                      measure, tune)
        if ov is not None:
            fields = {k: v for k, v in ov.items() if v is not None}
            if "spec_k" in fields:
                fields["rounds"] = -(-key.iterations // fields["spec_k"])
            decision = dataclasses.replace(
                decision, source="override", **fields)
        self.remember(key, decision)
        return decision

    def remember(self, key: ConfigKey, decision: Decision) -> None:
        """Record a decision for ``explain`` (also one another rank of a
        mesh group took and broadcast)."""
        self.recent[key.cache_key()] = decision
        if len(self.recent) > 256:
            self.recent.pop(next(iter(self.recent)))

    def _decide_inner(self, key, options, backends, fixed, measure, tune):
        with self._lock:
            self._load_locked()
            hit = self._entries.get(key.cache_key())
        if hit is not None:
            try:
                d = Decision.from_json(hit["decision"])
            except (KeyError, TypeError, ValueError):
                d = None
            # a replay must still be legal: the placement and backend in
            # the caller's sets, every budget knob a sane positive value,
            # and the caller's budget covered by whole rounds
            if d is not None and d.placement in options \
                    and d.backend in backends \
                    and d.spec_k >= 1 and d.rounds >= 1 \
                    and d.draft_len >= 1 and d.step_horizon >= 1 \
                    and d.rounds == -(-key.iterations // d.spec_k):
                return dataclasses.replace(d, source="cache")

        ranked = _ranked_solves(key, tuple(options.items()), tuple(backends))
        best = ranked[0][1] if ranked else fixed

        if measure is not None and _autotune_active(tune):
            cand = [d for _, d in ranked[:3]]
            for extra in (
                # never-worse-than-single-device baseline + the fixed one
                dataclasses.replace(fixed, placement="single"),
                fixed,
            ):
                if extra.placement in options and extra.backend in backends \
                        and extra not in cand:
                    cand.append(extra)
            reports = list(measure(cand))
            if len(reports) != len(cand):
                raise RuntimeError(f"measured {len(reports)} reports for "
                                   f"{len(cand)} candidates")
            pairs = [(r["seconds"], d) for r, d in zip(reports, cand)
                     if _finite_positive(r["seconds"])]
            if pairs:
                _, d_best = min(pairs, key=lambda p: p[0])
                d_best = dataclasses.replace(d_best, source="measured")
                def label(d):
                    return f"{d.placement}/{d.backend}/k{d.spec_k}"

                entry = {
                    "decision": d_best.to_json(),
                    "measured_us": {label(d): round(r["seconds"] * 1e6, 1)
                                    for r, d in zip(reports, cand)},
                }
                joins = {label(d): r["join"] for r, d in zip(reports, cand)
                         if r.get("join")}
                if joins:
                    # sharded candidates' join, timed on the live group
                    entry["join_measured"] = joins
                with self._lock:
                    self._entries[key.cache_key()] = entry
                    self._save_locked()
                return d_best
        return dataclasses.replace(best, source="model")

    # -- the kernel-geometry decision procedure ----------------------------

    def decide_kernel(
        self,
        key: KernelKey,
        *,
        fixed: Mapping[str, int],
        measure: Callable[[Sequence[Mapping[str, int]]], Sequence[float]]
            | None = None,
        tune: bool | None = None,
    ) -> KernelDecision:
        """Resolve the geometry for `key`.

        fixed: today's geometry (e.g. ``{"nb": 33}``), returned when
        tuning is disabled and always in the measured candidate set.
        measure: times candidate param dicts (seconds each, NaN drops a
        candidate).  Mirrors :meth:`decide`: disabled -> fixed, cache hit
        -> legality-checked replay, analytic -> today's geometry (see
        :func:`kernel_candidates`), measured -> every candidate and fixed
        timed, the winner persisted under the cache's "kernels" section.
        """
        ck = key.cache_key()

        def _remember(d: KernelDecision) -> KernelDecision:
            self.recent_kernels[ck] = d
            if len(self.recent_kernels) > 256:
                self.recent_kernels.pop(next(iter(self.recent_kernels)))
            return d

        if _is_disabled():
            return _remember(KernelDecision.make(fixed, source="fixed"))

        geometries = _kernel_geometries(key)
        with self._lock:
            self._load_locked()
            hit = self._kernels.get(ck)
        if hit is not None:
            try:
                d = KernelDecision.from_json(hit["decision"])
            except (KeyError, TypeError, ValueError):
                d = None
            # replay legality: exactly the params this kernel takes, and
            # a geometry the kernel accepts at this shape (one of its
            # candidates, or today's)
            legal = {c.block for c in geometries}
            legal.add(KernelDecision.make(fixed).block)
            if d is not None and set(d.params) == set(fixed) \
                    and d.block in legal:
                return _remember(dataclasses.replace(d, source="cache"))

        best = (geometries[0] if geometries
                else KernelDecision.make(fixed, source="model"))

        if measure is not None and _autotune_active(tune):
            cand = list(geometries)
            fx = KernelDecision.make(fixed, source="fixed")
            if all(c.block != fx.block for c in cand):
                cand.append(fx)
            times = list(measure([c.params for c in cand]))
            if len(times) != len(cand):
                raise RuntimeError(f"measured {len(times)} times for "
                                   f"{len(cand)} candidates")
            pairs = [(t, c) for t, c in zip(times, cand)
                     if _finite_positive(t)]
            if pairs:
                _, d_best = min(pairs, key=lambda p: p[0])
                d_best = dataclasses.replace(d_best, source="measured")
                entry = {
                    "decision": d_best.to_json(),
                    "measured_us": {
                        c.label(): round(t * 1e6, 2)
                        for t, c in zip(times, cand) if t == t
                    },
                }
                with self._lock:
                    self._kernels[ck] = entry
                    self._save_locked()
                return _remember(d_best)
        return _remember(dataclasses.replace(best, source="model"))


# module-level singleton ------------------------------------------------------

_TUNER = Tuner()


def tuner() -> Tuner:
    return _TUNER


def decide(key: ConfigKey, **kw) -> Decision:
    return _TUNER.decide(key, **kw)


def decide_kernel(key: KernelKey, **kw) -> KernelDecision:
    return _TUNER.decide_kernel(key, **kw)


def clear_cache():
    """Drop every winner, in memory and on disk.  A CUDA graph captured
    before keeps the decisions it was captured with, as a compiled JAX
    step keeps the ones it traced with."""
    _TUNER.clear_cache()


def set_cache_path(path: str | None):
    _TUNER.set_cache_path(path)


def cache_path() -> str:
    return _TUNER.cache_path()


def explain() -> list[tuple[str, Decision]]:
    """Recent (config key, decision) pairs: what the tuner chose and
    which tier chose it (``source``)."""
    return list(_TUNER.recent.items())


def explain_kernels() -> list[tuple[str, KernelDecision]]:
    """Recent (kernel key, geometry decision) pairs."""
    return list(_TUNER.recent_kernels.items())
