"""Horizon and speculation-depth sizing for serving (port of
``decide_step_horizon`` and ``decide_draft_len`` of ``repro.core.tuning``;
the rest of that module is not ported yet).

``DISPATCH_OVERHEAD`` is the fixed host and sync cost of one decode step
in units of one step's device time, as the JAX constant is; the JAX
package's 4.3 was calibrated on a CPU box and is not the card's.  The
port's value is the card's own: ``chip_smoke.py`` phase 14 measures it on
the continuous paged serve (qwen3-4b, 4 slots, graphed per-step decode)
as (host ms per step - device ms per step) / device ms per step and
prints it.  The value below: host 13.706 ms and device 13.606 ms a step
(the median of 8), on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
A graphed step is device-bound, so the cost model picks K = 1 for mean
budgets under 140 tokens (K = 2 from 140, 4 at 1000).  Priced with the
same constant, ``decide_draft_len`` picks L = 1 at the launcher's prior
acceptance of 0.6 (a verify step is priced ``overhead + L`` steps);
``chip_smoke.py`` phase 15 measures what an L-row verify step costs the
card.
"""
from __future__ import annotations

DISPATCH_OVERHEAD = 0.0073


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
    ``DISPATCH_OVERHEAD`` token costs.
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


def decide_step_horizon(
    *,
    mean_remaining: float,
    token_cost: float = 1.0,
    overhead: float | None = None,
    load: float = 1.0,
    max_horizon: int = 64,
) -> int:
    """Pick K, the decode steps fused per serving dispatch (DESIGN.md §14).

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
