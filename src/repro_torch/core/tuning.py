"""Horizon sizing for fused decode (port of ``decide_step_horizon`` of
``repro.core.tuning``; the rest of that module is not ported yet).

``DISPATCH_OVERHEAD`` is the fixed host and sync cost of one decode step
in units of one step's device time, as the JAX constant is; the JAX
package's 4.3 was calibrated on a CPU box and is not the card's.  The
port's value is the card's own: ``chip_smoke.py`` phase 14 measures it on
the continuous paged serve (qwen3-4b, 4 slots, graphed per-step decode)
as (host ms per step - device ms per step) / device ms per step and
prints it.  The value below: host 13.706 ms and device 13.606 ms a step
(the median of 8), on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
A graphed step is device-bound, so the cost model picks K = 1 for mean
budgets under 140 tokens (K = 2 from 140, 4 at 1000).
"""
from __future__ import annotations

DISPATCH_OVERHEAD = 0.0073


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
