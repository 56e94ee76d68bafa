"""The paper's Table 1 experiment: serial against runahead bisection of
f(x) = sin(cos(x)) by Taylor series on the interval (1, 2) (port of
``examples/paper_experiment.py`` and of the loops of
``benchmarks/fig4_thread_sweep.py`` and ``fig7_latency_gpu.py``).

  PYTHONPATH=src python -m repro_torch.launch.paper              # on the card
  PYTHONPATH=src python -m repro_torch.launch.paper --device cpu \
      --fig4-terms 200 --fig7-terms 10 100 --reps 1               # anywhere

Two sweeps:
  * Fig. 4, the thread sweep: terms 10**4 (the paper's), n = 24 serial
    iterations, speculation k = 1..5 (2**k - 1 helper evaluations per
    round, ceil(n / k) rounds);
  * Fig. 7, the function-latency sweep: n = 6, k = 3, terms 10, 100, 500
    and 5000.

Both solvers get the same evaluator, ``evaluator(terms)``: on the card the
hand-written kernel K1 (``ops.taylor_sincos_eval``), once per serial
iteration at one point and once per runahead round at its 2**k - 1
points; on the CPU the kernel's plain version.  Each solve is timed with
a device sync at both ends, the median of ``--reps`` runs after one
warm-up.  Every runahead root (``select="walk"``) must equal the serial
sign-bit root bit for bit, or the run raises.
"""
from __future__ import annotations

import argparse
import logging
import statistics
import time
from typing import Callable, NamedTuple

import torch

from repro_torch.core.bisect import find_root_serial
from repro_torch.core.paper_functions import PAPER_INTERVAL, PAPER_TERMS
from repro_torch.core.runahead import find_root_runahead
from repro_torch.kernels import ops
from repro_torch.launch.serve import resolve_device, sync

log = logging.getLogger("repro_torch.paper")

FIG4_N, FIG4_KS = 24, (1, 2, 3, 4, 5)
FIG7_N, FIG7_K, FIG7_TERMS = 6, 3, (10, 100, 500, 5000)


class Row(NamedTuple):
    fig: str
    terms: int
    n: int                   # serial iterations
    k: int                   # speculation depth
    serial_ms: float         # median time of one serial solve
    runahead_ms: float       # median time of one runahead solve
    root: float              # the (bit-equal) root of both solvers

    @property
    def speedup(self) -> float:
        return self.serial_ms / self.runahead_ms

    @property
    def rounds(self) -> int:
        return -(-self.n // self.k)


def evaluator(terms: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The paper's f through K1 (its plain version on the CPU), for
    points of any shape."""

    def f(x: torch.Tensor) -> torch.Tensor:
        return ops.taylor_sincos_eval(x.reshape(-1), terms=terms).reshape(
            x.shape)

    return f


def interval(device) -> tuple[torch.Tensor, torch.Tensor]:
    a, b = PAPER_INTERVAL
    return (torch.tensor(a, dtype=torch.float32, device=device),
            torch.tensor(b, dtype=torch.float32, device=device))


def _timed(solve: Callable[[], torch.Tensor], device, reps: int
           ) -> tuple[float, torch.Tensor]:
    """Median ms of one solve, a device sync at both ends; and its root."""
    root = solve()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        root = solve()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), root


def sweep(fig: str, terms: int, n: int, ks, device, reps: int) -> list[Row]:
    """Serial once, runahead at each k, on one evaluator."""
    f = evaluator(terms)
    a, b = interval(device)
    serial_ms, serial_root = _timed(
        lambda: find_root_serial(f, a, b, n, "signbit"), device, reps)
    rows = []
    for k in ks:
        ms, root = _timed(lambda: find_root_runahead(f, a, b, n, k), device,
                          reps)
        if not torch.equal(root, serial_root):
            raise RuntimeError(
                f"{fig} terms={terms} n={n} k={k}: runahead root "
                f"{root.item()!r} differs from serial {serial_root.item()!r}")
        rows.append(Row(fig, terms, n, k, serial_ms, ms, root.item()))
    return rows


def _log_rows(rows: list[Row]) -> None:
    r0 = rows[0]
    log.info("%s terms=%d n=%d: serial %.3f ms per solve", r0.fig, r0.terms,
             r0.n, r0.serial_ms)
    for r in rows:
        log.info("  k=%d (%2d threads, %2d rounds): runahead %.3f ms, "
                 "speed-up %.2fx (round-count ideal %.2fx), root %.9g",
                 r.k, 2 ** r.k - 1, r.rounds, r.runahead_ms, r.speedup,
                 r.n / r.rounds, r.root)


def main(argv=None) -> list[Row]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fig4-terms", type=int, default=PAPER_TERMS)
    ap.add_argument("--fig7-terms", type=int, nargs="+",
                    default=list(FIG7_TERMS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    rows = sweep("fig4", args.fig4_terms, FIG4_N, FIG4_KS, device, args.reps)
    _log_rows(rows)
    for terms in args.fig7_terms:
        fig7 = sweep("fig7", terms, FIG7_N, (FIG7_K,), device, args.reps)
        _log_rows(fig7)
        rows += fig7
    log.info("kernel launches: %s", dict(ops.LAUNCHES))
    return rows


if __name__ == "__main__":
    main()
