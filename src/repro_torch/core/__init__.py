"""Core: the paper's contribution, runahead (speculative) bisection (port
of ``repro.core``).

Public API, as the JAX package's:
  find_root_serial            Algorithm 1 baseline (paper §III.B)
  find_root_runahead          lane-level runahead bisection (paper §IV)
  runahead_solve              generic scalar interval solve (B=1 engine view)
  solver                      the batched runahead solve engine + backends
  applications                LM-stack monotone solves built on the engine
  tuning                      the solver and kernel tuner (analytic and
                              measured tiers)

Not ported yet, and so not exported: the mesh half of the engine
(``MeshPolicy``, ``mesh_policy``) and the chip-level sharded solve
(``find_root_runahead_sharded``).
"""
from repro_torch.core.bisect import (
    find_root_serial,
    find_root_serial_batched,
    iterations_for_error,
)
from repro_torch.core.runahead import (
    find_root_runahead,
    find_root_runahead_batched,
    runahead_solve,
    serial_equivalent_iterations,
)
from repro_torch.core.paper_functions import (
    make_paper_f,
    taylor_sin,
    taylor_cos,
    PAPER_INTERVAL,
    PAPER_TERMS,
    PAPER_EPS_CPU,
)
from repro_torch.core import applications, solver, tuning
from repro_torch.core.solver import MonotoneProblem

__all__ = [
    "tuning",
    "MonotoneProblem",
    "solver",
    "find_root_serial",
    "find_root_serial_batched",
    "iterations_for_error",
    "find_root_runahead",
    "find_root_runahead_batched",
    "runahead_solve",
    "serial_equivalent_iterations",
    "make_paper_f",
    "taylor_sin",
    "taylor_cos",
    "PAPER_INTERVAL",
    "PAPER_TERMS",
    "PAPER_EPS_CPU",
    "applications",
]
