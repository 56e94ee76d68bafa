"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_serving.py``).

Each function runs on every rank of a group that
``repro_torch.launch.mesh.spawn_local`` starts on the CPU (gloo), and
returns what its test compares in the test process.  This module imports
no JAX: the ranks run the port only, and the test process holds their
results against the JAX package.  Inputs arrive as numpy arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import solver, tuning
from repro_torch.core import sharded
from repro_torch.core.solver import MeshPolicy, mesh_policy
from repro_torch.launch.mesh import parse_mesh
from repro_torch.launch.shardings import local_block

BACKENDS = ("torch", "hopper")
MODES = ("fixed", "tuned")


def _tensor(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def solver_checks(spec: str, cases: list, cache_path: str) -> dict:
    """Every (case, backend, mode) solved under the mesh's policy with
    the global operand: {(name, backend, mode): (lo, hi)}.  Also the
    first case through a ``local_rows`` policy on this rank's rows (its
    brackets gathered back), one solve under the measured tier, and the
    decisions this rank took (``tuning.explain``)."""
    mesh = parse_mesh(spec)
    tuning.set_cache_path(f"{cache_path}.{spec}")    # an empty cache
    tuning.tuner().recent.clear()
    out = {}
    for name, kind, x, kw, rounds, spec_k in cases:
        op = torch.from_numpy(x)
        params = {k: _tensor(v) for k, v in kw.items()}
        for backend in BACKENDS:
            for mode in MODES:
                ctx = (tuning.disabled() if mode == "fixed"
                       else contextlib.nullcontext())
                with ctx, mesh_policy(mesh):
                    lo, hi = solver.solve_kind(kind, op, backend=backend,
                                               rounds=rounds, spec_k=spec_k,
                                               **params)
                out[(name, backend, mode)] = (lo.numpy(), hi.numpy())
    name, kind, x, kw, rounds, spec_k = cases[0]
    policy = MeshPolicy(mesh, local_rows=True)
    spec_rows = (policy.data_axes,)
    op = local_block(torch.from_numpy(x), spec_rows, mesh)
    params = {k: local_block(_tensor(v), spec_rows, mesh)
              if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with tuning.disabled(), mesh_policy(policy):
        lo, hi = solver.solve_kind(kind, op, backend="hopper", rounds=rounds,
                                   spec_k=spec_k, **params)
    out["local_rows"] = tuple(mesh.all_gather(t, policy.data_axes).numpy()
                              for t in (lo, hi))
    name, kind, x, kw, rounds, spec_k = cases[-1]
    with tuning.autotune(), mesh_policy(mesh):
        lo, hi = solver.solve_kind(kind, torch.from_numpy(x),
                                   backend="auto", rounds=rounds,
                                   spec_k=spec_k,
                                   **{k: _tensor(v) for k, v in kw.items()})
    out["measured"] = (lo.numpy(), hi.numpy())
    out["explain"] = [(key, d.to_json()) for key, d in tuning.explain()]
    return out


def root_checks(spec: str, terms: int, budgets: list) -> dict:
    """``find_root_runahead_sharded`` over the mesh's model axis with the
    pad poisoned (NaN, +inf, -inf in turn): {(poison, k, iterations):
    root}, and the pad count of each k."""
    from repro_torch.core.paper_functions import make_paper_f

    mesh = parse_mesh(spec)
    f = make_paper_f(terms)
    d = mesh.axis_size("model")
    out = {"pads": {k: -(-((1 << k) - 1) // d) * d - ((1 << k) - 1)
                    for k, _ in budgets}}
    for poison in (float("nan"), float("inf"), float("-inf")):
        sharded._pad_fill = (
            lambda interior, n_fill, p=poison:
                torch.full((n_fill,), p, dtype=interior.dtype))
        sharded._cached_sharded_solve.cache_clear()
        for k, iters in budgets:
            r = sharded.find_root_runahead_sharded(
                f, torch.tensor(1.0), torch.tensor(2.0), iters, k, mesh,
                axis="model")
            out[(str(poison), k, iters)] = float(r)
    return out


def mesh_checks(jobs: list, cases: list, cache_path: str, terms: int,
                budgets: list) -> dict:
    """``solver_checks`` and ``root_checks`` for each (mesh, solver?,
    roots?) job, in turn on one group: {mesh: {"solver": .., "roots":
    ..}}, None where a job skips one."""
    return {spec: {"solver": (solver_checks(spec, cases, cache_path)
                              if solve else None),
                   "roots": (root_checks(spec, terms, budgets)
                             if roots else None)}
            for spec, solve, roots in jobs}


def serve_checks(plan: list, model: tuple, runs: list) -> list:
    """Each (mesh, run index) of ``plan`` served in turn on this group:
    [{"streams": {rid: tokens}, ...} an entry of the plan].

    ``model`` is (arch, config overrides, a numpy params tree or None for
    weights drawn from ``seed`` on this rank, seed); ``runs`` is
    [(requests, server kwargs)].  Each entry also carries the scheduler's
    decode steps, its local slot count and first slot, a checksum of this
    rank's weights, and its speculation: the drafts of its own slots a
    step (``serve_recorded``), its drafted and accepted counts and its
    ``draft_len`` retunes."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models import testing
    from repro_torch.models.transformer import init_params

    arch, overrides, tree, seed = model
    cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
    if tree is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             torch.float32)
    else:
        params = params_from_jax(tree, "cpu")
    checksum = float(sum(t.double().sum() for t in _leaves(params)))
    meshes = {}
    out = []
    for spec, run in plan:
        if spec not in meshes:
            meshes[spec] = parse_mesh(spec)
        requests, kw = runs[run]
        done, s, drafts = serve_recorded(cfg, params, requests, kw,
                                         meshes[spec])
        out.append(dict(streams={c.rid: c.tokens for c in done},
                        steps=s.n_decode_steps, local=s.n_local,
                        slot0=s.slot0, checksum=checksum, drafts=drafts,
                        drafted=s.n_drafted, accepted=s.n_accepted,
                        retunes=s.n_draft_retunes))
    return out


def serve_recorded(cfg, params, requests: list, kw: dict, mesh=None):
    """``requests`` served by a ``RunaheadServer(**kw)`` on ``mesh``:
    (completions, the scheduler, and each step's (draft_len, this rank's
    host drafts) in step order).  ``kw["draft_retune_min"]``, where
    given, sets the scheduler's retune window."""
    from repro_torch.serving.server import RunaheadServer

    kw = dict(kw)
    retune_min = kw.pop("draft_retune_min", None)
    server = RunaheadServer(cfg, params, mesh=mesh, **kw)
    s = server.scheduler
    if retune_min is not None:
        s.draft_retune_min = retune_min
    drafts = []
    write = s._write_drafts

    def recorded(L):
        write(L)
        drafts.append((L, s.draft[:, :L - 1].tolist()))

    s._write_drafts = recorded
    done = server.run([dataclasses.replace(r) for r in requests])
    return done, s, drafts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def serve_many(jobs: list, launcher_argv: list | None = None) -> list:
    """``serve_checks`` for each (plan, model, runs) job, in one group;
    then, given ``launcher_argv``, ``launch/serve.py``'s main on it in
    this world: its {rid: tokens} and speculation counters last."""
    out = [serve_checks(plan, model, runs) for plan, model, runs in jobs]
    if launcher_argv is not None:
        import logging

        from repro_torch.launch import serve

        logging.getLogger().setLevel(logging.WARNING)
        served = serve.main(launcher_argv)
        out.append(dict(streams={c.rid: c.tokens
                                 for c in served.completions},
                        counts=served.counts,
                        draft_len=served.scheduler.draft_len))
    return out


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py): ranks share cuda:0 over gloo
# ---------------------------------------------------------------------------

def cuda_solver_checks(spec: str) -> dict:
    """The "hopper" backend's vocab-sharded solves on this rank's shard
    of (4, 151936) rows against the "torch" backend's single-rank solve
    on this rank (K2 bit for bit; K4 and K5 within rtol 1e-5 / atol
    1e-6), each kernel launched on the local shard."""
    from repro_torch.kernels import ops

    mesh = parse_mesh(spec)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    x = torch.randn((4, 151936), generator=gen, device=mesh.device) * 2.0
    probs = torch.softmax(x, dim=-1)
    out = {}
    for kind, op, kw in (("count_above", x, dict(k=40)),
                         ("count_below", x, dict(q=0.37)),
                         ("mass_at_or_above", probs, dict(p=0.9)),
                         ("entropy_at_temperature", x, dict(target=3.0))):
        with tuning.disabled():
            want = solver.solve_kind(kind, op, backend="torch", rounds=8,
                                     spec_k=5, **kw)
            ops.reset_launches()
            with mesh_policy(mesh):
                got = solver.solve_kind(kind, op, backend="hopper",
                                        rounds=8, spec_k=5, **kw)
        exact = kind.startswith("count")
        out[kind] = dict(
            ok=all(torch.equal(g, w) if exact
                   else torch.allclose(g, w, rtol=1e-5, atol=1e-6)
                   for g, w in zip(got, want)),
            launches={k: v for k, v in ops.LAUNCHES.items() if v})
    return out


def cuda_root_checks(spec: str, terms: int) -> dict:
    """The chip-level root through K1 on each rank's chunk against the
    serial root, k = 2, 3, 4, and K1's launches a solve."""
    from repro_torch.core import find_root_serial
    from repro_torch.kernels import ops
    from repro_torch.launch import paper

    mesh = parse_mesh(spec)
    f = paper.evaluator(terms)
    a, b = paper.interval(mesh.device)
    out = {}
    for k in (2, 3, 4):
        want = find_root_serial(f, a, b, 6, "signbit")
        ops.reset_launches()
        got = sharded.find_root_runahead_sharded(f, a, b, 6, k, mesh)
        out[k] = (got.item() == want.item(),
                  ops.LAUNCHES["taylor_sincos_eval"])
    return out


def cuda_step_checks(spec: str, dtype: str = "bfloat16") -> dict:
    """Reduced qwen3-4b (weights, forward and cache in ``dtype``, the
    weights from seed 0 on this rank) served under the mesh and by the
    single-rank (graphed) scheduler on this rank: greedy and top-k
    streams.  A mesh with a data split runs its forwards over fewer rows
    than the single rank's, which round apart in bf16: hold it in f32."""
    from repro_torch.models import testing
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import Request, RunaheadServer

    mesh = parse_mesh(spec)
    cfg = testing.reduced_config("qwen3-4b")
    dt = getattr(torch, dtype)
    params = init_params(
        cfg, torch.Generator(device=mesh.device).manual_seed(0), dt)
    reqs = [Request(i, [(5 * i + j) % cfg.vocab for j in range(8)], 6,
                    seed=i, sampler=SamplerConfig(
                        backend="hopper", greedy=i % 2 == 0, top_k=12),
                    arrival=i // 2) for i in range(6)]
    out = {}
    for name, m in (("single", None), ("mesh", mesh)):
        srv = RunaheadServer(cfg, params, n_slots=4, context=16,
                             backend="hopper", page_size=4,
                             page_impl="hopper", mesh=m, cache_dtype=dt,
                             compute_dtype=dt)
        out[name] = {c.rid: c.tokens
                     for c in srv.run([dataclasses.replace(r)
                                       for r in reqs])}
    return out
