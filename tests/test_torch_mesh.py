"""The port's mesh layer against the JAX package's, on the CPU.

``launch/mesh.py`` (parse_mesh, the production and elastic meshes),
``distributed/sharding.py`` (the rule sets), ``launch/shardings.py``
(param, ZeRO-1 and cache specs, on the same ``params_specs`` shapes as
JAX's, over a duck-typed 2x4 mesh so that JAX needs no forced host
devices), the engine's mesh half (``core/solver.py``: MeshPolicy, the
"data" and "vocab" placements, the sharded factories of both backends)
and the chip-level runahead (``core/sharded.py``).

The sharded paths run on gloo ranks that ``spawn_local`` starts on the
CPU, two groups for the module (4 ranks for the 2x2, 4x1 and 1x4 meshes
in turn, 3 for 1x3); their bodies are in ``tests/torch_mesh_ranks.py``
(they import no JAX), and this process holds what they return against
JAX's single-device code.  JAX's own mesh is not the reference: six of
its sharded-serving cases fail on this tree, and its pallas entropy is
not bit for bit under its mesh.

Contracts and tolerances:
  * count brackets (top-k static and per-row, quantile) under 2x2, 4x1
    and 1x4 meshes, fixed (``tuning.disabled()``) and tuned: bit for bit
    equal to JAX's single-device ``solve_kind`` ("jnp", disabled);
  * mass and entropy brackets, whose joins sum per-shard partials in
    another order than one whole-row sum: within rtol 1e-5 / atol 1e-6
    (the float contract of K4 and K5);
  * every rank of a group takes the same decisions (``tuning.explain``),
    also under the measured tier;
  * the chip-level root equals JAX's ``find_root_serial(mode="signbit")``
    bit for bit for k = 2, 3, 4 (budgets 12, 11, 13) on 2, 3 and 4 ranks
    with the pad poisoned to NaN, +inf and -inf.
"""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs.registry import get_config as jget_config
from repro.core import solver as jsolver
from repro.core import tuning as jtuning
from repro.core.bisect import find_root_serial as jfind_root_serial
from repro.core.paper_functions import make_paper_f as jmake_paper_f
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch import shardings as jshardings
from repro.launch.specs import cache_specs as jcache_specs
from repro.launch.specs import params_specs as jparams_specs
from repro.runtime.elastic import derive_mesh_shape as jderive_mesh_shape
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings
from repro_torch.launch.mesh import spawn_local
from repro_torch.runtime import elastic
import torch_one_thread  # noqa: F401 (one torch thread)

COUNT_KINDS = ("count_above", "count_below")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
B, V = 4, 128
TERMS = 50
BUDGETS = [(2, 12), (3, 11), (4, 13)]


# ---------------------------------------------------------------------------
# meshes, rules and specs (one process)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DuckMesh:
    """What the spec functions read of a mesh: JAX's needs no devices."""
    axis_names: tuple
    shape: dict


DUCK = DuckMesh(("data", "model"), {"data": 2, "model": 4})


@pytest.mark.parametrize("spec", ["2xq", "2x", "8", "2x2x2x2"])
def test_parse_mesh_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh(spec)
    with pytest.raises(ValueError) as got:
        mesh_lib.parse_mesh(spec)
    assert str(got.value) == str(want.value)


def test_meshes_of_one_rank(monkeypatch):
    m = mesh_lib.parse_mesh("1x1")
    assert m.axis_names == ("data", "model") and m.size == 1
    assert m.shape == {"data": 1, "model": 1}
    assert mesh_lib.data_axes(m) == ("data",)
    assert mesh_lib.parse_mesh("1x1x1").axis_names == ("pod", "data",
                                                       "model")
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 1"):
        mesh_lib.parse_mesh("2x2")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)
    e = elastic.make_elastic_mesh()
    assert e.shape == {"data": 1, "model": 1}
    t = torch.arange(6.0)
    assert m.all_reduce(t, "model") is t and m.all_gather(t, "data") is t
    assert m.broadcast_object({"a": 1}, m.axis_names, 0) == {"a": 1}
    # a rank launched on the card never falls back to the CPU
    monkeypatch.setenv(mesh_lib.DEVICE_ENV, "cuda:0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees no CUDA device"):
            mesh_lib.local_device()


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 24, 250, 256, 512])
def test_derive_mesh_shape_matches_jax(n):
    for mp in (1, 4, 16):
        assert (elastic.derive_mesh_shape(n, model_parallel=mp)
                == jderive_mesh_shape(n, model_parallel=mp))


def test_rules_match_jax():
    assert sharding.TRAIN_RULES == jsharding.TRAIN_RULES
    assert sharding.SERVE_RULES == jsharding.SERVE_RULES
    for mesh in (DUCK, DuckMesh(("pod", "data", "model"),
                                {"pod": 2, "data": 2, "model": 2})):
        for rules in (sharding.TRAIN_RULES, sharding.SERVE_RULES):
            for logical in rules:
                axes = sharding.resolve_axes(mesh, rules, logical)
                assert axes == jsharding.resolve_axes(mesh, rules, logical)
                assert (sharding.resolved_axis_size(mesh, axes)
                        == jsharding.resolved_axis_size(mesh, axes))
            assert sharding.logical_sharding(mesh, rules, "batch", "vocab") \
                == (sharding.resolve_axes(mesh, rules, "batch"),
                    sharding.resolve_axes(mesh, rules, "vocab"))
    x = torch.zeros(2, 3)
    assert sharding.shard(x, "batch") is x          # no rules: a no-op
    with sharding.axis_rules(sharding.SERVE_RULES, DUCK):
        assert sharding.current_rules()[1] is DUCK
        assert sharding.logical_axis_size("slot") == 2
        assert sharding.logical_axis_size("solver_vocab") == 4
        assert sharding.shard(x, "batch", "vocab") is x
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            sharding.shard(torch.zeros(1, 2, 3), "batch", "vocab")
    assert sharding.current_rules() is None


def _path(path) -> tuple:
    return tuple(str(getattr(p, "key", getattr(p, "name", getattr(
        p, "idx", p)))) for p in path)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-4b"])
def test_specs_match_jax(arch):
    cfg = jget_config(arch)
    leaves = jax.tree_util.tree_flatten_with_path(jparams_specs(cfg))[0]
    assert len(leaves) > 10
    for path, leaf in leaves:
        p = _path(path)
        assert shardings.param_spec(p, leaf.shape, DUCK) == tuple(
            jshardings.param_spec(path, leaf, DUCK)), p
        assert shardings.zero1_spec(p, leaf.shape, DUCK) == tuple(
            jshardings.zero1_spec(path, leaf, DUCK)), p
        assert shardings.param_spec("/".join(p), leaf, DUCK) == \
            shardings.param_spec(p, leaf.shape, DUCK)
    cache = jax.tree_util.tree_flatten_with_path(jcache_specs(cfg, 4, 64))[0]
    assert cache
    for path, leaf in cache:
        assert shardings.cache_spec(_path(path), leaf.shape, DUCK) == tuple(
            jshardings.cache_spec(path, leaf, DUCK)), _path(path)
    batch = {"tokens": torch.zeros(8, 16), "targets": torch.zeros(7, 16)}
    assert shardings.batch_shardings(DUCK, batch) == {
        "tokens": ("data", None), "targets": (None, None)}


# ---------------------------------------------------------------------------
# the engine's mesh half and the chip-level root, on gloo ranks
# ---------------------------------------------------------------------------

def _cases() -> list:
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(B, V)) * 3.0).astype(np.float32)
    probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    return [
        ("topk", "count_above", x, dict(k=17), 8, 5),
        ("topk_rows", "count_above", x,
         dict(k=np.array([1, 5, 17, 40])), 8, 5),
        ("quantile", "count_below", x, dict(q=0.37), 8, 4),
        ("topp", "mass_at_or_above", probs, dict(p=0.9), 8, 5),
        ("topp_rows", "mass_at_or_above", probs,
         dict(p=np.array([0.5, 0.8, 0.9, 0.95], np.float32)), 8, 5),
        ("entropy", "entropy_at_temperature", x, dict(target=3.0), 8, 5),
        ("entropy_rows", "entropy_at_temperature", x,
         dict(target=np.array([1.0, 2.0, 3.0, 4.0], np.float32)), 8, 5),
    ]


@functools.cache
def _jax_solve(i: int):
    """JAX's single-device brackets of case i, computed once."""
    name, kind, x, kw, rounds, spec_k = _cases()[i]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    with jtuning.disabled():
        lo, hi = jsolver.solve_kind(kind, jnp.asarray(x), backend="jnp",
                                    rounds=rounds, spec_k=spec_k, **kw)
    return np.asarray(lo), np.asarray(hi)


def _assert_brackets(kind, got, want, what):
    for g, w in zip(got, want):
        if kind in COUNT_KINDS:
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, **FLOAT_TOL, err_msg=what)


def _roots_match_serial(results: list) -> None:
    f = jmake_paper_f(TERMS)
    for out in results:
        assert out == results[0]        # every rank walks to the same root
        assert any(out["pads"].values())  # the split is uneven somewhere
        for poison in (float("nan"), float("inf"), float("-inf")):
            for k, iters in BUDGETS:
                want = float(jfind_root_serial(
                    f, jnp.float32(1.0), jnp.float32(2.0), iters,
                    mode="signbit"))
                assert out[(str(poison), k, iters)] == want, (poison, k, iters)


SOLVER_MESHES = ("2x2", "4x1", "1x4")
ROOT_MESHES = ("1x3", "1x4", "2x2")
# the groups of gloo ranks: (world, [(mesh, solver checks?, roots?)])
GROUPS = ((4, (("2x2", True, True), ("4x1", True, False),
               ("1x4", True, True))),
          (3, (("1x3", False, True),)))


@functools.cache
def _groups() -> dict:
    """Each group's ranks run their meshes' solver checks and chip-level
    roots, which the tests below read: {mesh: [per rank: its results]}
    (two spawns for the whole module)."""
    cache = os.path.join(tempfile.mkdtemp(prefix="mesh_tuning_"), "t")
    out = {}
    for world, jobs in GROUPS:
        ranks_out = spawn_local(ranks.mesh_checks, world,
                                args=(jobs, _cases(), cache, TERMS, BUDGETS),
                                timeout=300)
        for spec, _, _ in jobs:
            out[spec] = [r[spec] for r in ranks_out]
    return out


@pytest.mark.parametrize("spec", SOLVER_MESHES)
def test_sharded_solves_match_jax_single_device(spec):
    cases = _cases()
    results = [out["solver"] for out in _groups()[spec]]
    for i, (name, kind, x, kw, rounds, spec_k) in enumerate(cases):
        want = _jax_solve(i)
        for r, out in enumerate(results):
            for backend in ranks.BACKENDS:
                for mode in ranks.MODES:
                    _assert_brackets(kind, out[(name, backend, mode)], want,
                                     f"{spec} rank {r} {name} {backend} "
                                     f"{mode}")
    kind, want = cases[0][1], _jax_solve(0)
    kind_m, want_m = cases[-1][1], _jax_solve(len(cases) - 1)
    for out in results:
        _assert_brackets(kind, out["local_rows"], want, f"{spec} local")
        _assert_brackets(kind_m, out["measured"], want_m, f"{spec} measured")
        # the ranks agreed on every decision, measured ones included
        assert out["explain"] == results[0]["explain"]
    placements = {d["placement"] for _, d in results[0]["explain"]}
    sources = {d["source"] for _, d in results[0]["explain"]}
    assert "measured" in sources and "fixed" in sources
    # the fixed decision shards wherever the mesh can
    assert {"2x2": "vocab", "4x1": "data", "1x4": "vocab"}[spec] \
        in placements


@pytest.mark.parametrize("spec", ROOT_MESHES)
def test_chip_level_root_matches_serial_with_the_pad_poisoned(spec):
    _roots_match_serial([out["roots"] for out in _groups()[spec]])


def test_a_failed_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
        spawn_local(ranks.root_checks, 2, args=("3x3", TERMS, BUDGETS),
                    timeout=120)
