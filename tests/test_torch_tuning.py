"""The port's tuner (``repro_torch.core.tuning``) and block geometry
(``repro_torch.kernels.blocks``) against the JAX package's, on the CPU.

The CPU profile is the JAX package's, with its backend names ``jnp`` and
``pallas`` spelt ``torch`` and ``hopper``, so analytic decisions, cache
keys and the ``decide_*`` functions must equal JAX's exactly.  Tuned and
forced decompositions of one serial-step budget must give the serial
walk's bracket bit for bit (mirroring ``tests/test_tuning.py``), and the
decision procedure (disabled, cache, legality on replay, override, the
measured set) must behave as JAX's.  The kernel tier's families are the
port's own (K2-K6 on Hopper), so its candidates are held to the kernels'
legality and its fixed geometry to today's functions.  No Pallas kernel
runs here; every cache lives under ``tmp_path``.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core import tuning as jtuning
from repro.kernels import blocks as jblocks
from repro_torch.core import solver, tuning
from repro_torch.kernels import blocks
from repro_torch.kernels import paged_attend as pa
from repro_torch.kernels import row_reduce as rr
from repro_torch.kernels import runahead_threshold as rt

TO_JAX = {"torch": "jnp", "hopper": "pallas", "auto": "auto"}
KINDS = ["count_above", "count_below", "mass_at_or_above",
         "entropy_at_temperature"]
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache(tmp_path):
    """The module tuner's cache under tmp_path, restored after."""
    tuning.set_cache_path(str(tmp_path / "cache.json"))
    yield tmp_path / "cache.json"
    tuning.set_cache_path(None)


def _jax_decision(d: jtuning.Decision) -> tuple:
    return (d.spec_k, d.rounds, d.placement, d.backend)


def _port_decision(d: tuning.Decision) -> tuple:
    return (d.spec_k, d.rounds, d.placement, TO_JAX[d.backend])


# ---------------------------------------------------------------------------
# the analytic tier equals JAX's on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analytic_decisions_equal_jax(kind, dtype):
    for batch in (1, 4, 8):
        for vocab in (1000, 8192, 151936):
            for budget in (24, 32, 40):
                for backends in (("torch",), ("hopper",),
                                 ("torch", "hopper")):
                    pref = backends[0] if len(backends) == 1 else "auto"
                    key = tuning.ConfigKey(kind, batch, vocab, dtype, pref,
                                           1, "cpu", budget)
                    jkey = jtuning.ConfigKey(kind, batch, vocab, dtype,
                                             TO_JAX[pref], 1, "cpu", budget)
                    assert key.cache_key().replace(
                        f"pref={pref}", f"pref={TO_JAX[pref]}") \
                        == jkey.cache_key()
                    got = tuning._candidates(key, {"single": (1, 1)},
                                             backends)
                    want = jtuning._candidates(
                        jkey, {"single": (1, 1)},
                        tuple(TO_JAX[b] for b in backends))
                    assert [(c, _port_decision(d)) for c, d in got] == \
                        [(c, _jax_decision(d)) for c, d in want]


def test_solve_kind_keys_spell_dtypes_as_jax(cache):
    """The key a solve takes names the operand's dtype as JAX does
    (``bfloat16``, not ``torch.bfloat16``): the CPU profile prices bf16 at
    2 bytes an element from that spelling."""
    x = np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)
    jtuning.tuner().recent.clear()
    tuning.tuner().recent.clear()
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        solver.solve_kind("count_above", torch.from_numpy(x).to(dtype),
                          backend="torch", rounds=8, spec_k=5, k=3)
        jsolver.solve_kind("count_above", jnp.asarray(x, jdtype),
                           backend="jnp", rounds=8, spec_k=5, k=3)
    got = [(k.replace("pref=torch", "pref=jnp"), _port_decision(d))
           for k, d in tuning.explain()]
    want = [(k, _jax_decision(d)) for k, d in jtuning.explain()]
    assert got == want
    assert "bfloat16" in got[1][0]


# ---------------------------------------------------------------------------
# the decide_* functions equal JAX's for explicit arguments
# ---------------------------------------------------------------------------

def test_decide_functions_equal_jax():
    for context in (1, 17, 544, 4096):
        for shared in (0, 5, 64, 100):
            for rows in (0.5, 1.0, 4.0):
                kw = dict(context=context, shared_prefix_len=shared,
                          table_overhead_rows=rows)
                assert tuning.decide_page_size(**kw) == \
                    jtuning.decide_page_size(**kw)
    for a in (0.0, 0.1, 0.3, 0.6, 0.9, 0.99, 1.0):
        for overhead in (0.0, 0.0073, 1.0, 4.3, 15.7, 50.0):
            for cap in (1, 3, 8):
                kw = dict(acceptance=a, overhead=overhead, max_draft_len=cap)
                assert tuning.decide_draft_len(**kw) == \
                    jtuning.decide_draft_len(**kw)
    for m in (1.0, 8.0, 32.0, 140.0, 1000.0):
        for overhead in (0.0, 0.0073, 1.0, 4.3, 20.0):
            for load in (0.0, 0.5, 1.0):
                kw = dict(mean_remaining=m, overhead=overhead, load=load)
                assert tuning.decide_step_horizon(**kw) == \
                    jtuning.decide_step_horizon(**kw)


def test_verify_step_cost_prices_rows_not_steps():
    """The launcher prices a verify step as the least-squares line
    through the card's measured verify steps; at the issue's reckoning
    (cost(4) = 1.18 cost(1)) the overhead is ~15.7 rows and L ~ 5."""
    row, overhead = tuning.verify_step_cost({1: 1.0, 4: 1.18})
    assert math.isclose(overhead / row, 0.94 / 0.06, rel_tol=1e-9)
    assert tuning.decide_draft_len(acceptance=0.6, token_cost=row,
                                   overhead=overhead) == 5
    row, overhead = tuning.verify_step_cost()
    assert row > 0 and overhead > 0
    with pytest.raises(ValueError):
        tuning.verify_step_cost({1: 2.0, 2: 1.0})


# ---------------------------------------------------------------------------
# blocks.py equals JAX's
# ---------------------------------------------------------------------------

def test_block_helpers_equal_jax():
    assert (blocks.LANE, blocks.DEFAULT_BLOCK_V, blocks.VMEM_BYTES) == \
        (jblocks.LANE, jblocks.DEFAULT_BLOCK_V, jblocks.VMEM_BYTES)
    for n in (0, 1, 127, 128, 129, 5000, 151936):
        assert blocks.lane_pad(n) == jblocks.lane_pad(n)
        for mult in (1, 128, 2048):
            assert blocks.pad_to(n, mult) == jblocks.pad_to(n, mult)
        for target in (1, 256, 512, 1024):
            assert blocks.divisor_chunk(n, target) == \
                jblocks.divisor_chunk(n, target)
    for v in (1, 100, 5000, 8192, 151936):
        for b in (None, 1, 200, 2048, 1 << 20):
            assert blocks.clamp_block_v(b, v) == jblocks.clamp_block_v(b, v)
        for b in (128, 2048):
            assert blocks.grid_v(v, b) == jblocks.grid_v(v, b)
    for b in (128, 2048, 8192):
        for m in (1, 15, 31, 255):
            for acc in (1, 2):
                t = blocks.solver_tile_bytes(b, m, acc_rows=acc)
                assert t == jblocks.solver_tile_bytes(b, m, acc_rows=acc)
                for budget in (None, 1024, 1 << 20):
                    assert blocks.fits_vmem(t, budget=budget) == \
                        jblocks.fits_vmem(t, budget=budget)
    assert blocks.fits_smem(227 * 1024) and not blocks.fits_smem(
        227 * 1024 + 1)


# ---------------------------------------------------------------------------
# tuned and forced decompositions: the serial walk, bit for bit
# ---------------------------------------------------------------------------

def _operand_and_params(kind: str, seed: int, B: int, V: int):
    """tests/test_tuning.py's randomisation, as numpy."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, V)).astype(np.float32) * 2.0
    if kind == "count_above":
        return z, dict(k=int(rng.integers(1, V)))
    if kind == "count_below":
        return z, dict(q=float(rng.uniform(0.05, 0.95)))
    if kind == "mass_at_or_above":
        return (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(
            np.float32), dict(p=float(rng.uniform(0.1, 0.9)))
    return z, dict(target=float(rng.uniform(0.5, 0.9 * math.log(V))))


def _serial_bracket(problem, steps: int):
    """Scalar serial sign-bit bisection, one trajectory per row, through
    the problem's own evaluator at M=1 (the reference of
    tests/test_solver_properties.py, in torch)."""
    lo, hi = problem.lo0, problem.hi0.to(problem.lo0.dtype)
    sl = problem.sign_lo
    if sl is None:
        sl = problem.sign_bit(problem.multi_eval(lo[:, None])[:, 0])
    for _ in range(steps):
        mid = (lo + hi) / 2
        sm = problem.sign_bit(problem.multi_eval(mid[:, None])[:, 0])
        left = sl != sm
        lo, hi, sl = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                      torch.where(left, sl, sm))
    return lo, hi


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_forced_decompositions_give_the_serial_bracket(kind, backend):
    """Every spec_k from 1 to 8 under override spends the same 12-step
    budget (partial last rounds included, and K3's whole solve where the
    rounds are whole): each lands on the serial walk's bracket."""
    z, params = _operand_and_params(kind, seed=11, B=2, V=41)
    x = torch.from_numpy(z)
    want = _serial_bracket(solver.problem(kind, x, backend=backend,
                                          **params), 12)
    for forced in range(1, 9):
        with tuning.override(spec_k=forced):
            lo, hi = solver.solve_kind(kind, x, backend=backend, rounds=4,
                                       spec_k=3, **params)
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1]), \
            f"{kind}/{backend} spec_k={forced}"


@pytest.mark.parametrize("kind", KINDS)
def test_tuned_brackets_equal_jax_tuned(kind):
    """Default tuning on both sides (the analytic tier, equal decisions on
    the CPU): the port's bracket is JAX's, bit for bit."""
    z, params = _operand_and_params(kind, seed=5, B=3, V=50)
    for backend, jbackend in (("torch", "jnp"), ("hopper", "jnp"),
                              ("auto", "auto")):
        lo, hi = solver.solve_kind(kind, torch.from_numpy(z),
                                   backend=backend, rounds=4, spec_k=3,
                                   **params)
        jlo, jhi = jsolver.solve_kind(kind, jnp.asarray(z), backend=jbackend,
                                      rounds=4, spec_k=3, **params)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_auto_on_a_cpu_tensor_ranks_torch_and_hopper(cache):
    z, params = _operand_and_params("count_above", seed=3, B=2, V=32)
    tuning.tuner().recent.clear()
    solver.solve_kind("count_above", torch.from_numpy(z), backend="auto",
                      rounds=4, spec_k=3, **params)
    [(key, d)] = tuning.explain()
    assert "pref=auto" in key and d.backend == "torch"
    assert solver.backends_for("count_above") == ["torch", "hopper"]


# ---------------------------------------------------------------------------
# the decision procedure (tests/test_tuning.py's, with "single" alone)
# ---------------------------------------------------------------------------

def _key(**kw):
    base = dict(kind="count_above", batch=8, vocab=8192, dtype="float32",
                backend_pref="torch", device_count=1, device_kind="cpu",
                iterations=24)
    base.update(kw)
    return tuning.ConfigKey(**base)


OPTIONS = {"single": (1, 1)}
FIXED = tuning.Decision(spec_k=4, rounds=6, placement="single",
                        backend="torch", source="fixed")


def _measure_fastest(spec_k: int):
    def measure(cands):
        return [{"seconds": 1e-4 if d.spec_k == spec_k else 1e-2}
                for d in cands]
    return measure


def test_disabled_pins_fixed_configuration(cache):
    z, params = _operand_and_params("count_above", seed=9, B=2, V=32)
    with tuning.disabled():
        tuning.tuner().recent.clear()
        solver.solve_kind("count_above", torch.from_numpy(z), rounds=4,
                          spec_k=3, **params)
        [(_, d)] = tuning.explain()
    assert d.source == "fixed" and (d.rounds, d.spec_k) == (4, 3)
    t = tuning.Tuner(str(cache))
    with tuning.disabled():
        d = t.decide(_key(), options=OPTIONS, backends=("torch",),
                     fixed=FIXED, measure=lambda c: pytest.fail("measured"))
    assert d == FIXED


def test_cache_roundtrip_and_stale_schema(cache):
    t1 = tuning.Tuner(str(cache))
    with tuning.autotune():
        d1 = t1.decide(_key(), options=OPTIONS, backends=("torch",),
                       fixed=FIXED, measure=_measure_fastest(4))
    assert d1.source == "measured" and (d1.spec_k, d1.rounds) == (4, 6)
    on_disk = json.loads(cache.read_text())
    assert on_disk["schema"] == tuning.SCHEMA_VERSION
    [entry] = on_disk["entries"].values()
    assert "single/torch/k4" in entry["measured_us"]

    t2 = tuning.Tuner(str(cache))
    d2 = t2.decide(_key(), options=OPTIONS, backends=("torch",), fixed=FIXED,
                   measure=lambda c: pytest.fail("cache hit must not measure"))
    assert d2.source == "cache" and (d2.spec_k, d2.rounds) == (4, 6)

    cache.write_text(json.dumps(dict(on_disk,
                                     schema=tuning.SCHEMA_VERSION - 1)))
    d3 = tuning.Tuner(str(cache)).decide(_key(), options=OPTIONS,
                                         backends=("torch",), fixed=FIXED)
    assert d3.source == "model"


@pytest.mark.parametrize("field,value", [
    ("step_horizon", 0), ("draft_len", 0), ("spec_k", 0),
    ("rounds", 5),             # does not cover the 24-step budget at k 4
    ("backend", "hopper"),     # not in the caller's backends
    ("placement", "vocab"),    # not a placement of the port
])
def test_cached_insane_or_illegal_entries_not_replayed(cache, field, value):
    t1 = tuning.Tuner(str(cache))
    with tuning.autotune():
        t1.decide(_key(), options=OPTIONS, backends=("torch",), fixed=FIXED,
                  measure=_measure_fastest(4))
    data = json.loads(cache.read_text())
    next(iter(data["entries"].values()))["decision"][field] = value
    cache.write_text(json.dumps(data))
    d = tuning.Tuner(str(cache)).decide(_key(), options=OPTIONS,
                                        backends=("torch",), fixed=FIXED)
    assert d.source == "model"


def test_override_forces_fields_and_recomputes_rounds(cache):
    t = tuning.Tuner(str(cache))
    with tuning.override(spec_k=5, placement="single"):
        d = t.decide(_key(), options=OPTIONS, backends=("torch",),
                     fixed=FIXED)
    assert d.source == "override" and d.spec_k == 5
    assert d.rounds == -(-24 // 5)
    with pytest.raises(ValueError):
        with tuning.override(placement="vocab"):
            pass


def test_measured_set_includes_fixed_and_drops_nan(cache):
    seen = []

    def measure(cands):
        seen.extend(cands)
        return [{"seconds": float("nan") if d.spec_k != FIXED.spec_k
                 else 1e-3} for d in cands]

    t = tuning.Tuner(str(cache))
    with tuning.autotune():
        d = t.decide(_key(iterations=40), options=OPTIONS,
                     backends=("torch",),
                     fixed=tuning.Decision(spec_k=4, rounds=10,
                                           placement="single",
                                           backend="torch"),
                     measure=measure)
    assert any(c.spec_k == 4 and c.rounds == 10 for c in seen)
    assert d.source == "measured" and d.spec_k == 4


def test_measure_failures_are_not_swallowed(cache):
    def measure(cands):
        raise RuntimeError("a legal candidate failed")

    with tuning.autotune(), pytest.raises(RuntimeError, match="legal"):
        tuning.Tuner(str(cache)).decide(_key(), options=OPTIONS,
                                        backends=("torch",), fixed=FIXED,
                                        measure=measure)


def test_measured_tier_end_to_end_on_the_cpu(cache):
    """solve_kind under tune=True times its candidates (perf_counter on
    the CPU), keeps the winner, and replays it from the cache."""
    z, params = _operand_and_params("mass_at_or_above", seed=2, B=2, V=64)
    x = torch.from_numpy(z)
    want = solver.solve_kind("mass_at_or_above", x, rounds=4, spec_k=3,
                             tune=False, **params)
    got = solver.solve_kind("mass_at_or_above", x, rounds=4, spec_k=3,
                            tune=True, **params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    [(key, entry)] = json.loads(cache.read_text())["entries"].items()
    assert len(entry["measured_us"]) >= 3
    tuning.tuner().recent.clear()
    solver.solve_kind("mass_at_or_above", x, rounds=4, spec_k=3, **params)
    assert tuning.explain() == [(key, tuning.Decision.from_json(
        dict(entry["decision"], source="cache")))]


# ---------------------------------------------------------------------------
# the kernel tier: the port's own families
# ---------------------------------------------------------------------------

def _kkey(kernel="multi_count", shape=(4, 151936, 31), dtype="float32"):
    return tuning.KernelKey(kernel, shape, dtype, H100)


ROW_SHAPES = [(4, 151936, 31), (4, 151936, 1), (16, 151936, 31),
              (1, 300, 15), (64, 151936, 33), (3, 1000, 31), (48, 65536, 7)]
K3_SHAPES = [(4, 151936), (16, 151936), (48, 65536), (64, 1024), (1, 50)]
K6_SHAPES = [(4, 8, 34, 16, 1, 4, 128), (4, 8, 34, 16, 4, 4, 128),
             (3, 8, 7, 16, 3, 4, 128), (1, 2, 1, 4, 1, 1, 16)]


@pytest.mark.parametrize("family", ["multi_count", "multi_mass",
                                    "multi_entropy_moments"])
def test_row_reduce_candidates_legal_fixed_first(family):
    for B, V, M in ROW_SHAPES:
        cands = tuning.kernel_candidates(_kkey(family, (B, V, M)))
        assert cands[0].params == {"nb": rr.blocks_per_row(
            B, V, rr.CARD_SMS)}
        for d in cands:
            assert 1 <= d.params["nb"] <= rr.max_blocks(V)


def test_topk_candidates_legal_fixed_first():
    for B, V in K3_SHAPES:
        cands = tuning.kernel_candidates(_kkey("runahead_topk", (B, V)))
        assert cands[0].params == {"clusters": rt.cluster_geometry(
            B, V)[0]}
        for d in cands:
            c = d.params["clusters"]
            assert 1 <= c <= rt.MAX_CLUSTERS and rt._slice(V, c) <= \
                rt.SLICE_MAX
    assert tuning.kernel_candidates(
        _kkey("runahead_topk", (1, rt.MAX_CLUSTERS * rt.SLICE_MAX + 1))) \
        == []


def test_paged_candidates_legal_fixed_first():
    for shape in K6_SHAPES:
        B, nkv, n_chain, P, L, R, D = shape
        cands = tuning.kernel_candidates(_kkey("paged_attend", shape,
                                               "bfloat16"))
        assert cands[0].params == {"n_split": pa.split_geometry(
            B, nkv, n_chain)[0]}
        for d in cands:
            n = d.params["n_split"]
            assert 1 <= n <= n_chain
            assert pa.split_runs(n_chain, n)[0] == n
    # a shape whose block overflows shared memory has no geometry
    assert tuning.kernel_candidates(
        _kkey("paged_attend", (1, 1, 4, 64, 8, 16, 128), "float32")) == []


def test_kernel_disabled_and_unknown_family_keep_fixed(cache):
    t = tuning.Tuner(str(cache))
    with tuning.disabled():
        d = t.decide_kernel(_kkey(), fixed={"nb": 33},
                            measure=lambda c: pytest.fail("measured"))
    assert (d.source, d.params) == ("fixed", {"nb": 33})
    d = t.decide_kernel(_kkey("flash_fwd", (2, 4096, 16, 128)),
                        fixed={"q_chunk": 512})
    assert (d.source, d.params) == ("model", {"q_chunk": 512})
    d = t.decide_kernel(_kkey(), fixed={"nb": 33})
    assert (d.source, d.params) == ("model", {"nb": 33})


def test_kernel_cache_roundtrip_and_stale_schema(cache):
    seen = []

    def measure(cands):
        seen.append([dict(c) for c in cands])
        return [1e-4 if i == 1 else 1e-2 for i in range(len(cands))]

    t1 = tuning.Tuner(str(cache))
    with tuning.autotune():
        d1 = t1.decide_kernel(_kkey(), fixed={"nb": 33}, measure=measure)
    assert d1.source == "measured" and d1.params == seen[0][1]
    # every legal geometry is timed, today's first
    assert seen[0] == [d.params for d in tuning.kernel_candidates(_kkey())]
    assert seen[0][0] == {"nb": 33}
    on_disk = json.loads(cache.read_text())
    [(ck, entry)] = on_disk["kernels"].items()
    assert ck == _kkey().cache_key() and entry["decision"]["block"] == \
        d1.params
    with tuning.autotune():
        d2 = tuning.Tuner(str(cache)).decide_kernel(
            _kkey(), fixed={"nb": 33},
            measure=lambda c: pytest.fail("cache hit must not measure"))
    assert d2.source == "cache" and d2.params == d1.params
    other = tuning.KernelKey("multi_count", (4, 151936, 31), "float32",
                             "NVIDIA A100-SXM4-80GB")
    assert tuning.Tuner(str(cache)).decide_kernel(
        other, fixed={"nb": 27}).source == "model"
    cache.write_text(json.dumps(dict(on_disk,
                                     schema=tuning.SCHEMA_VERSION - 1)))
    assert tuning.Tuner(str(cache)).decide_kernel(
        _kkey(), fixed={"nb": 33}).source == "model"


@pytest.mark.parametrize("bad_block", [
    {"nb": 0}, {"nb": 150},              # outside the kernel's legal range
    {"blocks": 33},                      # wrong param name
    {"nb": 33, "clusters": 8},           # extra param
    {},
])
def test_kernel_corrupted_entry_not_replayed(cache, bad_block):
    blob = {"schema": tuning.SCHEMA_VERSION, "entries": {},
            "kernels": {_kkey().cache_key(): {
                "decision": {"block": bad_block, "source": "measured"}}}}
    cache.write_text(json.dumps(blob))
    d = tuning.Tuner(str(cache)).decide_kernel(_kkey(), fixed={"nb": 33})
    assert (d.source, d.params) == ("model", {"nb": 33})


def test_kernel_measured_nan_falls_back(cache):
    t = tuning.Tuner(str(cache))
    with tuning.autotune():
        d = t.decide_kernel(_kkey(), fixed={"nb": 33},
                            measure=lambda c: [float("nan")] * len(c))
    assert d.source == "model"
    assert not cache.exists() or _kkey().cache_key() not in json.loads(
        cache.read_text()).get("kernels", {})


def test_cpu_launches_decide_no_geometry():
    """On CPU tensors the wrappers run the plain versions, which take no
    geometry: nothing reaches the kernel tier."""
    from repro_torch.kernels import ops

    tuning.tuner().recent_kernels.clear()
    x = torch.randn(2, 300)
    ops.multi_count(x, x[:, :5])
    ops.runahead_topk_threshold(x, k_target=3)
    assert tuning.explain_kernels() == []


# ---------------------------------------------------------------------------
# the package surface mirrors JAX's
# ---------------------------------------------------------------------------

def test_package_surface_mirrors_jax():
    import repro.core
    import repro.models
    import repro.serving
    import repro_torch.core
    import repro_torch.models
    import repro_torch.serving

    not_ported = {"MeshPolicy", "mesh_policy", "find_root_runahead_sharded"}
    assert set(repro_torch.core.__all__) == set(repro.core.__all__) - \
        not_ported
    assert repro_torch.serving.__all__ == repro.serving.__all__
    assert repro_torch.models.__all__ == repro.models.__all__
    for pkg in (repro_torch.core, repro_torch.serving, repro_torch.models):
        assert all(hasattr(pkg, name) for name in pkg.__all__)


# ---------------------------------------------------------------------------
# the launcher: --speculative, --draft-len, --backend auto, --autotune
# ---------------------------------------------------------------------------

def test_launcher_speculative_flags():
    from repro_torch.launch import serve
    from repro_torch.models.testing import reduced_config

    cfg = reduced_config("qwen3-4b")
    base = ["--continuous", "--device", "cpu"]
    assert serve.resolve_draft_len(serve.parse_args(base), cfg) == 1
    row, overhead = tuning.verify_step_cost()
    assert serve.resolve_draft_len(
        serve.parse_args(base + ["--speculative"]), cfg) == \
        tuning.decide_draft_len(acceptance=serve.ACCEPTANCE_PRIOR,
                                token_cost=row, overhead=overhead) > 1
    assert serve.resolve_draft_len(
        serve.parse_args(base + ["--draft-len", "3"]), cfg) == 3
    assert serve.resolve_draft_len(serve.parse_args(
        base + ["--speculative", "--draft-len", "2"]), cfg) == 2
    for argv in (["--speculative"], ["--draft-len", "3"],
                 base + ["--draft-len", "0"], base + ["--backend", "jnp"]):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)


def test_launcher_speculative_autotuned_serve_on_the_cpu(cache):
    """``--continuous --speculative --backend auto --autotune`` serves on
    the CPU, measures its solves into the cache and logs the decisions."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                      "--continuous", "--speculative", "--requests", "2",
                      "--slots", "2", "--prompt-len", "8", "--new-tokens",
                      "3", "--backend", "auto", "--autotune"])
    assert len(out.completions) == 2 and out.scheduler.max_draft_len > 1
    entries = json.loads(cache.read_text())["entries"]
    assert entries and all("pref=auto" in key for key in entries)
