"""The port's paper core (serial and runahead bisection, the Taylor f and
its kernel K1's plain version, the Table 1 launcher) against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Roots, brackets, midpoints and walks must match bit for bit, in float32
and float64.  So must the Taylor series, with one stated exception: at
``terms=2`` each recurrence runs one step, XLA unrolls that single-trip
loop, folds the constant denominator into a reciprocal multiply and
contracts it with the add into an FMA, so JAX's own value differs from an
IEEE division by one rounding of the operands (one ulp of a value up to
1, 1.2e-7 in float32); those values are held at rtol 1e-6 plus an atol of
two ulps at 1.0 (the result can cancel to well below its operands), and
the roots they give still match bit for bit.  JAX's Pallas kernel K1
runs in interpret mode, as its own tests run it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import bisect as jbisect
from repro.core import paper_functions as jpf
from repro.core import runahead as jrunahead
from repro.kernels.taylor_eval import taylor_sincos_eval as jtaylor_kernel
from repro_torch.core import bisect, paper_functions, runahead, solver
from repro_torch.kernels import ops, taylor_eval
from repro_torch.launch import paper
import torch_one_thread  # noqa: F401 (one torch thread)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@pytest.fixture(autouse=True, scope="module")
def _x64_for_this_module_only():
    """float64 cases need JAX's x64 flag; it is global, so restore it."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _both(fn_of_module):
    """The same function built over jnp and over torch."""
    return fn_of_module(jnp), fn_of_module(torch)


def _poly(roots):
    def build(mod):
        def f(x):
            y = mod.ones_like(x)
            for r in roots:
                y = y * (x - r)
            return y

        return f

    return _both(build)


def _paper_f(terms):
    return jpf.make_paper_f(terms), paper_functions.make_paper_f(terms)


def _ends(dtype, a=1.0, b=2.0):
    npd, td = DTYPES[dtype]
    return ((jnp.asarray(npd(a)), jnp.asarray(npd(b))),
            (torch.tensor(a, dtype=td), torch.tensor(b, dtype=td)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the Taylor f and K1's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("terms", [2, 10, 100])
def test_taylor_series_match_jax(dtype, terms):
    x = np.random.default_rng(terms).uniform(-2.5, 2.5, size=257).astype(
        DTYPES[dtype][0])
    for jfn, tfn in ((lambda v: jpf.taylor_cos(v, terms),
                      lambda v: paper_functions.taylor_cos(v, terms)),
                     (lambda v: jpf.taylor_sin(v, terms),
                      lambda v: paper_functions.taylor_sin(v, terms)),
                     _paper_f(terms)):
        want = np.asarray(jfn(jnp.asarray(x)))
        got = tfn(torch.from_numpy(x)).numpy()
        if terms == 2:      # XLA's single-trip fold, see the module note
            ulp = np.finfo(DTYPES[dtype][0]).eps
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=2 * ulp)
        else:
            _eq(got, want)


@pytest.mark.parametrize("m", [1, 31, 127, 130])
@pytest.mark.parametrize("terms", [10, 100, 2500])
def test_plain_k1_matches_pallas_interpret(m, terms):
    """2500 terms pass i = 2048, where the f32 denominator starts to
    round: it must round in the same place."""
    x = np.random.default_rng(m).uniform(0.5, 2.5, size=m).astype(np.float32)
    want = np.asarray(jtaylor_kernel(jnp.asarray(x), terms=terms,
                                     interpret=True))
    got = taylor_eval.taylor_sincos_plain(torch.from_numpy(x), terms=terms)
    _eq(got.numpy(), want)
    # the wrapper takes the plain version on the CPU, and casts to f32
    _eq(ops.taylor_sincos_eval(torch.from_numpy(x).double(), terms=terms),
        want)


def test_k1_wrapper_on_cpu_launches_nothing():
    ops.reset_launches()
    ops.taylor_sincos_eval(torch.linspace(1, 2, 7), terms=10)
    assert ops.LAUNCHES["taylor_sincos_eval"] == 0


# ---------------------------------------------------------------------------
# serial bisection (Algorithm 1)
# ---------------------------------------------------------------------------

# one closure per function for the whole module, so JAX compiles each
# (function, static arguments) pair once
FUNCS = {"poly": _poly([1.3]), "multi": _poly([1.1, 1.5, 1.8]),
         "paper2": _paper_f(2), "paper10": _paper_f(10),
         "paper100": _paper_f(100)}
PAPER30 = _paper_f(30)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("func", list(FUNCS))
@pytest.mark.parametrize("mode", ["product", "signbit"])
def test_serial_matches_jax(dtype, func, mode):
    jf, tf = FUNCS[func]
    (ja, jb), (ta, tb) = _ends(dtype)
    want = jbisect.find_root_serial(jf, ja, jb, 17, mode)
    got = bisect.find_root_serial(tf, ta, tb, 17, mode)
    assert got.dtype == DTYPES[dtype][1]
    _eq(got, want)


def test_serial_zero_midpoint_modes_and_no_early_exit():
    """An exact zero at the first midpoint: product mode goes right,
    signbit goes left, and neither stops iterating."""
    _, f = _poly([0.5])
    a, b = torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)
    assert float(bisect.find_root_serial(f, a, b, 2, "product")) == 0.75
    assert float(bisect.find_root_serial(f, a, b, 2, "signbit")) == 0.25
    assert float(bisect.find_root_serial(f, a, b, 1)) == 0.5
    assert float(bisect.find_root_serial(f, a, b, 10)) != 0.5
    assert bisect.iterations_for_error(1.0, 2.0, 2.0 ** -6) == 6
    with pytest.raises(ValueError, match="mode"):
        bisect.find_root_serial(f, a, b, 2, "bogus")


# ---------------------------------------------------------------------------
# runahead bisection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("iterations", [1, 3, 6, 12, 17, 24])
def test_runahead_bitexact_vs_serial(spec_k, iterations):
    """The grid of tests/test_core_bisection.py: port runahead (walk)
    equals port serial (signbit), and both equal JAX's serial root."""
    jf, tf = PAPER30
    (ja, jb), (ta, tb) = _ends("float64")
    rs = bisect.find_root_serial(tf, ta, tb, iterations, mode="signbit")
    rr = runahead.find_root_runahead(tf, ta, tb, iterations, spec_k)
    _eq(rr, rs)
    _eq(rr, jbisect.find_root_serial(jf, ja, jb, iterations, "signbit"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("func", list(FUNCS))
@pytest.mark.parametrize("select", ["walk", "xor"])
def test_runahead_matches_jax(dtype, func, select):
    jf, tf = FUNCS[func]
    (ja, jb), (ta, tb) = _ends(dtype)
    # 17 steps at k = 3: five full rounds and a partial one
    want = jrunahead.find_root_runahead(jf, ja, jb, 17, 3, select)
    _eq(runahead.find_root_runahead(tf, ta, tb, 17, 3, select), want)


@pytest.mark.parametrize("select", ["walk", "xor"])
def test_runahead_multi_eval_hook_matches_jax(select):
    """The same vector evaluator through ``multi_eval``, one call per
    round (and one at a)."""
    jf, tf = FUNCS["paper10"]
    (ja, jb), (ta, tb) = _ends("float32")
    calls = []

    def counted(x):
        calls.append(x.shape)
        return tf(x)

    want = jrunahead.find_root_runahead(jf, ja, jb, 12, 2, select,
                                        multi_eval=jf)
    _eq(runahead.find_root_runahead(None, ta, tb, 12, 2, select,
                                    multi_eval=counted), want)
    assert calls == [(1,)] + [(3,)] * 6


@given(root=st.floats(0.05, 0.95), spec_k=st.integers(1, 5),
       iterations=st.integers(1, 30))
@settings(max_examples=40, deadline=None)
def test_property_runahead_walk_equals_serial(root, spec_k, iterations):
    _, f = _poly([root])
    a, b = torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)
    _eq(runahead.find_root_runahead(f, a, b, iterations, spec_k),
        bisect.find_root_serial(f, a, b, iterations, mode="signbit"))


@given(r1=st.floats(0.1, 0.4), r2=st.floats(0.45, 0.6),
       r3=st.floats(0.65, 0.9), spec_k=st.integers(1, 4))
@settings(max_examples=25, deadline=None)
def test_multiple_roots_walk_still_matches_serial(r1, r2, r3, spec_k):
    """Three roots: the sign vector is not monotone, but the walk tracks
    Algorithm 1 exactly."""
    _, f = _poly([r1, r2, r3])
    a, b = torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)
    _eq(runahead.find_root_runahead(f, a, b, 24, spec_k),
        bisect.find_root_serial(f, a, b, 24, mode="signbit"))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_views_match_jax(dtype):
    npd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 0.4, size=8).astype(npd)
    b = rng.uniform(0.6, 1.0, size=8).astype(npd)
    jf, tf = FUNCS["poly"]
    a, b = a * 2 + 0.5, b * 2 + 0.5        # brackets around 1.3
    for mode in ("product", "signbit"):
        _eq(bisect.find_root_serial_batched(tf, torch.from_numpy(a),
                                            torch.from_numpy(b), 20, mode),
            jbisect.find_root_serial_batched(jf, jnp.asarray(a),
                                             jnp.asarray(b), 20, mode))
    for select in ("walk", "xor"):
        got = runahead.find_root_runahead_batched(
            tf, torch.from_numpy(a), torch.from_numpy(b), 20, 3, select)
        want = jrunahead.find_root_runahead_batched(
            jf, jnp.asarray(a), jnp.asarray(b), 20, 3, select)
        _eq(got, want)
        assert got.dtype == td


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rounds,spec_k", [(1, 1), (4, 3), (5, 5)])
def test_runahead_solve_matches_jax(dtype, rounds, spec_k):
    jf, tf = FUNCS["paper10"]
    (ja, jb), (ta, tb) = _ends(dtype)
    want = jrunahead.runahead_solve(jf, ja, jb, rounds=rounds, spec_k=spec_k)
    got = runahead.runahead_solve(tf, ta, tb, rounds=rounds, spec_k=spec_k)
    for g, w in zip(got, want):
        _eq(g, w)
    assert runahead.serial_equivalent_iterations(rounds, spec_k) == (
        jrunahead.serial_equivalent_iterations(rounds, spec_k))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_engine_grid_and_walk_are_the_scalar_pair(k):
    """runahead.py reuses the engine's _midpoint_tree and _select_walk on
    a batch of one; they compute the JAX scalar pair's values."""
    rng = np.random.default_rng(k)
    tree = jax.jit(jrunahead._midpoint_tree, static_argnums=2)
    walk = jax.jit(jrunahead._select_walk, static_argnums=2)
    xor = jax.jit(jrunahead._select_xor, static_argnums=2)
    for _ in range(3):
        lo = np.float32(rng.normal())
        hi = np.float32(lo + rng.uniform(1e-6, 10.0))
        want = tree(jnp.float32(lo), jnp.float32(hi), k)
        got = solver._midpoint_tree(torch.tensor([lo]), torch.tensor([hi]),
                                    k)[0]
        _eq(got, want)
        signs = rng.uniform(size=(1 << k) - 1) < 0.5
        sign_lo = bool(rng.uniform() < 0.5)
        for steps in range(1, k + 1):
            want = walk(jnp.asarray(signs), jnp.asarray(sign_lo), k,
                        jnp.int32(steps))
            got = solver._select_walk(torch.from_numpy(signs)[None],
                                      torch.tensor([sign_lo]), k, steps)
            for g, w in zip(got, want):
                assert int(g[0]) == int(w)
        want = xor(jnp.asarray(signs), jnp.asarray(sign_lo), k)
        got = runahead._select_xor(torch.from_numpy(signs)[None],
                                   torch.tensor([sign_lo]), k)
        assert [int(g[0]) for g in got] == [int(w) for w in want]


def test_runahead_rejects_unknown_select():
    _, f = _poly([0.5])
    with pytest.raises(ValueError, match="select"):
        runahead.find_root_runahead(f, 0.0, 1.0, 4, 2, select="bogus")


# ---------------------------------------------------------------------------
# the Table 1 launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("terms", [10, 100])
def test_launcher_evaluator_roots_equal_make_paper_f(terms):
    """The evaluator launch/paper.py hands both solvers (K1's wrapper)
    gives the roots the plain ``make_paper_f`` gives, and JAX's."""
    a, b = paper.interval("cpu")
    f = paper.evaluator(terms)
    ref = paper_functions.make_paper_f(terms)
    jf = jpf.make_paper_f(terms)
    for n in (6, 24):
        want = bisect.find_root_serial(ref, a, b, n, "signbit")
        _eq(bisect.find_root_serial(f, a, b, n, "signbit"), want)
        for k in (1, 3, 5):
            _eq(runahead.find_root_runahead(f, a, b, n, k), want)
        _eq(want, jbisect.find_root_serial(jf, jnp.float32(1.0),
                                           jnp.float32(2.0), n, "signbit"))


def test_launcher_runs_both_sweeps_on_cpu():
    ops.reset_launches()
    rows = paper.main(["--device", "cpu", "--fig4-terms", "20",
                       "--fig7-terms", "10", "--reps", "1"])
    assert [(r.fig, r.k) for r in rows] == (
        [("fig4", k) for k in paper.FIG4_KS] + [("fig7", paper.FIG7_K)])
    assert all(r.serial_ms > 0 and r.runahead_ms > 0 for r in rows)
    assert abs(rows[0].root - math.pi / 2) < 2.0 ** -20
    assert rows[-1].rounds == 2
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper.main(["--fig4-terms", "10", "--fig7-terms", "10"])
