"""The port's solve engine and applications against the JAX package's.

The JAX side runs under ``tuning.disabled()``: the caller's (rounds,
spec_k) as given; the port's tuner picks its own decomposition of the
same budget, which gives the serial walk's bracket all the same
(``tests/test_torch_tuning.py``).  On the CPU the
"hopper" backend runs its kernels' plain versions.  Count kinds give
identical brackets; mass and entropy agree within rtol=1e-5 (f32 sums in
another order can move a bracket only by rounding noise).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as japps
from repro.core import solver as jsolver
from repro.core import tuning
from repro_torch.core import applications as apps
from repro_torch.core import solver

B, V = 3, 1000
BACKENDS = ["torch", "hopper"]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fixed_decisions():
    with tuning.disabled():
        yield


def _logits(seed=0, v=V):
    return (np.random.default_rng(seed).normal(size=(B, v)) * 2.0
            ).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_midpoint_tree_bit_exact(k):
    rng = np.random.default_rng(k)
    lo = rng.normal(size=(5,)).astype(np.float32)
    hi = lo + rng.uniform(1e-6, 10.0, size=(5,)).astype(np.float32)
    want = jsolver._midpoint_tree(jnp.asarray(lo), jnp.asarray(hi), k)
    got = solver._midpoint_tree(torch.from_numpy(lo), torch.from_numpy(hi), k)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("k,steps", [(1, None), (4, None), (5, None), (5, 2)])
def test_select_walk_bit_exact(k, steps):
    rng = np.random.default_rng(10 + k)
    signs = rng.uniform(size=(16, (1 << k) - 1)) < 0.5
    sign_lo = rng.uniform(size=(16,)) < 0.5
    want = jsolver._select_walk(jnp.asarray(signs), jnp.asarray(sign_lo), k,
                                steps)
    got = solver._select_walk(torch.from_numpy(signs),
                              torch.from_numpy(sign_lo), k, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def _kind_cases():
    x = _logits()
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    k_rows = np.array([1, 40, 300], np.int32)
    # quantile rows of ties (halves) and +0 / -0, one with +inf lanes, one
    # with -inf lanes and a NaN (its bracket is NaN): no subnormal
    ties = np.round(x * 2.0) / 2.0
    ties[:, ::9] = 0.0
    ties[:, 4::9] = -0.0
    ties[1, 5::50] = np.inf
    ties[2, 6::50] = -np.inf
    ties[2, 7] = np.nan
    return [
        ("count_above", x, dict(k=40), True),
        ("count_above", x, dict(k=k_rows), True),
        ("count_below", x, dict(q=0.3141), True),
        ("mass_at_or_above", probs, dict(p=0.9), False),
        ("entropy_at_temperature", x, dict(target=3.0), False),
        ("count_below", ties.astype(np.float32), dict(q=0.3141), True),
        ("count_below", ties.astype(np.float32), dict(q=0.9137), True),
    ]


@functools.cache
def _jax_solve(case, backend="jnp"):
    """The JAX bracket of a case on a JAX backend, computed once for both
    port backends."""
    kind, operand, params, _ = _kind_cases()[case]
    jparams = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in params.items()}
    with tuning.disabled():
        out = jsolver.solve_kind(kind, jnp.asarray(operand), backend=backend,
                                 rounds=8, spec_k=5, **jparams)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(_kind_cases())))
def test_solve_kind_matches_jnp(backend, case):
    """Each kind against JAX's "jnp" backend; count_below also against its
    "pallas" backend (K2 on the negated operand), bit for bit, at a q
    whose q * N is not an integer (QUANTILE_Q below)."""
    kind, operand, params, exact = _kind_cases()[case]
    tparams = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in params.items()}
    got = solver.solve_kind(kind, torch.from_numpy(operand), backend=backend,
                            rounds=8, spec_k=5, **tparams)
    jax_backends = ("jnp", "pallas") if kind == "count_below" else ("jnp",)
    for jax_backend in jax_backends:
        for g, w in zip(got, _jax_solve(case, jax_backend)):
            if exact:
                np.testing.assert_array_equal(_np(g), _np(w))
            else:
                np.testing.assert_allclose(_np(g), _np(w), **FLOAT_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_partial_last_round_matches_jnp(backend):
    """An ``iterations`` cap that spec_k does not divide walks a partial
    last round (and bypasses the fused kernel)."""
    x = _logits(seed=3)
    want = jsolver.solve(jsolver.problem("count_above", jnp.asarray(x), k=17),
                         rounds=0, spec_k=4, iterations=13)
    got = solver.solve(solver.problem("count_above", torch.from_numpy(x),
                                      backend=backend, k=17),
                       rounds=0, spec_k=4, iterations=13)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def _app_inputs():
    x = _logits(seed=4)
    p = np.exp(x - x.max(-1, keepdims=True))
    return x, (p / p.sum(-1, keepdims=True)).astype(np.float32)


# q * N is not an integer: at count / N == q exactly, XLA contracts the
# oracle's count / N - q into fma(count, 1 / N, -q), whose sign is rounding
# noise; the port divides exactly
QUANTILE_Q = 0.3141


@functools.cache
def _jnp_apps():
    x, p = _app_inputs()
    xj = jnp.asarray(x)
    with tuning.disabled():
        out = (japps.topk_mask(xj, 40, backend="jnp"),
               japps.topp_mask(jnp.asarray(p), 0.9, backend="jnp"),
               japps.entropy_temperature(xj, 3.0, backend="jnp"),
               japps.topk_mask(xj[0], 5, backend="jnp"),
               japps.quantile(xj, QUANTILE_Q, backend="jnp"))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("backend", BACKENDS)
def test_application_masks_match_jnp(backend):
    x, p = _app_inputs()
    xt = torch.from_numpy(x)
    topk, topp, temp, topk_row, quant = _jnp_apps()
    np.testing.assert_array_equal(
        _np(apps.topk_mask(xt, 40, backend=backend)), topk)
    np.testing.assert_array_equal(
        _np(apps.topp_mask(torch.from_numpy(p), 0.9, backend=backend)), topp)
    np.testing.assert_allclose(
        _np(apps.entropy_temperature(xt, 3.0, backend=backend)), temp,
        **FLOAT_TOL)
    # a single row comes back unbatched
    np.testing.assert_array_equal(
        _np(apps.topk_mask(xt[0], 5, backend=backend)), topk_row)
    np.testing.assert_array_equal(
        _np(apps.quantile(xt, QUANTILE_Q, backend=backend)), quant)


def test_auto_backend_waits_for_the_tuner():
    """``backend="auto"`` is the tuner's choice (core/tuning.py) among
    the CPU's ("torch", "hopper"), and its bracket is the oracle's."""
    from repro_torch.core import tuning

    x = torch.arange(8, dtype=torch.float32)[None].repeat(2, 1)
    lo, hi = solver.solve_kind("count_above", x, backend="auto", rounds=4,
                               spec_k=3, k=3)
    want = solver.solve_kind("count_above", x, backend="torch", rounds=4,
                             spec_k=3, k=3)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    key, decision = tuning.explain()[-2]
    assert "pref=auto" in key and decision.backend in ("torch", "hopper")
