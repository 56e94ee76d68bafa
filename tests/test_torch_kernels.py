"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode.

Tolerances: K2 counts and K3 brackets are bit-exact (integer counts and
IEEE midpoints); K4 and K5 use rtol=1e-5, atol=1e-6 because their f32
sums are taken in a different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import multi_count as jmc
from repro.kernels import multi_entropy as jme
from repro.kernels import multi_mass as jmm
from repro.kernels import runahead_threshold as jrt
from repro_torch.core import solver
from repro_torch.kernels import multi_count as mc
from repro_torch.kernels import ops

B = 3
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(V, M) for V in (256, 1000) for M in (1, 31)]


def _logits(V, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, V)) * 2.0
            ).astype(np.float32)


def _between(x, M, seed=1):
    """Candidates spread over each row's range, one equal to an element."""
    rng = np.random.default_rng(seed)
    lo, hi = x.min(-1, keepdims=True), x.max(-1, keepdims=True)
    t = (lo + (hi - lo) * rng.uniform(size=(x.shape[0], M))).astype(np.float32)
    t[:, 0] = x[:, 7]
    return t


@pytest.mark.parametrize("V,M", SHAPES)
def test_multi_count_matches_pallas_exactly(V, M):
    x = _logits(V)
    taus = _between(x, M)
    want = np.asarray(jmc.multi_count(jnp.asarray(x), jnp.asarray(taus),
                                      interpret=True))
    got = ops.multi_count(torch.from_numpy(x), torch.from_numpy(taus))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V,M", SHAPES)
def test_multi_mass_matches_pallas(V, M):
    x = _logits(V)
    p = np.array(jax.nn.softmax(jnp.asarray(x), axis=-1))
    taus = _between(p, M)
    taus[:, -1] = 0.0                     # the engine's bracket probe
    want = np.asarray(jmm.multi_mass(jnp.asarray(p), jnp.asarray(taus),
                                     interpret=True))
    got = ops.multi_mass(torch.from_numpy(p), torch.from_numpy(taus))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("V,M", SHAPES)
def test_multi_entropy_matches_pallas(V, M):
    x = _logits(V)
    z = x - x.max(-1, keepdims=True)
    ts = np.exp(np.random.default_rng(2).uniform(-3, 3, size=(B, M))
                ).astype(np.float32)
    js, jw = jme.multi_entropy_moments(jnp.asarray(z), jnp.asarray(ts),
                                       interpret=True)
    s, w = ops.multi_entropy_moments(torch.from_numpy(z), torch.from_numpy(ts))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    h = ops.multi_entropy(torch.from_numpy(x), torch.from_numpy(ts))
    jh = jme.multi_entropy(jnp.asarray(x), jnp.asarray(ts), interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("V", [256, 1000])
@pytest.mark.parametrize("k_target,rounds,spec_k", [(40, 8, 5), (1, 3, 3)])
def test_runahead_topk_matches_pallas_and_generic_loop(V, k_target, rounds,
                                                       spec_k):
    x = _logits(V, seed=V)
    want = jrt.runahead_topk_threshold(jnp.asarray(x), k_target=k_target,
                                       rounds=rounds, spec_k=spec_k,
                                       interpret=True)
    xt = torch.from_numpy(x)
    got = ops.runahead_topk_threshold(xt, k_target=k_target, rounds=rounds,
                                      spec_k=spec_k)
    # the generic engine loop over plain K2, probing the sign at lo0 as the
    # fused kernel does
    prob = solver.problem("count_above", xt, backend="hopper", k=k_target)
    loop = solver._solve_rounds(prob.multi_eval, prob.lo0, prob.hi0,
                                rounds=rounds, spec_k=spec_k)
    for g, w, l in zip(got, want, loop):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), l.numpy())


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mc.multi_count_cuda(x, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.multi_count(x, torch.zeros((2, 3), device="meta"))
