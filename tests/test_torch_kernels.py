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
from repro_torch.kernels import runahead_threshold as rt

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


# K3's cluster scheme (clusters, rows): V at a slice boundary (C*s - 1,
# C*s, C*s + 1 with s = 256), V < C, rows with -inf lanes (lo0 = -inf),
# 30 rounds (the bracket shrinks to a few ulps: repeated grid points),
# spec_k 1 and 8, a row holding +inf and -inf (NaN midpoints: the kernel
# counts directly), no round, and rows whose brackets climb to where
# midpoints overflow (direct counting after rounds of compaction)
CLUSTER_CASES = [
    (1023, 4, 40, 8, 5, "randn"), (1024, 4, 40, 8, 5, "randn"),
    (1025, 4, 40, 8, 5, "randn"), (3, 8, 2, 8, 5, "randn"),
    (10, 16, 3, 8, 3, "randn"), (1000, 4, 40, 8, 5, "neg_inf"),
    (4096, 8, 40, 30, 5, "randn"), (777, 2, 5, 10, 1, "randn"),
    (2000, 4, 40, 3, 8, "randn"), (500, 4, 40, 8, 5, "both_inf"),
    (700, 4, 40, 0, 5, "randn"), (1000, 4, 40, 8, 2, "huge"),
]


def _cluster_rows(V, kind):
    x = _logits(V, seed=V)
    if kind == "neg_inf":
        x[1, ::7] = -np.inf
        x[2, 5:] = -np.inf                # fewer real lanes than k
    elif kind == "both_inf":
        x[0, 3], x[0, 9] = np.inf, -np.inf
        x[2, 11] = -np.inf
    elif kind == "huge":
        x = _huge_rows(x)
    return x


def _huge_rows(x):
    """-1e38 and 100 values in [1.76e38, 1.8e38] among small ones: at
    spec_k 2 two rounds compact, then the top-k bracket's midpoints
    overflow and the kernel counts directly."""
    rng = np.random.default_rng(x.shape[1])
    x[:, 0] = -1e38
    x[:, 1:101] = rng.uniform(1.76e38, 1.8e38, size=(x.shape[0], 100))
    return x


@pytest.mark.parametrize("V,clusters,k_target,rounds,spec_k,kind",
                         CLUSTER_CASES)
def test_runahead_topk_clustered_matches_plain_and_pallas(
        V, clusters, k_target, rounds, spec_k, kind):
    """The CUDA kernel's counting scheme, emulated (slices, binary search
    over the grid, suffix sums of bins), bit for bit against the plain
    version and the Pallas kernel in interpret mode."""
    x = _cluster_rows(V, kind)
    kw = dict(k_target=k_target, rounds=rounds, spec_k=spec_k)
    got = rt.runahead_topk_threshold_clustered(torch.from_numpy(x),
                                               clusters=clusters, **kw)
    plain = rt.runahead_topk_threshold_plain(torch.from_numpy(x), **kw)
    want = jrt.runahead_topk_threshold(jnp.asarray(x), interpret=True, **kw)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      p.numpy().view(np.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


def test_cluster_geometry():
    """K3's split: 16 CTAs a row at the served vocab while B * 16 CTAs fit
    the card's SMs, else 8; one CTA for a small row; 16 wherever 8 slices
    would not fit shared memory; a clear refusal past 16 full CTAs."""
    assert rt.cluster_geometry(4, 151936) == (16, 9496)
    assert rt.cluster_geometry(8, 151936) == (16, 9496)
    assert rt.cluster_geometry(9, 151936) == (8, 18992)
    assert rt.cluster_geometry(64, 151936) == (8, 18992)
    assert rt.cluster_geometry(3, 1000) == (1, 1000)
    assert rt.cluster_geometry(3, 257) == (1, 260)
    assert rt.cluster_geometry(64, 8 * rt.SLICE_MAX + 1)[0] == 16
    for B, V in [(4, 151936), (1, 5), (2, 12289), (1, 16 * rt.SLICE_MAX)]:
        clusters, size = rt.cluster_geometry(B, V)
        assert size % 4 == 0 and size <= rt.SLICE_MAX
        assert (clusters - 1) * size < V <= clusters * size
    with pytest.raises(ValueError, match="does not fit"):
        rt.cluster_geometry(1, 16 * rt.SLICE_MAX + 1)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mc.multi_count_cuda(x, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.multi_count(x, torch.zeros((2, 3), device="meta"))
