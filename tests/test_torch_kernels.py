"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode.

Tolerances: K2 counts and K3 brackets are bit-exact (integer counts and
IEEE midpoints); K4 and K5 use rtol=1e-5, atol=1e-6 because their f32
sums are taken in a different order (and K5's kernel forms exp(z / T) as
2 ** (z * log2(e) / T)).  NaN brackets compare as NaN bits: every version
here propagates the input's NaN.
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
from repro_torch.kernels import multi_entropy as me
from repro_torch.kernels import multi_mass as mm
from repro_torch.kernels import ops
from repro_torch.kernels import row_reduce as rr
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


def _special(x, taus):
    """Rows with +0 and -0 in every fifth lane, NaN lanes in row 0, +inf
    and -inf lanes in row 2; candidates -0, +0, +inf, -inf and NaN where
    M has room (after the one equal to an element)."""
    x, taus = x.copy(), taus.copy()
    x[:, 1::5] = 0.0
    x[:, 2::5] = -0.0
    x[0, 3::7] = np.nan
    x[2, 4::11] = np.inf
    x[2, 6::13] = -np.inf
    room = max(0, taus.shape[1] - 1)
    for i, v in enumerate((-0.0, 0.0, np.inf, -np.inf, np.nan)[:room]):
        taus[:, i + 1] = v
    return x, taus


# K2 counting above (the Pallas kernel) and below (JAX's count_below runs
# the Pallas kernel on the negated operand and candidates), on random rows
# and on rows of NaN, +-inf and +-0 with such candidates
K2_CASES = [pytest.param(V, M, False, False, id=f"{V}-{M}")
            for V, M in SHAPES] + [
    pytest.param(V, M, special, below, id=f"{V}-{M}-"
                 f"{'special' if special else 'randn'}-"
                 f"{'below' if below else 'above'}")
    for V, M in SHAPES for special, below in
    ((True, False), (False, True), (True, True))]


@pytest.mark.parametrize("V,M,special,below", K2_CASES)
def test_multi_count_matches_pallas_exactly(V, M, special, below):
    x = _logits(V)
    taus = _between(x, M)
    if special:
        x, taus = _special(x, taus)
    sign = -1.0 if below else 1.0
    want = np.asarray(jmc.multi_count(jnp.asarray(sign * x),
                                      jnp.asarray(sign * taus),
                                      interpret=True))
    got = ops.multi_count(torch.from_numpy(x), torch.from_numpy(taus),
                          below=below)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mc.multi_count_plain(torch.from_numpy(x), torch.from_numpy(taus),
                             below).numpy(), want)


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
# counts directly), no round, rows whose brackets climb to where
# midpoints overflow (direct counting after rounds of compaction), and
# rows holding NaN (one lane, every lane: the bracket is (NaN, NaN), as
# jnp.min / jnp.max give lo0 and hi0)
CLUSTER_CASES = [
    (1023, 4, 40, 8, 5, "randn"), (1024, 4, 40, 8, 5, "randn"),
    (1025, 4, 40, 8, 5, "randn"), (3, 8, 2, 8, 5, "randn"),
    (10, 16, 3, 8, 3, "randn"), (1000, 4, 40, 8, 5, "neg_inf"),
    (4096, 8, 40, 30, 5, "randn"), (777, 2, 5, 10, 1, "randn"),
    (2000, 4, 40, 3, 8, "randn"), (500, 4, 40, 8, 5, "both_inf"),
    (700, 4, 40, 0, 5, "randn"), (1000, 4, 40, 8, 2, "huge"),
    (1000, 4, 40, 8, 5, "nan"), (1000, 4, 40, 8, 5, "all_nan"),
    (700, 4, 40, 0, 5, "nan"),
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
    elif kind == "nan":                   # one NaN lane in row 1
        x[1, 40] = np.nan
    elif kind == "all_nan":               # row 2 all NaN
        x[2] = np.nan
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


# K4 and K5 in their kernels' scheme: ragged V (1000: one block a row,
# its last unit part-filled; 4093: four blocks a row and a one-element
# tail), M of one candidate, one short of a 32-candidate tile and one
# past it; K5 at the engine's extreme temperatures with JAX's -1e30 pad
# sentinel in the rows
ROW_REDUCE_CASES = [(V, M) for V in (1000, 4093) for M in (1, 31, 33)]


@pytest.mark.parametrize("t", [0.05, 20.0])
@pytest.mark.parametrize("V,M", ROW_REDUCE_CASES)
def test_multi_entropy_emulated_matches_plain_and_pallas(V, M, t):
    """K5's arithmetic (one exp2 of z * RN(log2(e) / T) a pair, w as
    (sum z e) / T) summed in its block split, against the plain version
    and the Pallas kernel in interpret mode."""
    x = _logits(V, seed=V + M)
    z = x - x.max(-1, keepdims=True)
    z[1, ::5] = -1e30
    z[2, 3] = -1e30
    ts = np.full((B, M), t, np.float32)
    if M > 1:
        ts[:, 1:] = np.linspace(1.0, t, M - 1)
    got = me.multi_entropy_moments_emulated(torch.from_numpy(z),
                                            torch.from_numpy(ts))
    plain = me.multi_entropy_moments_plain(torch.from_numpy(z),
                                           torch.from_numpy(ts))
    want = jme.multi_entropy_moments(jnp.asarray(z), jnp.asarray(ts),
                                     interpret=True)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("V,M", ROW_REDUCE_CASES)
def test_multi_mass_emulated_matches_plain_and_pallas(V, M):
    x = _logits(V, seed=V + M)
    p = np.array(jax.nn.softmax(jnp.asarray(x), axis=-1))
    taus = _between(p, M)
    taus[:, -1] = 0.0                     # the engine's bracket probe
    got = mm.multi_mass_emulated(torch.from_numpy(p), torch.from_numpy(taus))
    want = jmm.multi_mass(jnp.asarray(p), jnp.asarray(taus), interpret=True)
    np.testing.assert_allclose(got.numpy(), mm.multi_mass_plain(
        torch.from_numpy(p), torch.from_numpy(taus)).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_row_reduce_geometry():
    """K4/K5's grid: one block per SM spread over the rows, at least one a
    row, no more than the row's 128-element units fill; and every element
    of a row in exactly one block, whatever its alignment."""
    assert rr.blocks_per_row(4, 151936, 132) == 33
    assert rr.blocks_per_row(1, 151936, 132) == 132
    assert rr.blocks_per_row(64, 151936, 132) == 2
    assert rr.blocks_per_row(200, 151936, 132) == 1
    assert rr.blocks_per_row(3, 1000, 132) == 1
    assert rr.blocks_per_row(3, 4093, 132) == 4
    for V in (1, 3, 5, 127, 129, 1000, 4093, 4099):
        for nb in (1, 2, 3, 7, 33):
            for head in range(4):
                idx = torch.cat(rr.block_indices(V, nb, head))
                assert torch.equal(idx.sort().values, torch.arange(V))


def test_row_reduce_scratch_grows_and_keeps_what_it_outgrew():
    """K4/K5's cached scratch: reused while it is big enough; outgrown, a
    new one at the larger of each size (tickets at 0), the old one kept
    alive for a CUDA graph captured on it."""
    dev = torch.device("cpu")
    rr._SCRATCH.pop(dev.index, None)
    first = rr.scratch(dev, 100, 4)
    assert rr.scratch(dev, 50, 2)[0] is first[0]
    grown = rr.scratch(dev, 40, 8)
    assert grown[0].numel() == 100 and grown[1].numel() == 8
    assert not grown[1].any() and grown[1].dtype == torch.int32
    held = rr._SCRATCH.pop(dev.index)
    assert len(held) == 2 and held[0][0] is first[0]


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
