"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device.  On a
GPU machine run ``python -m pytest -m cuda tests/test_torch_cuda.py``
(this file imports no JAX).  K1, K2 and K3 must match exactly (K3's
cluster kernel also against the CPU emulation of its scheme, K1's
division step against the card's IEEE division; K3's NaN brackets with
every NaN taken as one); K4 and K5 within rtol=1e-5, atol=1e-6 (f32 sums
in another order, K5's exponentials by ex2.approx) up to the served
vocab, and bit for bit from one run to the next, between eager calls and
CUDA-graph replay and across calls at two batch sizes, one kernel launch
a call; K6 within rtol=atol=1e-5 on f32 pools and
one bf16 ulp on bf16 pools compared in f32 (exp and the sums in another
order), against the plain version with one split and with the kernel's
own split count (1 to 34 splits, masked splits included), and bit for
bit from one run to the next.  K7 (flash_fwd) within atol 2e-5
/ rtol 1e-4 on f32 (JAX's own K7 tolerance: the online softmax rescales
at other tile edges); on bf16 (tensor cores, p rounded to bf16 before
P.V) by ``flash_fwd.bf16_check``: its largest |diff| from the f32
reference on the same inputs at most the bf16 plain version's plus one
bf16 ulp, and every element within one bf16 ulp of itself plus one of
its row's largest of the bf16 plain version at the kernel's key tile;
and that check fails kernels built with faults planted in rows past
2560 of 4096.  Both dtypes bit for bit from one run to the next and
between grouped GQA and K/V repeated to every head (the same values
summed in the same order); its gradients against the chunked
flash_attend's on the card within 1e-4 (the same backward, another
forward summation).
"""
import pytest
import torch

from repro_torch.core import solver
from repro_torch.kernels import flash_fwd as ff
from repro_torch.kernels import multi_count as mc
from repro_torch.kernels import multi_entropy as me
from repro_torch.kernels import multi_mass as mm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attend as pa
from repro_torch.kernels import runahead_threshold as rt
from repro_torch.kernels import taylor_eval as te

pytestmark = pytest.mark.cuda
SHAPES = [(1, 1, 1), (3, 257, 31), (2, 1000, 1), (4, 4099, 70)]
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, V, M):
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    t = torch.randn((B, M), generator=gen, device="cuda") * 2.0
    t[:, 0] = x[:, 0]
    return x, t


@pytest.mark.parametrize("B,V,M", SHAPES)
def test_multi_count(gen, B, V, M):
    x, t = _inputs(gen, B, V, M)
    assert torch.equal(mc.multi_count_cuda(x, t), mc.multi_count_plain(x, t))
    # strided candidate rows, as the engine passes grid[:, 1:-1]
    grid = torch.randn((B, M + 2), generator=gen, device="cuda")
    assert torch.equal(mc.multi_count_cuda(x, grid[:, 1:-1]),
                       mc.multi_count_plain(x, grid[:, 1:-1]))


@pytest.mark.parametrize("B,V,M", SHAPES)
def test_multi_mass(gen, B, V, M):
    x, _ = _inputs(gen, B, V, M)
    p = torch.softmax(x, dim=-1)
    t = torch.rand((B, M), generator=gen, device="cuda") * p.amax()
    got = mm.multi_mass_cuda(p, t)
    assert torch.equal(got, mm.multi_mass_cuda(p, t))
    torch.testing.assert_close(got, mm.multi_mass_plain(p, t), **TOL)


@pytest.mark.parametrize("B,V,M", SHAPES)
def test_multi_entropy_moments(gen, B, V, M):
    x, _ = _inputs(gen, B, V, M)
    z = x - x.amax(dim=-1, keepdim=True)
    ts = torch.rand((B, M), generator=gen, device="cuda") * 5.0 + 0.05
    got = me.multi_entropy_moments_cuda(z, ts)
    again = me.multi_entropy_moments_cuda(z, ts)
    for g, a, w in zip(got, again, me.multi_entropy_moments_plain(z, ts)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, **TOL)


# K4 and K5 at the served vocab and its ragged neighbours (rows off 16-byte
# alignment past row 0), one row to 64, M across the 32-candidate tile
ROW_REDUCE_SERVED = [(B, V) for B in (1, 4, 64)
                     for V in (151935, 151936, 151937)]
ROW_REDUCE_M = (1, 31, 32, 33, 255)


def _by_tiles(plain, x, cand):
    """The plain version 32 candidates at a time (its (B, M, V)
    intermediates stay small at B = 64, M = 255), joined."""
    parts = [plain(x, cand[:, i:i + 32]) for i in range(0, cand.shape[1], 32)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("B,V", ROW_REDUCE_SERVED)
def test_multi_mass_served_width(gen, B, V):
    """K4 within tolerance of the plain version and bit for bit run to run,
    candidates as strided rows of a grid (the engine's grid[:, 1:-1]), one
    equal to an element and the engine's tau = 0 probe among them."""
    p = torch.softmax(torch.randn((B, V), generator=gen, device="cuda") * 3.0,
                      dim=-1)
    for M in ROW_REDUCE_M:
        grid = torch.rand((B, M + 2), generator=gen, device="cuda") * p.amax()
        grid[:, -2] = 0.0
        grid[:, 1] = p[:, 7]
        taus = grid[:, 1:-1]
        got = mm.multi_mass_cuda(p, taus)
        assert torch.equal(got, mm.multi_mass_cuda(p, taus))
        torch.testing.assert_close(got, _by_tiles(mm.multi_mass_plain, p,
                                                  taus), **TOL)


@pytest.mark.parametrize("B,V", ROW_REDUCE_SERVED)
def test_multi_entropy_served_width(gen, B, V):
    """K5 within tolerance of the plain version and bit for bit run to run,
    temperatures as strided rows of a grid holding the engine's bracket
    (0.05 and 20), rows with JAX's -1e30 pad sentinel."""
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    z = x - x.amax(dim=-1, keepdim=True)
    z[0, 1::97] = -1e30
    for M in ROW_REDUCE_M:
        grid = torch.exp(torch.empty((B, M + 2), device="cuda").uniform_(
            -3.0, 3.0, generator=gen))
        grid[:, -2] = 20.0
        grid[:, 1] = 0.05
        ts = grid[:, 1:-1]
        got = me.multi_entropy_moments_cuda(z, ts)
        again = me.multi_entropy_moments_cuda(z, ts)
        want = _by_tiles(me.multi_entropy_moments_plain, z, ts)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            torch.testing.assert_close(g, w, **TOL)


def _row_reduce_calls(gen, B):
    """Inputs of K4 and K5 at the served vocab, and a call of both."""
    x = torch.randn((B, 151936), generator=gen, device="cuda") * 2.0
    p = torch.softmax(x, dim=-1)
    z = x - x.amax(dim=-1, keepdim=True)
    taus = (torch.rand((B, 33), generator=gen, device="cuda") * 1e-4)[:, 1:-1]
    ts = torch.exp(torch.empty((B, 33), device="cuda").uniform_(
        -3.0, 3.0, generator=gen))[:, 1:-1]
    return lambda: (mm.multi_mass_cuda(p, taus),
                    *me.multi_entropy_moments_cuda(z, ts))


def test_row_reduce_graph_replay_and_batches_back_to_back(gen):
    """K4 and K5 bit for bit between eager calls and CUDA-graph replay,
    and across back-to-back calls at B = 4 and B = 64 (a ticket left
    non-zero, or one call's sums read by another, would show)."""
    calls = {B: _row_reduce_calls(gen, B) for B in (4, 64)}
    eager = {B: call() for B, call in calls.items()}
    for B in (64, 4, 64, 4):
        for got, want in zip(calls[B](), eager[B]):
            assert torch.equal(got, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[4]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls[4]()
    for _ in range(3):
        graph.replay()
        calls[64]()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager[4]):
        assert torch.equal(got, want)
    for got, want in zip(calls[64](), eager[64]):
        assert torch.equal(got, want)


def test_row_reduce_one_launch_per_call(gen):
    """One device kernel per K4 and per K5 call, and the wrappers count it;
    both refuse candidates of another row count."""
    from torch.profiler import ProfilerActivity, profile

    call = _row_reduce_calls(gen, 4)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(kernels) == 2 and set(kernels.values()) == {1}, kernels
    assert any("multi_mass_kernel" in k for k in kernels), kernels
    assert any("multi_entropy_kernel" in k for k in kernels), kernels
    x = torch.rand((2, 300), generator=gen, device="cuda")
    ops.reset_launches()
    ops.multi_mass(x, x[:, :5])
    ops.multi_entropy_moments(-x, x[:, :5] + 0.1)
    assert ops.LAUNCHES["multi_mass"] == 1
    assert ops.LAUNCHES["multi_entropy_moments"] == 1
    with pytest.raises(ValueError, match="taus must be"):
        mm.multi_mass_cuda(x, x[:1, :5])
    with pytest.raises(ValueError, match="ts must be"):
        me.multi_entropy_moments_cuda(-x, x[:1, :5])


def test_row_reduce_stage_clock(gen):
    """The stage-clock builds of K4 and K5 run, and every stage's time
    comes after the one before it."""
    from repro_torch.kernels import row_reduce as rr

    x = torch.randn((4, 151936), generator=gen, device="cuda")
    cand = torch.rand((4, 31), generator=gen, device="cuda") + 0.5
    for name, operand, k_acc in (("multi_mass", torch.softmax(x, -1), 1),
                                 ("multi_entropy",
                                  x - x.amax(-1, keepdim=True), 2)):
        stages = rr.stage_times(name, operand, cand, k_acc, calls=3)
        medians = [stages[s][1] for s in rr.STAGES]
        assert all(a <= b for a, b in zip(medians, medians[1:])), stages
        assert medians[-1] > 0, stages


@pytest.mark.parametrize("B,V,M", SHAPES)
@pytest.mark.parametrize("k_target,rounds,spec_k", [(1, 8, 5), (40, 3, 8),
                                                    (7, 10, 1)])
def test_runahead_topk(gen, B, V, M, k_target, rounds, spec_k):
    x, _ = _inputs(gen, B, V, M)
    kw = dict(k_target=k_target, rounds=rounds, spec_k=spec_k)
    got = rt.runahead_topk_threshold_cuda(x, **kw)
    want = rt.runahead_topk_threshold_plain(x, **kw)
    prob = solver.problem("count_above", x, backend="hopper", k=k_target)
    loop = solver._solve_rounds(prob.multi_eval, prob.lo0, prob.hi0,
                                rounds=rounds, spec_k=spec_k)
    for g, w, l in zip(got, want, loop):
        assert torch.equal(g, w) and torch.equal(g, l)


def test_wrappers_count_launches_and_refuse_bad_input(gen):
    x, t = _inputs(gen, 2, 300, 5)
    ops.reset_launches()
    ops.multi_count(x, t)
    ops.runahead_topk_threshold(x, k_target=3, rounds=2, spec_k=3)
    assert ops.LAUNCHES["multi_count"] == 1
    assert ops.LAUNCHES["runahead_topk_threshold"] == 1
    with pytest.raises(ValueError, match="spec_k"):
        rt.runahead_topk_threshold_cuda(x, k_target=3, spec_k=9)
    with pytest.raises(ValueError, match="float32"):
        mc.multi_count_cuda(x.double(), t)
    with pytest.raises(ValueError, match="column stride"):
        mc.multi_count_cuda(x.t(), t)


@pytest.mark.parametrize("m", [1, 7, 31, 130])
@pytest.mark.parametrize("terms", [1, 10, 2500])
def test_taylor_sincos(gen, m, terms):
    """Bit for bit: 2500 terms pass i = 2048, where the f32 denominator
    starts to round."""
    x = torch.rand((m,), generator=gen, device="cuda") * 2.0 + 0.5
    assert torch.equal(te.taylor_sincos_cuda(x, terms=terms),
                       te.taylor_sincos_plain(x, terms=terms))


# K3's cluster: (B, V, clusters, k, rounds, spec_k, rows) -- V around a
# slice boundary (C*s - 1, C*s, C*s + 1), V < C, -inf lanes (lo0 = -inf),
# 30 rounds (repeated grid points), spec_k 1 and 8, a row with +inf and
# -inf (NaN midpoints: counted directly), no round, brackets that climb
# until midpoints overflow (direct counting after compacting rounds); then
# the served width at B = 1, 4 and 64 with the default geometry (16 CTAs
# a row at B <= 8, else 8); rows holding NaN (one lane, every lane), whose
# bracket is (NaN, NaN)
CLUSTER_CASES = [
    (3, 1023, 4, 40, 8, 5, "randn"), (3, 1024, 4, 40, 8, 5, "randn"),
    (3, 1025, 4, 40, 8, 5, "randn"), (3, 3, 8, 2, 8, 5, "randn"),
    (2, 10, 16, 3, 8, 3, "randn"), (3, 1000, 4, 40, 8, 5, "neg_inf"),
    (3, 4096, 8, 40, 30, 5, "randn"), (3, 777, 2, 5, 10, 1, "randn"),
    (3, 2000, 4, 40, 3, 8, "randn"), (3, 500, 4, 40, 8, 5, "both_inf"),
    (1, 151936, None, 40, 8, 5, "randn"), (4, 151936, None, 40, 8, 5, "randn"),
    (64, 151936, None, 40, 8, 5, "randn"),
    (4, 151936, None, 40, 30, 5, "neg_inf"), (4, 151936, 16, 40, 8, 5, "randn"),
    (4, 151935, 8, 1, 8, 5, "randn"), (4, 151937, 8, 40, 8, 8, "randn"),
    (3, 700, 4, 40, 0, 5, "randn"), (3, 1000, 4, 40, 8, 2, "huge"),
    (4, 151936, None, 40, 8, 2, "huge"), (4, 151936, 8, 40, 1, 5, "randn"),
    (3, 1000, 4, 40, 8, 5, "nan"), (3, 1000, 4, 40, 8, 5, "all_nan"),
    (3, 700, 4, 40, 0, 5, "nan"), (4, 151936, None, 40, 8, 5, "nan"),
    (4, 151936, None, 40, 8, 5, "all_nan"),
]


def _bits(t):
    """t's bits, every NaN as one NaN: the card's arithmetic makes the
    canonical NaN, while min and max on the CPU keep the input's."""
    return torch.where(t.isnan(), torch.full_like(t, float("nan")),
                       t).view(torch.int32)


@pytest.mark.parametrize("B,V,clusters,k_target,rounds,spec_k,kind",
                         CLUSTER_CASES)
def test_runahead_topk_cluster(gen, B, V, clusters, k_target, rounds, spec_k,
                               kind):
    """The cluster kernel bit for bit against the plain version, the
    generic engine loop over K2 and the CPU emulation of its scheme."""
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    if kind == "neg_inf":
        x[1, ::7] = float("-inf")
        x[-1, 5:] = float("-inf")           # fewer real lanes than k
    elif kind == "both_inf":
        x[0, 3], x[0, 9] = float("inf"), float("-inf")
    elif kind == "huge":
        x[:, 0] = -1e38
        x[:, 1:101] = torch.empty((B, 100), device="cuda").uniform_(
            1.76e38, 1.8e38, generator=gen)
    elif kind == "nan":
        x[1, 40] = float("nan")
    elif kind == "all_nan":
        x[-1] = float("nan")
    kw = dict(k_target=k_target, rounds=rounds, spec_k=spec_k)
    got = rt.runahead_topk_threshold_cuda(x, clusters=clusters, **kw)
    want = rt.runahead_topk_threshold_plain(x, **kw)
    emulated = rt.runahead_topk_threshold_clustered(x, clusters=clusters, **kw)
    prob = solver.problem("count_above", x, backend="hopper", k=k_target)
    loop = solver._solve_rounds(prob.multi_eval, prob.lo0, prob.hi0,
                                rounds=rounds, spec_k=spec_k)
    for g, w, e, l in zip(got, want, emulated, loop):
        bits = _bits(g)
        assert torch.equal(bits, _bits(w))
        assert torch.equal(bits, _bits(e))
        assert torch.equal(bits, _bits(l))
    if kind in ("nan", "all_nan"):
        row = 1 if kind == "nan" else B - 1
        assert got[0][row].isnan() and got[1][row].isnan()


def test_runahead_topk_refuses_geometry_it_cannot_hold(gen):
    x = torch.randn((2, 300), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="clusters"):
        rt.runahead_topk_threshold_cuda(x, k_target=3, clusters=17)
    wide = torch.zeros((1, 16 * rt.SLICE_MAX + 1), device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        rt.runahead_topk_threshold_cuda(wide, k_target=3)


@pytest.mark.parametrize("m", [1, 31, 130])
@pytest.mark.parametrize("terms", [1, 2, 3, 25, 2500, 10_000])
def test_taylor_sincos_wide(gen, m, terms):
    """Bit for bit (signed zeros included) at x in (-4, 4) and at 1, 2,
    +0 and -0, through the zero tail of both series."""
    x = torch.rand((m,), generator=gen, device="cuda") * 8.0 - 4.0
    special = torch.tensor([1.0, 2.0, 0.0, -0.0], device="cuda")
    x[:min(m, 4)] = special[:min(m, 4)]
    got = te.taylor_sincos_cuda(x, terms=terms)
    want = te.taylor_sincos_plain(x, terms=terms)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        te.taylor_sincos_reference_cuda(x, terms=terms).view(torch.int32),
        want.view(torch.int32))


def test_taylor_division_matches_ieee(gen):
    """K1's division step, RN(RN(t * x2n) / den), against the card's IEEE
    multiply and division on 10**7 triples: the series' denominators and
    adversarial ones (significands just below 2, up to 2**48); numerators
    across the fast range, both zeros, subnormal and near-underflow ones,
    huge and infinite ones; x2n tiny enough to leave the fast range."""
    N = 10_000_000
    dev = "cuda"

    def u(lo, hi):
        return torch.empty(N, device=dev).uniform_(lo, hi, generator=gen)

    i = torch.randint(0, 100_000, (N,), generator=gen, device=dev).float()
    first = torch.randint(1, 3, (N,), generator=gen, device=dev).float()
    den = (2 * i + first) * (2 * i + (first + 1))
    odd = torch.rand(N, generator=gen, device=dev) < 0.3
    adversarial = torch.exp2(torch.floor(u(1, 48))) * (
        2 - torch.floor(u(1, 2 ** 14)) * 2 ** -23)
    den = torch.where(odd, adversarial, den)
    x = u(-4, 4)
    x = torch.where(torch.rand(N, generator=gen, device=dev) < 0.02,
                    x * 2 ** -31, x)                    # |x2n| < 2**-60
    x2n = -(x * x)
    sign = torch.where(torch.rand(N, generator=gen, device=dev) < 0.5, -1.0,
                       1.0).to(dev)
    # the numerator's scale: mostly the fast range, then the region where
    # t underflows (normal down to subnormal), then huge
    scale = torch.exp2(u(-130, 60))
    scale = torch.where(torch.rand(N, generator=gen, device=dev) < 0.1,
                        torch.exp2(u(-160, -100)), scale)
    scale = torch.where(torch.rand(N, generator=gen, device=dev) < 0.01,
                        torch.exp2(u(100, 127)), scale)
    t = sign * scale * (2 - torch.floor(u(0, 2 ** 23)) * 2 ** -23)
    t = torch.where(torch.rand(N, generator=gen, device=dev) < 0.05,
                    sign * 0.0, t)                      # +0 and -0
    t[:4] = torch.tensor([float("inf"), float("-inf"), 1e-45, -1e-45],
                         device=dev)
    x2n[:4] = -1.0
    got = te.taylor_division_cuda(t, x2n, den)
    want = (t * x2n) / den
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))
    n = (t * x2n).abs()
    assert int((n == 0).sum()) > 100_000 and int(
        ((n > 0) & (n < 2 ** -126)).sum()) > 10_000


def test_fma_latency_probe(gen):
    cycles = te.fma_latency_cycles(reps=200)
    assert 1.0 <= cycles < 64.0


# (P, context, n_kv, head_dim, L, n_heads, positions): page sizes that
# divide the context and don't, rows past the wrap point, and the served
# decode geometry (n_rep 4, head_dim 128, P 16, context 544)
K6_SHAPES = [(4, 8, 2, 16, 4, 4, [2, 6, 11]), (5, 8, 2, 16, 3, 6, [2, 9]),
             (16, 544, 8, 128, 1, 32, [511, 520, 530, 543]),
             (16, 100, 8, 128, 3, 32, [40, 98, 130])]


def _paged_inputs(gen, P, C, nkv, hd, L, nq, pos, dtype):
    B = len(pos)
    chain = -(-C // P)
    n_pages = B * chain + 1
    pk = torch.randn((n_pages, P, nkv, hd), generator=gen, device="cuda")
    pv = torch.randn((n_pages, P, nkv, hd), generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:B * chain].reshape(B, chain).int()
    q = torch.randn((B, L, nq, hd), generator=gen, device="cuda")
    return (pk.to(dtype), pv.to(dtype), table,
            torch.tensor(pos, dtype=torch.int32, device="cuda"), q.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_paged_attend(gen, shape, dtype):
    P, C = shape[:2]
    args = _paged_inputs(gen, *shape, dtype)
    got = pa.paged_attend_cuda(*args, context=C)
    assert got.dtype == dtype
    assert torch.equal(got, pa.paged_attend_cuda(*args, context=C))
    want = pa.paged_attend_plain(*args, context=C)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-6))
    torch.testing.assert_close(got.float(), want.float(), **tol)


# (slots, kv heads) whose split geometry at the served chain (34 pages of
# 16, head_dim 128, n_rep 4) gives 9, 17, 34 (one page each) and 1 split;
# each has a slot at position 5, whose later splits see only masked pages
K6_SPLITS = [(4, 8), (2, 4), (1, 2), (33, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nkv", K6_SPLITS)
def test_paged_attend_splits(gen, B, nkv, dtype):
    """The kernel against the plain version's split and merge at the same
    split count; splits with no valid page weigh 0."""
    P, C = 16, 544
    pos = [5, 300, 543, 600][:B] + [37 * i % 700 for i in range(B - 4)]
    args = _paged_inputs(gen, P, C, nkv, 128, 1, 4 * nkv, pos, dtype)
    n_split = pa.split_geometry(B, nkv, -(-C // P))[0]
    assert n_split == {(4, 8): 9, (2, 4): 17, (1, 2): 34, (33, 8): 1}[B, nkv]
    got = pa.paged_attend_cuda(*args, context=C)
    assert torch.equal(got, pa.paged_attend_cuda(*args, context=C))
    want = pa.paged_attend_plain(*args, context=C, n_split=n_split)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-6))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_new_wrappers_count_launches_and_refuse_bad_input(gen):
    ops.reset_launches()
    ops.taylor_sincos_eval(torch.ones(3, device="cuda"), terms=4)
    args = _paged_inputs(gen, *K6_SHAPES[0], torch.float32)
    ops.paged_attend(*args, context=8)
    assert ops.LAUNCHES["taylor_sincos_eval"] == 1
    assert ops.LAUNCHES["paged_attend"] == 1
    with pytest.raises(ValueError, match="1-D"):
        te.taylor_sincos_cuda(torch.ones((2, 2), device="cuda"), terms=4)
    with pytest.raises(ValueError, match="CUDA"):
        te.taylor_sincos_cuda(torch.ones(2), terms=4)
    pk, pv, table, pos, q = args
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attend_cuda(pk, pv, table, pos, q.double(), context=8)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attend_cuda(pk, pv, table, pos,
                             torch.zeros((3, 2000, 4, 16), device="cuda"),
                             context=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attend(pk.cpu(), pv, table, pos, q, context=8)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attend_cuda(*(t[..., :8].contiguous() for t in (pk, pv)),
                             table, pos, q[..., :8].contiguous(), context=8)


# (B, S, heads, kv heads, head_dim, window): one row, ragged S with GQA,
# a band, n_rep 4 with a band that skips tiles, the training heads, and
# the training length
K7_SHAPES = [(1, 1, 2, 2, 16, 0), (2, 130, 4, 2, 32, 0),
             (1, 1000, 2, 2, 128, 128), (2, 257, 8, 2, 64, 17),
             (1, 700, 16, 8, 128, 0), (1, 4096, 4, 2, 128, 0)]


def _flash_inputs(gen, B, S, H, Hk, D, dtype):
    return [torch.randn((B, S, h, D), generator=gen, device="cuda").to(dtype)
            for h in (H, Hk, Hk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K7_SHAPES)
def test_flash_fwd(gen, shape, dtype):
    B, S, H, Hk, D, window = shape
    q, k, v = _flash_inputs(gen, B, S, H, Hk, D, dtype)
    kw = dict(window=window, n_rep=H // Hk)
    got = ff.flash_fwd_cuda(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, ff.flash_fwd_cuda(q, k, v, **kw))
    rep = [t.repeat_interleave(H // Hk, dim=2) for t in (k, v)]
    assert torch.equal(got, ff.flash_fwd_cuda(q, *rep, window=window))
    if dtype == torch.float32:
        torch.testing.assert_close(got, ff.flash_fwd_plain(q, k, v, **kw),
                                   rtol=1e-4, atol=2e-5)
    else:
        accuracy = ff.bf16_check(got, q, k, v, **kw)
        assert accuracy.ok, str(accuracy)


# Faults planted in a copy of the bf16 kernel's source, each confined to
# query rows past 2560 (keys at or past 2560 at head_dim 128's 64-key
# tiles): the P.V of one key tile dropped, one rescale of acc skipped,
# and the diagonal key masked.
_PV = "pv_tile<D>(o, pa, s_v + prev * G::kKvBytes);"
_RESCALE = "rescale(o, corr);\n    mbar_wait(bar_v + 8 * prev"
_MASK = "if (kpos > qpos || (window"
_AT_2560 = "if ((kt_lo + it - 1) * kKeys != 2560) "
K7_FAULTS = {
    "tile dropped": (_PV, _AT_2560 + _PV),
    "rescale skipped": (_RESCALE, _AT_2560 + _RESCALE),
    "diagonal masked": (_MASK, "if (kpos > qpos || (qpos >= 2560 && kpos == "
                               "qpos) || (window"),
}


def test_flash_fwd_bf16_check_fails_planted_faults(gen, tmp_path,
                                                   monkeypatch):
    import shutil
    import subprocess

    from repro_torch.kernels import build

    q, k, v = _flash_inputs(gen, 1, 4096, 4, 2, 128, torch.bfloat16)
    assert ff.bf16_check(ff.flash_fwd_cuda(q, k, v, n_rep=2), q, k, v,
                         n_rep=2).ok
    procs = {}
    for i, (name, (old, new)) in enumerate(K7_FAULTS.items()):
        src = tmp_path / f"fault{i}"
        shutil.copytree(build.CSRC, src)
        text = (src / "flash_fwd.cu").read_text()
        assert text.count(old) == 1, name
        (src / "flash_fwd.cu").write_text(text.replace(old, new))
        procs[name] = (src / "flash_fwd.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(src / "flash_fwd.so"),
             str(src / "flash_fwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        assert proc.returncode == 0, out
        monkeypatch.setattr(ff, "_entry", lambda lib=lib: ff.bind(
            build.load(lib)))
        accuracy = ff.bf16_check(ff.flash_fwd_cuda(q, k, v, n_rep=2), q, k,
                                 v, n_rep=2)
        print(f"K7 planted fault '{name}': {accuracy}")
        assert not accuracy.ok, name


def test_flash_fwd_wrapper_counts_launches_differentiates_and_refuses(gen):
    from repro_torch.models.attention import flash_attend

    q, k, v = (t.requires_grad_(True)
               for t in _flash_inputs(gen, 1, 300, 4, 2, 32, torch.float32))
    ops.reset_launches()
    out = ops.flash_fwd(q, k, v, window=40, n_rep=2)
    assert ops.LAUNCHES["flash_fwd"] == 1
    ct = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, (q, k, v), ct)
    ref = flash_attend(q, k, v, window=40, q_chunk=300, kv_chunk=300,
                       n_rep=2)
    want = torch.autograd.grad(ref, (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES["flash_fwd"] == 1      # the backward launches no K7
    q, k, v = (t.detach() for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim"):
        ff.flash_fwd_cuda(q[..., :24], k[..., :24], v[..., :24], n_rep=2)
    with pytest.raises(ValueError, match="dtype"):
        ff.flash_fwd_cuda(q.half(), k.half(), v.half(), n_rep=2)
    with pytest.raises(ValueError, match="n_rep"):
        ff.flash_fwd_cuda(q, k, v, n_rep=3)
    with pytest.raises(ValueError, match="CUDA"):
        ff.flash_fwd_cuda(q.cpu(), k, v, n_rep=2)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.flash_fwd(q, k.cpu(), v, n_rep=2)
