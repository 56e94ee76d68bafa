"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device.  On a
GPU machine run ``python -m pytest -m cuda tests/test_torch_cuda.py``
(this file imports no JAX).  K1, K2 and K3 must match exactly (K2
counting above and below at its paths' shapes and on rows of NaN, +-inf
and +-0, one launch a call, the same between eager calls and CUDA-graph
replay with calls at B = 4, 64 and 1 in between; K3's cluster kernel
also against the CPU emulation of its scheme, K1's division step against
the card's IEEE division; K3's NaN brackets with every NaN taken as
one); K4 and K5 within rtol=1e-5, atol=1e-6 (f32 sums
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
forward summation).  The paths' CUDA graphs (``core/graphs.py``) bit for
bit against their eager bodies: serial and runahead solves through K1,
the one-shot decode steps against an eager loop with a host-integer
position, continuous per-step serving (dense and paged through K6)
across admissions, and fused horizons of 4 steps against per-step
serving; speculative serving's verify steps (draft_len 3, dense and
paged) against their eager bodies and a speculative horizon against
per-step serving; K6 at L = 2, 4 and 8 verify queries and K3 at a verify
grid's 16 rows of the served vocab; and the warm-up that keeps
K2/K4/K5's cached scratch out of a capture.  whisper (reduced) and the
int8 K/V ring: a graphed decode step against its eager body (logits and
every cache leaf, codes and scales included), an int8 continuous step's
idle lanes bit for bit after a replay, and continuous serving (per step
and fused horizons of 4, whisper's requests each with its own frames)
against eager step bodies; K3-K5 at whisper's vocab row and K7 at
qwen3-4b's 4096-token admission (B = 1, 32 / 8 heads, head_dim 128).
The mesh, on ranks sharing cuda:0 over gloo (``tests/torch_mesh_ranks.py``):
a 2-rank vocab-sharded solve of each kind ("hopper": K2, K4, K5 on the
local shard, one launch a round) against the "torch" backend on one rank
(counts bit for bit, mass and entropy within rtol 1e-5 / atol 1e-6); the
chip-level root through K1 on 4 ranks' chunks against the serial root;
and a 1x2 mesh's served tokens against the single-rank (graphed) serve.
Data-parallel training (``tests/torch_train_ranks.py``): two f32 steps of
reduced internlm2-1.8b and granite-moe-3b-a800m (bisect: K3 on the
gathered assignments) on 2 ranks against the single-rank step on each
rank (loss rtol 1e-5, params within 1e-5, keep masks bit for bit), the
ranks' replica digests equal.  The tensor-parallel layout
(``tests/torch_tp_ranks.py``): the same two steps on a 1x2 mesh with the
sequence-parallel stream, the params gathered whole, against the
single-rank step at the same tolerances.
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


# K2 at the shapes its paths give it: the sampler's (4, 151936) at M = 31
# and the M = 1 probe, B = 64 with two candidate tiles, ragged V, the
# quantile clip's single row (1, 300, 15), and the small shapes
K2_SHAPES = [(4, 151936, 31), (4, 151936, 1), (3, 1000, 31), (3, 257, 31),
             (64, 151936, 33), (1, 300, 15)] + SHAPES


def _special_rows(gen, B, V):
    """Random rows with +0 and -0 in every fifth lane, NaN lanes in the
    first row, +inf and -inf lanes in the last."""
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    x[:, 1::5] = 0.0
    x[:, 2::5] = -0.0
    x[0, 3::7] = float("nan")
    x[-1, 4::11] = float("inf")
    x[-1, 6::13] = float("-inf")
    return x


def _k2_candidates(gen, x, M):
    """Candidates as strided rows of a grid (the engine's grid[:, 1:-1]):
    one equal to an element, then -0, +0, +inf, -inf and NaN where M has
    room, the rest random."""
    B = x.shape[0]
    grid = torch.randn((B, M + 2), generator=gen, device="cuda") * 2.0
    grid[:, 1] = x[:, 7 % x.shape[1]]
    for i, v in enumerate((-0.0, 0.0, float("inf"), float("-inf"),
                           float("nan"))):
        if i + 2 <= M:
            grid[:, i + 2] = v
    return grid[:, 1:-1]


@pytest.mark.parametrize("below", [False, True])
@pytest.mark.parametrize("B,V,M", K2_SHAPES)
def test_multi_count(gen, B, V, M, below):
    """K2 bit for bit against its plain version and run to run, counting
    above and below, on random rows and on rows of NaN, +-inf and +-0."""
    plain = lambda x, t: mc.multi_count_plain(x, t, below)
    for x in (torch.randn((B, V), generator=gen, device="cuda") * 2.0,
              _special_rows(gen, B, V)):
        taus = _k2_candidates(gen, x, M)
        got = mc.multi_count_cuda(x, taus, below)
        assert torch.equal(got, mc.multi_count_cuda(x, taus, below))
        assert torch.equal(got, _by_tiles(plain, x, taus))


def test_multi_count_graph_replay_and_batches_back_to_back(gen):
    """K2 bit for bit between eager calls and CUDA-graph replay, while
    calls at B = 4, 64 and 1 run between the replays (a ticket left
    non-zero, or one call's sums read by another, would show)."""
    def call_at(B, V, M):
        x = _special_rows(gen, B, V)
        taus = _k2_candidates(gen, x, M)
        return lambda: (mc.multi_count_cuda(x, taus),
                        mc.multi_count_cuda(x, taus, below=True))

    calls = {4: call_at(4, 151936, 31), 64: call_at(64, 151936, 33),
             1: call_at(1, 300, 15)}
    eager = {B: call() for B, call in calls.items()}
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
        calls[1]()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager[4]):
        assert torch.equal(got, want)
    for B in (64, 1):
        for got, want in zip(calls[B](), eager[B]):
            assert torch.equal(got, want)


def test_multi_count_one_launch_per_call(gen):
    """One device kernel per K2 call in either direction, at the sampler's
    shape and the quantile clip's, and the wrapper counts it."""
    from torch.profiler import ProfilerActivity, profile

    for B, V, M in ((4, 151936, 31), (1, 300, 15)):
        x = torch.randn((B, V), generator=gen, device="cuda")
        taus = _k2_candidates(gen, x, M)
        for below in (False, True):
            mc.multi_count_cuda(x, taus, below)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                mc.multi_count_cuda(x, taus, below)
                torch.cuda.synchronize()
            kernels = {e.key: e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA}
            assert len(kernels) == 1, kernels
            assert all("multi_count_kernel" in k and n == 1
                       for k, n in kernels.items()), kernels
    ops.reset_launches()
    ops.multi_count(x, taus)
    ops.multi_count(x, taus, below=True)
    assert ops.LAUNCHES["multi_count"] == 2


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
    (16, 151936, None, 40, 8, 5, "randn"),      # a verify grid: 4 slots x 4
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [2, 4, 8])
def test_paged_attend_verify_rows(gen, L, dtype):
    """K6 with L verify queries a slot at the served head shape (n_kv 8,
    n_rep 4, head_dim 128, page 16, context 544), deepest rows at the
    ring's end, against the plain version."""
    P, C = 16, 544
    args = _paged_inputs(gen, P, C, 8, 128, L, 32,
                         [543 - L, 520, 300, 5], dtype)
    assert pa.smem_bytes(L, 4, P, 128, args[0].element_size()) <= 227 * 1024
    got = pa.paged_attend_cuda(*args, context=C)
    assert torch.equal(got, pa.paged_attend_cuda(*args, context=C))
    want = pa.paged_attend_plain(*args, context=C)
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
# a band, n_rep 4 with a band that skips tiles, the training heads, the
# training length, and hymba's prefill (head_dim 64, n_rep 5, window 1024)
K7_SHAPES = [(1, 1, 2, 2, 16, 0), (2, 130, 4, 2, 32, 0),
             (1, 1000, 2, 2, 128, 128), (2, 257, 8, 2, 64, 17),
             (1, 700, 16, 8, 128, 0), (1, 4096, 4, 2, 128, 0),
             (1, 4096, 10, 2, 64, 1024), (1, 4096, 32, 8, 128, 0)]


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


# ---------------------------------------------------------------------------
# CUDA graphs of the paths (core/graphs.py): each replay equals its eager
# body bit for bit
# ---------------------------------------------------------------------------

class _Eager:
    """A graph cache that runs every body eagerly: the reference."""
    keys: list = []
    capture_s = 0.0

    def run(self, key, body, *args, device=None):
        return body(*args)


def test_graphed_solves_equal_their_eager_bodies(gen):
    """A serial and a runahead solve through K1: the replay (the second
    call at a key) equals the eager body, runahead equals serial, and a
    replay counts the K1 launches its capture recorded."""
    from repro_torch.core import bisect, runahead
    from repro_torch.launch import paper

    f = paper.evaluator(37)
    a, b = paper.interval("cuda")
    n = 24
    want = bisect._serial(f, a, b, iterations=n, mode="signbit")
    for k in (None, 1, 3, 5):
        def solve():
            if k is None:
                return bisect.find_root_serial(f, a, b, n, "signbit")
            return runahead.find_root_runahead(f, a, b, n, k)
        first = solve()                        # eager, then the capture
        ops.reset_launches()
        got = solve()                          # the replay
        torch.cuda.synchronize()
        assert ops.LAUNCHES["taylor_sincos_eval"] == (
            n + 1 if k is None else -(-n // k) + 1)
        assert torch.equal(first, want) and torch.equal(got, want)
    assert len([key for key in bisect.GRAPHS.keys if key[1] is f]) == 4


def _tiny_model(gen, dtype=torch.float32):
    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params

    cfg = reduced_config("qwen3-4b")
    return cfg, init_params(cfg, gen, dtype)


def test_graphed_oneshot_steps_equal_the_eager_loop(gen):
    """``generate``'s decode steps (graph replays, a device position)
    against the eager loop with a host-integer position, sampled through
    K3-K5, bit for bit; a second call replays every step."""
    from repro_torch.core import tuning
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.serving import engine
    from repro_torch.serving.sampler import SamplerConfig, sample

    cfg, params = _tiny_model(gen)
    prompt = torch.randint(0, cfg.vocab, (3, 8), generator=gen,
                           device="cuda")
    sc = SamplerConfig(top_k=20, top_p=0.9, target_entropy=2.0,
                       backend="hopper")
    g = torch.Generator(device="cuda")
    logits, cache = prefill(cfg, params, prompt, 14)
    toks = [sample(logits, g.manual_seed(5), sc)]
    for pos in range(8, 13):
        logits, cache = decode_step(cfg, params, toks[-1], pos, cache)
        toks.append(sample(logits, g, sc))
    want = torch.stack(toks, dim=1)
    graphs = engine.DecodeGraphs()
    for _ in range(2):
        ops.reset_launches()
        got = engine.generate(cfg, params, prompt, 6, g.manual_seed(5),
                              sampler=sc, graphs=graphs)
        assert torch.equal(got, want)
        assert ops.LAUNCHES["runahead_topk_threshold"] == 6
        # K4 and K5 once a round of the decomposition the tuner chose
        # (core/tuning.py) and once for the sign at lo0, each token
        decided = {key.split("|")[0]: d for key, d in tuning.explain()
                   if f"|B=3|V={cfg.vocab}|float32|pref=hopper|" in key}
        for kind, kernel in (("mass_at_or_above", "multi_mass"),
                             ("entropy_at_temperature",
                              "multi_entropy_moments")):
            assert ops.LAUNCHES[kernel] == (decided[kind].rounds + 1) * 6
        assert len(graphs.graphs.keys) == 1


def _stream_requests():
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import Request

    sc = lambda **kw: SamplerConfig(backend="hopper", **kw)
    return [
        Request("a", [1, 2, 3, 4], 5, seed=11, sampler=sc(top_k=12)),
        Request("b", [9, 8, 7, 6, 5], 3, seed=22, sampler=sc(top_p=0.9)),
        Request("c", [4, 4, 4], 2, seed=33,
                sampler=sc(target_entropy=2.0), arrival=1),
        Request("d", [10, 20, 30, 40], 6, seed=44,
                sampler=sc(temperature=0.7, top_k=30), arrival=2),
        Request("e", [2, 4, 6, 8], 7, seed=55, sampler=sc(greedy=True),
                arrival=3),
    ]


def _streams(cfg, params, eager=False, **kw):
    from repro_torch.serving.server import RunaheadServer

    srv = RunaheadServer(cfg, params, n_slots=2, context=24,
                         backend="hopper", **kw)
    if eager:
        srv.scheduler.graphs = _Eager()
    return ({c.rid: c.tokens for c in srv.run(_stream_requests())},
            srv.scheduler)


@pytest.mark.parametrize("page_size", [None, 4])
def test_graphed_scheduler_steps_equal_the_eager_body(gen, page_size):
    """Per-step continuous serving through its step graphs (several keys;
    admissions rewrite the knobs and the active mask between replays)
    against the same steps run eagerly, bit for bit; and a K = 4 horizon
    graph against the eager per-step steps."""
    cfg, params = _tiny_model(gen)
    kw = dict(page_size=page_size,
              page_impl="hopper" if page_size else "gather")
    want, _ = _streams(cfg, params, eager=True, **kw)
    ops.reset_launches()
    got, sched = _streams(cfg, params, **kw)
    assert got == want
    assert len(sched.graphs.keys) >= 2
    if page_size:
        assert ops.LAUNCHES["paged_attend"] == (cfg.n_layers
                                                * sched.n_decode_steps)
    fused, sched = _streams(cfg, params, step_horizon=4, **kw)
    assert fused == want
    assert sched.n_horizons >= 1
    assert all(key[0] == "horizon" for key in sched.graphs.keys)


@pytest.mark.parametrize("page_size", [None, 4])
def test_graphed_verify_steps_equal_the_eager_body(gen, page_size):
    """Speculative serving (draft_len 3, mixed greedy and sampled slots)
    through its verify-step graphs against the same steps run eagerly,
    bit for bit; a K = 4 speculative horizon with repeat-last drafts
    against per-step serving with the same drafter."""
    from repro_torch.serving.draft import RepeatLastDrafter

    cfg, params = _tiny_model(gen)
    kw = dict(page_size=page_size, draft_len=3,
              page_impl="hopper" if page_size else "gather")
    want, _ = _streams(cfg, params, eager=True, **kw)
    ops.reset_launches()
    got, sched = _streams(cfg, params, **kw)
    assert got == want
    assert all(key[2] == 3 for key in sched.graphs.keys)
    if page_size:
        assert ops.LAUNCHES["paged_attend"] == (cfg.n_layers
                                                * sched.n_decode_steps)
    kw["drafter"] = RepeatLastDrafter()
    per_step, _ = _streams(cfg, params, **kw)
    fused, sched = _streams(cfg, params, step_horizon=4, **kw)
    assert fused == per_step
    assert sched.n_horizons >= 1


def test_graph_warm_up_keeps_row_reduce_scratch(gen):
    """K2, K4 and K5 in a graph at a candidate count that outgrows the
    cached scratch: the warm-up grows it, the capture does not; the graph
    is dropped and another captured, and its replays equal the eager
    calls, also after a larger call grows the scratch again.  Growing the
    scratch inside a capture raises."""
    from repro_torch.core.graphs import Graphs
    from repro_torch.kernels import row_reduce

    B, V = 4, 151936
    held = row_reduce._SCRATCH.setdefault(0, [])
    nb = row_reduce.blocks_per_row(B, V, row_reduce.sm_count(0))

    def calls():
        # K2 alone (one accumulator) must outgrow the largest scratch yet
        M = (held[-1][0].numel() if held else 0) // (B * nb) + 2
        x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
        t = torch.randn((B, M), generator=gen, device="cuda")
        p = torch.softmax(x, dim=-1)
        taus = p.gather(1, torch.randint(0, V, (B, M), generator=gen,
                                         device="cuda"))
        ts = torch.exp(torch.empty((B, M), device="cuda").uniform_(
            -3.0, 3.0, generator=gen))
        z = x - x.amax(dim=-1, keepdim=True)
        return lambda x, t: (ops.multi_count(x, t), ops.multi_mass(p, taus),
                             *ops.multi_entropy_moments(z, ts)), (x, t)

    body, args = calls()
    n_held = len(held)
    first = Graphs()
    first.run("rr", body, *args)               # eager warm-up, capture
    n_warm = len(held)
    assert n_warm > n_held                     # the warm-up grew it
    want = body(*args)
    for w, g in zip(want, first.run("rr", body, *args)):
        assert torch.equal(w, g)
    first.clear()
    again = Graphs()
    again.run("rr", body, *args)
    assert len(held) == n_warm                 # no capture allocated
    for _ in range(2):
        for w, g in zip(want, again.run("rr", body, *args)):
            assert torch.equal(w, g)
    big, big_args = calls()
    big(*big_args)                             # grows the scratch
    assert len(held) > n_warm
    for w, g in zip(want, again.run("rr", body, *args)):
        assert torch.equal(w, g)
    grow, grow_args = calls()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="scratch"):
        with torch.cuda.graph(graph):
            grow(*grow_args)


# ---------------------------------------------------------------------------
# the MoE family: K3 at the capacity cut's shapes, and graphed decode steps
# ---------------------------------------------------------------------------

MOE_CAPACITY_CASES = [  # (experts padded, tokens, top_k, real experts)
    (64, 1, 4, 60),        # one-token decode: A = 4
    (64, 4, 4, 60),        # qwen2-moe, a 4-row decode step: A = 16
    (64, 2048, 4, 60),     # a qwen2-moe prefill of 2048 tokens: A = 8192
    (48, 8192, 8, 40),     # granite training, batch 2 x 4096: A = 65536
]


def _masked_scores(gen, e_pad, T, k, n_real):
    """The capacity solve's (e_pad, A) operand: each assignment's gate in
    its expert's row, -1.0 elsewhere; experts drawn with a skew, so some
    rows run over capacity and some hold no assignment."""
    A = T * k
    weights = torch.rand((n_real,), generator=gen, device="cuda") ** 4
    expert = torch.multinomial(weights, A, replacement=True, generator=gen)
    gates = torch.rand((A,), generator=gen, device="cuda") * 0.9 + 0.05
    rows = torch.arange(e_pad, device="cuda")[:, None]
    return torch.where(rows == expert[None, :], gates[None, :], -1.0), \
        gates, expert


@pytest.mark.parametrize("e_pad,T,k,n_real", MOE_CAPACITY_CASES)
def test_runahead_topk_capacity_shapes(gen, e_pad, T, k, n_real):
    """K3 on the capacity cut's operand (mostly the -1.0 sentinel, k =
    cap, rounds 6, spec_k 5) bit for bit against its plain version and
    the CPU emulation of its scheme; the bisect keep mask on the card
    equals the CPU's."""
    from repro_torch.models import moe

    cap = moe._capacity(T, n_real, k, 1.25)
    x, gates, expert = _masked_scores(gen, e_pad, T, k, n_real)
    kw = dict(k_target=cap, rounds=6, spec_k=5)
    ops.reset_launches()
    got = ops.runahead_topk_threshold(x, **kw)
    assert ops.LAUNCHES["runahead_topk_threshold"] == 1
    want = rt.runahead_topk_threshold_plain(x, **kw)
    emulated = rt.runahead_topk_threshold_clustered(x, **kw)
    for g, w, e in zip(got, want, emulated):
        assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(_bits(g), _bits(e))
    keep = moe._bisect_keep(gates, expert, e_pad, cap)
    keep_cpu = moe._bisect_keep(gates.cpu(), expert.cpu(), e_pad, cap)
    assert torch.equal(keep.cpu(), keep_cpu)
    assert int(torch.bincount(expert[keep], minlength=e_pad).max()) <= cap


def _tiny_moe(gen, dtype=torch.float32):
    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params

    cfg = reduced_config("qwen2-moe-a2.7b")
    return cfg, init_params(cfg, gen, dtype)


@pytest.mark.parametrize("capacity_mode", ["fifo", "bisect"])
def test_graphed_moe_decode_step_equals_its_eager_body(gen, capacity_mode):
    """A reduced qwen2-moe decode step captured in a CUDA graph (its
    capacity cut through K3 under "bisect") and replayed equals the same
    step run eagerly, logits and cache bit for bit; the capture reads
    nothing back to the host."""
    from repro_torch.core.graphs import Graphs
    from repro_torch.models.decode import decode_step, prefill

    cfg, params = _tiny_moe(gen)
    prompt = torch.randint(0, cfg.vocab, (4, 8), generator=gen,
                           device="cuda")
    _, cache = prefill(cfg, params, prompt, 12, capacity_mode=capacity_mode)
    token = torch.randint(0, cfg.vocab, (4,), generator=gen, device="cuda")
    pos = torch.full((4,), 8, dtype=torch.int64, device="cuda")

    def body(c):
        logits, _ = decode_step(cfg, params, token, pos, c,
                                capacity_mode=capacity_mode)
        return logits

    snapshot = [{"kv": type(e["kv"])(e["kv"].k.clone(), e["kv"].v.clone())}
                for e in cache]
    want = body(cache)
    want_k = cache[0]["kv"].k.clone()
    for e, s in zip(cache, snapshot):
        e["kv"].k.copy_(s["kv"].k)
        e["kv"].v.copy_(s["kv"].v)
    graphs = Graphs()
    graphs.run("step", lambda: body(cache), device=torch.device("cuda"))
    for e, s in zip(cache, snapshot):
        e["kv"].k.copy_(s["kv"].k)
        e["kv"].v.copy_(s["kv"].v)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = graphs.run("step", lambda: body(cache),
                         device=torch.device("cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert torch.equal(cache[0]["kv"].k, want_k)
    assert ops.LAUNCHES["runahead_topk_threshold"] == (
        cfg.n_layers if capacity_mode == "bisect" else 0)


def test_graphed_moe_serving_equals_the_eager_body(gen):
    """Reduced qwen2-moe served one-shot (graphed decode steps against the
    eager loop) and continuously on the dense ring (per step and at
    step_horizon 4, graphs against eager step bodies), bit for bit, the
    samples through K3-K5."""
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.serving import engine
    from repro_torch.serving.sampler import SamplerConfig, sample

    cfg, params = _tiny_moe(gen)
    prompt = torch.randint(0, cfg.vocab, (3, 8), generator=gen,
                           device="cuda")
    sc = SamplerConfig(top_k=20, top_p=0.9, target_entropy=2.0,
                       backend="hopper")
    g = torch.Generator(device="cuda")
    logits, cache = prefill(cfg, params, prompt, 14)
    toks = [sample(logits, g.manual_seed(5), sc)]
    for pos in range(8, 13):
        logits, cache = decode_step(cfg, params, toks[-1], pos, cache)
        toks.append(sample(logits, g, sc))
    want = torch.stack(toks, dim=1)
    graphs = engine.DecodeGraphs()
    for _ in range(2):
        got = engine.generate(cfg, params, prompt, 6, g.manual_seed(5),
                              sampler=sc, graphs=graphs)
        assert torch.equal(got, want)
    want, _ = _streams(cfg, params, eager=True)
    got, sched = _streams(cfg, params)
    assert got == want and len(sched.graphs.keys) >= 2
    fused, sched = _streams(cfg, params, step_horizon=4)
    assert fused == want and sched.n_horizons >= 1


# ---------------------------------------------------------------------------
# the tuner's kernel tier: every candidate geometry of K2-K6
# (core/tuning.py::kernel_candidates)
# ---------------------------------------------------------------------------

def _geometries(kernel, shape, dtype="float32"):
    from repro_torch.core import tuning

    key = tuning.KernelKey(kernel, shape, dtype,
                           torch.cuda.get_device_name(0))
    return [d.params[tuning.KERNEL_PARAMS[kernel]]
            for d in tuning.kernel_candidates(key)]


ROW_TUNE_SHAPES = [(4, 151936, 31), (16, 151936, 31), (64, 151936, 33),
                   (1, 300, 15)]


@pytest.mark.parametrize("B,V,M", ROW_TUNE_SHAPES)
def test_multi_count_every_geometry_exact(gen, B, V, M):
    x, t = _inputs(gen, B, V, M)
    want = mc.multi_count_plain(x, t)
    for nb in _geometries("multi_count", (B, V, M)):
        assert torch.equal(mc.multi_count_cuda(x, t, nb=nb), want), nb
        assert torch.equal(mc.multi_count_cuda(x, t, below=True, nb=nb),
                           mc.multi_count_plain(x, t, below=True)), nb


@pytest.mark.parametrize("B,V,M", ROW_TUNE_SHAPES)
def test_mass_and_entropy_every_geometry_within_tolerance(gen, B, V, M):
    x, _ = _inputs(gen, B, V, M)
    probs = torch.softmax(x, dim=-1)
    taus = torch.rand((B, M), generator=gen, device="cuda") * 1e-4
    z = x - x.amax(-1, keepdim=True)
    ts = 0.05 + 20 * torch.rand((B, M), generator=gen, device="cuda")
    want_m = mm.multi_mass_plain(probs, taus)
    want_s, want_w = me.multi_entropy_moments_plain(z, ts)
    for nb in _geometries("multi_mass", (B, V, M)):
        got = mm.multi_mass_cuda(probs, taus, nb=nb)
        torch.testing.assert_close(got, want_m, **TOL)
        assert torch.equal(_bits(got),
                           _bits(mm.multi_mass_cuda(probs, taus, nb=nb)))
    for nb in _geometries("multi_entropy_moments", (B, V, M)):
        s, w = me.multi_entropy_moments_cuda(z, ts, nb=nb)
        torch.testing.assert_close(s, want_s, **TOL)
        torch.testing.assert_close(w, want_w, **TOL)
        s2, w2 = me.multi_entropy_moments_cuda(z, ts, nb=nb)
        assert torch.equal(_bits(s), _bits(s2))
        assert torch.equal(_bits(w), _bits(w2))


@pytest.mark.parametrize("e_pad,T,k,n_real", MOE_CAPACITY_CASES)
def test_runahead_topk_every_geometry_exact(gen, e_pad, T, k, n_real):
    """K3 at the served shapes and the capacity cut's, bit for bit against
    its plain version at every cluster size the tier offers."""
    from repro_torch.models import moe

    cap = moe._capacity(T, n_real, k, 1.25)
    cases = [(_masked_scores(gen, e_pad, T, k, n_real)[0],
              dict(k_target=cap, rounds=6, spec_k=5))]
    for B in (4, 16):
        x = torch.randn((B, 151936), generator=gen, device="cuda") * 2.0
        cases.append((x, dict(k_target=40, rounds=8, spec_k=5)))
    for x, kw in cases:
        want = rt.runahead_topk_threshold_plain(x, **kw)
        for c in _geometries("runahead_topk", tuple(x.shape)):
            got = rt.runahead_topk_threshold_cuda(x, clusters=c, **kw)
            for g, w in zip(got, want):
                assert torch.equal(_bits(g), _bits(w)), (tuple(x.shape), c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_every_geometry_within_tolerance(gen, dtype):
    """K6 at the served decode shape (and L = 4 verify rows) under every
    split count the tier offers, against the plain version with the same
    split, and bit-stable run to run."""
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    for L in (1, 4):
        args = _paged_inputs(gen, 16, 544, 8, 128, L, 32,
                             [520, 529, 537, 543 - L], dtype)
        key = (4, 8, 34, 16, L, 4, 128)
        for n in _geometries("paged_attend", key, str(dtype)[6:]):
            got = pa.paged_attend_cuda(*args, context=544, n_split=n)
            assert torch.equal(got, pa.paged_attend_cuda(
                *args, context=544, n_split=n)), n
            want = pa.paged_attend_plain(*args, context=544, n_split=n)
            torch.testing.assert_close(got.float(), want.float(), **tol)


def test_measurement_during_a_capture_raises(gen, tmp_path):
    """A decision that needs a measurement is never taken inside a CUDA-
    graph capture: the graph would record the measurement's launches."""
    from repro_torch.core import tuning

    tuning.set_cache_path(str(tmp_path / "cache.json"))
    try:
        x = torch.randn((4, 4096), generator=gen, device="cuda")
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="capture"):
            with tuning.autotune(), torch.cuda.graph(g):
                solver.solve_kind("count_below", x, backend="hopper",
                                  rounds=8, spec_k=5, q=0.3)
        torch.cuda.synchronize()
        # eagerly the same solve measures, keeps its winner, and a capture
        # replays it from the cache
        with tuning.autotune():
            want = solver.solve_kind("count_below", x, backend="hopper",
                                     rounds=8, spec_k=5, q=0.3)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                got = solver.solve_kind("count_below", x, backend="hopper",
                                        rounds=8, spec_k=5, q=0.3)
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        tuning.set_cache_path(None)


def test_auto_on_the_card_only_ever_chooses_hopper(gen, tmp_path):
    from repro_torch.core import tuning

    tuning.set_cache_path(str(tmp_path / "cache.json"))
    try:
        x = torch.randn((4, 151936), generator=gen, device="cuda")
        for tune in (False, True):
            tuning.tuner().recent.clear()
            solver.solve_kind("count_above", x, backend="auto", rounds=8,
                              spec_k=5, k=40, tune=tune)
            [(key, d)] = tuning.explain()
            assert d.backend == "hopper", (key, d)
    finally:
        tuning.set_cache_path(None)


# ---------------------------------------------------------------------------
# the recurrent families: xlstm (mLSTM / sLSTM) and hymba (attention || SSM)
# ---------------------------------------------------------------------------

RECURRENT = ["xlstm-1.3b", "hymba-1.5b"]


def _tiny_recurrent(gen, arch):
    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params

    cfg = reduced_config(arch)
    return cfg, init_params(cfg, gen, torch.bfloat16)


@pytest.mark.parametrize("arch", RECURRENT)
def test_graphed_recurrent_decode_step_equals_its_eager_body(gen, arch):
    """A reduced decode step captured in a CUDA graph and replayed (every
    mLSTM/sLSTM or SSM state and K/V row written in place; hymba's SWA
    ring wrapped) equals the same step run eagerly: logits and every
    cache leaf bit for bit; the replay reads nothing back to the host."""
    from repro_torch.core.graphs import Graphs
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.tree import leaves

    cfg, params = _tiny_recurrent(gen, arch)
    prompt = torch.randint(0, cfg.vocab, (4, 10), generator=gen,
                           device="cuda")
    _, cache = prefill(cfg, params, prompt, 16)
    token = torch.randint(0, cfg.vocab, (4,), generator=gen, device="cuda")
    pos = torch.full((4,), 10, dtype=torch.int64, device="cuda")

    def body():
        return decode_step(cfg, params, token, pos, cache)[0]

    snapshot = [t.clone() for t in leaves(cache)]

    def restore():
        for t, s in zip(leaves(cache), snapshot):
            t.copy_(s)

    want = body()
    want_cache = [t.clone() for t in leaves(cache)]
    restore()
    graphs = Graphs()
    graphs.run("step", body, device=torch.device("cuda"))
    restore()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = graphs.run("step", body, device=torch.device("cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    for t, w in zip(leaves(cache), want_cache):
        assert torch.equal(t, w)


@pytest.mark.parametrize("arch", RECURRENT)
def test_graphed_continuous_step_freezes_recurrent_lanes(gen, arch):
    """Three slots, one live request and a lane left holding a finished
    request's state: a replayed continuous step leaves both idle lanes'
    cache leaves (recurrent state and K/V) bit for bit as they were, and
    moves the live lane's recurrent state."""
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.tree import leaves_with_path

    cfg, params = _tiny_recurrent(gen, arch)
    sch = ContinuousScheduler(cfg, params, n_slots=3, context=24,
                              backend="hopper")
    sc = SamplerConfig(top_k=12, backend="hopper")
    assert sch.admit("live", list(range(1, 11)), 8, seed=1, sampler=sc)
    assert sch.admit("done", list(range(20, 30)), 1, seed=2, sampler=sc)
    assert [s is not None for s in sch.slots] == [True, False, False]
    sch.step()                        # the step's graph: warm-up, capture
    before = [(p, t.clone()) for p, t in leaves_with_path(sch.cache)]
    sch.step()                        # a replay
    torch.cuda.synchronize()
    moved = 0
    for (path, b), (_, t) in zip(before, leaves_with_path(sch.cache)):
        assert torch.equal(t[:, 1:], b[:, 1:]), path
        if "/kv/" not in path:
            moved += not torch.equal(t[:, 0], b[:, 0])
    assert moved == sum("/kv/" not in p for p, _ in before)
    assert len(sch.graphs.keys) == 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_graphed_recurrent_serving_equals_the_eager_body(gen, arch):
    """Reduced xlstm / hymba served continuously on the dense ring (per
    step and at step_horizon 4, graphs against eager step bodies), bit
    for bit, the samples through K3-K5."""
    cfg, params = _tiny_recurrent(gen, arch)
    want, _ = _streams(cfg, params, eager=True)
    got, sched = _streams(cfg, params)
    assert got == want and len(sched.graphs.keys) >= 2
    fused, sched = _streams(cfg, params, step_horizon=4)
    assert fused == want and sched.n_horizons >= 1


@pytest.mark.parametrize("vocab", [50304, 32001, 51865])
def test_sampler_kernels_at_recurrent_vocabs(gen, vocab):
    """K3 (bit for bit), K4 and K5 (rtol 1e-5 / atol 1e-6, bit-stable) at
    B = 4 on xlstm's vocab row, hymba's (padded to 32128 with its 127
    phantom columns at the row's max - 80, where the sampler's clamp puts
    them) and whisper's (51865 padded to 51968: 103 phantom columns)."""
    V = -(-vocab // 128) * 128
    x = torch.randn((4, V), generator=gen, device="cuda") * 2.0
    x[:, vocab:] = x[:, :vocab].amax(-1, keepdim=True) - 80.0
    kw = dict(k_target=40, rounds=8, spec_k=5)
    for g, w in zip(rt.runahead_topk_threshold_cuda(x, **kw),
                    rt.runahead_topk_threshold_plain(x, **kw)):
        assert torch.equal(g, w)
    p = torch.softmax(x, dim=-1)
    taus = torch.rand((4, 31), generator=gen, device="cuda") * p.amax()
    got = mm.multi_mass_cuda(p, taus)
    assert torch.equal(got, mm.multi_mass_cuda(p, taus))
    torch.testing.assert_close(got, mm.multi_mass_plain(p, taus), **TOL)
    z = x - x.amax(dim=-1, keepdim=True)
    ts = torch.exp(torch.empty((4, 31), device="cuda").uniform_(
        -3.0, 3.0, generator=gen))
    got = me.multi_entropy_moments_cuda(z, ts)
    for g, a, w in zip(got, me.multi_entropy_moments_cuda(z, ts),
                       me.multi_entropy_moments_plain(z, ts)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, **TOL)


# ---------------------------------------------------------------------------
# whisper (enc-dec) and the int8 K/V cache
# ---------------------------------------------------------------------------

STEP_CASES = [("whisper-tiny", torch.bfloat16), ("whisper-tiny", torch.int8),
              ("qwen3-4b", torch.int8)]


def _frames(cfg, gen, B):
    """B requests' encoder frames (B, T_enc, D) for an enc-dec arch, else
    None."""
    if not cfg.is_encdec:
        return None
    return torch.randn((B, cfg.encoder_len, cfg.d_model), generator=gen,
                       device="cuda")


@pytest.mark.parametrize("arch,cache_dtype", STEP_CASES)
def test_graphed_whisper_and_int8_decode_step_equals_its_eager_body(
        gen, arch, cache_dtype):
    """A reduced decode step captured in a CUDA graph and replayed
    (whisper's learned position gathered at a device position, its cross
    attention over the encoder K/V; int8 codes and scales written in
    place, the ring dequantized) equals the same step run eagerly: logits
    and every cache leaf bit for bit; the replay reads nothing back."""
    from repro_torch.core.graphs import Graphs
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.tree import leaves

    cfg, params = _tiny_recurrent(gen, arch)
    prompt = torch.randint(0, cfg.vocab, (4, 10), generator=gen,
                           device="cuda")
    _, cache = prefill(cfg, params, prompt, 16,
                       encoder_frames=_frames(cfg, gen, 4),
                       kv_dtype=cache_dtype)
    assert cache[0]["kv"].quantized == (cache_dtype == torch.int8)
    token = torch.randint(0, cfg.vocab, (4,), generator=gen, device="cuda")
    pos = torch.tensor([10, 11, 12, 13], device="cuda")

    def body():
        return decode_step(cfg, params, token, pos, cache)[0]

    snapshot = [t.clone() for t in leaves(cache)]

    def restore():
        for t, s in zip(leaves(cache), snapshot):
            t.copy_(s)

    want = body()
    want_cache = [t.clone() for t in leaves(cache)]
    restore()
    graphs = Graphs()
    graphs.run("step", body, device=torch.device("cuda"))
    restore()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = graphs.run("step", body, device=torch.device("cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    for t, w in zip(leaves(cache), want_cache):
        assert torch.equal(t, w)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny"])
def test_graphed_continuous_step_freezes_int8_lanes(gen, arch):
    """Three int8 slots, one live request and a lane left holding a
    finished request's state: a replayed continuous step leaves both idle
    lanes' codes, scales (and whisper's encoder K/V) bit for bit, and
    writes the live lane's codes and scales."""
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.tree import leaves_with_path

    cfg, params = _tiny_recurrent(gen, arch)
    sch = ContinuousScheduler(cfg, params, n_slots=3, context=24,
                              backend="hopper", cache_dtype=torch.int8)
    sc = SamplerConfig(top_k=12, backend="hopper")
    frames = _frames(cfg, gen, 2)
    kw = [dict(encoder_frames=None if frames is None else frames[i:i + 1])
          for i in range(2)]
    assert sch.admit("live", list(range(1, 11)), 8, seed=1, sampler=sc,
                     **kw[0])
    assert sch.admit("done", list(range(20, 30)), 1, seed=2, sampler=sc,
                     **kw[1])
    assert [s is not None for s in sch.slots] == [True, False, False]
    sch.step()                        # the step's graph: warm-up, capture
    before = [(p, t.clone()) for p, t in leaves_with_path(sch.cache)]
    sch.step()                        # a replay
    torch.cuda.synchronize()
    for path, b in before:
        t = dict(leaves_with_path(sch.cache))[path]
        assert torch.equal(t[:, 1:], b[:, 1:]), path
        if "/kv/" in path:
            assert not torch.equal(t[:, 0], b[:, 0]), path
    assert len(sch.graphs.keys) == 1


def _serve_with_frames(sched, gen, cfg):
    """``_stream_requests`` through ``sched`` at their arrival steps,
    each admitted with its own frames where the arch takes them (the
    server takes none)."""
    frames = _frames(cfg, gen, 5)
    todo = [(r.rid, r.prompt, r.n_new, r.seed, r.sampler, r.arrival,
             None if frames is None else frames[i:i + 1])
            for i, r in enumerate(_stream_requests())]
    out, t = {}, 0
    while todo or sched.n_active:
        while todo and todo[0][5] <= t and sched.has_free_slot():
            rid, prompt, n_new, seed, sc, _, fr = todo.pop(0)
            assert sched.admit(rid, prompt, n_new, seed, sc,
                               encoder_frames=fr)
        if sched.n_active:
            sched.step()
        out.update({f.rid: f.tokens for f in sched.pop_finished()})
        t += 1
    return out


@pytest.mark.parametrize("arch,cache_dtype", STEP_CASES)
def test_graphed_whisper_and_int8_serving_equals_the_eager_body(
        gen, arch, cache_dtype):
    """Reduced whisper (each request with its own frames) and the int8
    ring served continuously on the card: graphed per-step serving and
    fused horizons of 4 against eager step bodies, bit for bit, the
    samples through K3-K5."""
    from repro_torch.serving.scheduler import ContinuousScheduler

    cfg, params = _tiny_recurrent(gen, arch)
    state = gen.get_state()
    out = []
    for eager, horizon in ((True, 1), (False, 1), (False, 4)):
        gen.set_state(state)
        sch = ContinuousScheduler(cfg, params, n_slots=2, context=24,
                                  backend="hopper", cache_dtype=cache_dtype,
                                  step_horizon=horizon)
        if eager:
            sch.graphs = _Eager()
        out.append(_serve_with_frames(sch, gen, cfg))
        assert eager or len(sch.graphs.keys) >= 1
    assert out[0] == out[1] == out[2]


# ---------------------------------------------------------------------------
# training the hybrid, SSM and enc-dec families
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = {"hymba-1.5b": {}, "xlstm-1.3b": {},
                  "whisper-tiny": dict(n_microbatches=2)}


@pytest.mark.parametrize("arch", list(TRAIN_FAMILIES))
def test_family_train_steps_on_the_card_match_the_cpu_port(
        gen, arch, monkeypatch):
    """Two train steps of the reduced family (f32 params, the forward in
    f32 with TF32 off, remat, the quantile clip: K2 on the card, its
    plain version on the CPU; whisper in two microbatches with its
    frames) on the card and on the CPU from the same weights and
    batches: each step's loss within rtol 1e-5 and the params' change
    per leaf within l2 rel 1e-3 of the CPU's (float sums in another
    order)."""
    import functools

    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import step
    from repro_torch.tree import leaves, tree_map

    monkeypatch.setattr(step, "forward", functools.partial(
        forward, compute_dtype=torch.float32))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduced_config(arch)
    tc = step.TrainConfig(lr=1e-3, warmup_steps=5, total_steps=50,
                          clip_mode="quantile", param_dtype="float32",
                          **TRAIN_FAMILIES[arch])
    params0 = init_params(cfg, gen, torch.float32)
    batches = []
    for _ in range(2):
        b = {k: torch.randint(0, cfg.vocab, (2, 160), generator=gen,
                              device="cuda") for k in ("tokens", "targets")}
        if cfg.is_encdec:
            b["frames"] = _frames(cfg, gen, 2)
        batches.append(b)
    runs = {}
    for device in ("cuda", "cpu"):
        fn = step.make_train_step(cfg, tc, linear_warmup_cosine(1e-3, 5, 50))
        params = tree_map(lambda t: t.to(device, copy=True), params0)
        opt = adamw_init(params)
        losses = []
        for b in batches:
            params, opt, m = fn(params, opt,
                                {k: v.to(device) for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs[device] = (losses, params)
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=0)
    for p, c, p0 in zip(leaves(runs["cuda"][1]), leaves(runs["cpu"][1]),
                        leaves(params0)):
        dc = c - p0.cpu()
        assert (torch.linalg.vector_norm(p.cpu() - c)
                <= 1e-3 * torch.linalg.vector_norm(dc))


def test_flash_fwd_gradient_at_hymba_training_shape(gen):
    """K7 at hymba's training shape (B = 2, S = 4096, 25 query heads over
    5 K/V heads, head_dim 64, window 1024), f32: the gradients of the
    wrapper (K7 forward, the chunked flash_attend's vjp backward) within
    1e-4 of autograd through its plain version's on the card."""
    q, k, v = (t.requires_grad_(True)
               for t in _flash_inputs(gen, 2, 4096, 25, 5, 64,
                                      torch.float32))
    kw = dict(window=1024, n_rep=5)
    out = ops.flash_fwd(q, k, v, **kw)
    ct = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, (q, k, v), ct)
    want = torch.autograd.grad(ff.flash_fwd_plain(q, k, v, **kw), (q, k, v),
                               ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the mesh: ranks sharing cuda:0 over gloo (tests/torch_mesh_ranks.py)
# ---------------------------------------------------------------------------

def test_two_rank_sharded_solves_against_one_rank(gen):
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_local

    for out in spawn_local(ranks.cuda_solver_checks, 2, device="cuda",
                           args=("1x2",), timeout=600):
        for kind, r in out.items():
            assert r["ok"], kind
            name = {"count_above": "multi_count", "count_below":
                    "multi_count", "mass_at_or_above": "multi_mass",
                    "entropy_at_temperature": "multi_entropy_moments"}[kind]
            # one launch a round on the local shard, no whole-solve K3
            assert set(r["launches"]) == {name}, (kind, r["launches"])


def test_chunked_chip_level_root_through_k1(gen):
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_local

    for out in spawn_local(ranks.cuda_root_checks, 4, device="cuda",
                           args=("1x4", 100), timeout=600):
        for k, (equal, launches) in out.items():
            assert equal, k
            assert launches == 1 + -(-6 // k), (k, launches)


@pytest.mark.parametrize("spec,dtype", [("1x2", "bfloat16"),
                                        ("2x2", "float32")])
def test_meshed_step_tokens_equal_the_single_rank_step(gen, spec, dtype):
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_local

    world = 4 if spec == "2x2" else 2
    for out in spawn_local(ranks.cuda_step_checks, world, device="cuda",
                           args=(spec, dtype), timeout=600):
        assert out["mesh"] == out["single"]


@pytest.mark.parametrize("arch,mode", [("internlm2-1.8b", "fifo"),
                                       ("granite-moe-3b-a800m", "bisect")])
def test_meshed_train_step_equals_the_single_rank_step(gen, arch, mode):
    import numpy as np
    import torch_train_ranks as ranks
    from repro_torch.launch.mesh import spawn_local

    outs = spawn_local(ranks.cuda_train_checks, 2, device="cuda",
                       args=(arch, mode), timeout=600)
    for out in outs:
        mesh, single = out["mesh"], out["single"]
        for m, s in zip(mesh["metrics"], single["metrics"]):
            np.testing.assert_allclose(m["loss"], s["loss"], rtol=1e-5)
        for a, b in zip(mesh["params"], single["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for a, b in zip(mesh["keeps"], single["keeps"]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert mesh["digests"] == outs[0]["mesh"]["digests"]


@pytest.mark.parametrize("arch,mode", [("internlm2-1.8b", "fifo"),
                                       ("granite-moe-3b-a800m", "bisect")])
def test_tp_train_step_equals_the_single_rank_step(gen, arch, mode):
    """The tensor-parallel layout on a 1x2 mesh (two ranks sharing
    cuda:0, gloo): two f32 steps of the reduced model with the
    sequence-parallel stream against the single-rank step, losses rtol
    1e-5, the gathered params within 1e-5, keep masks bit for bit."""
    import numpy as np
    import torch_tp_ranks as ranks
    from repro_torch.launch.mesh import spawn_local

    outs = spawn_local(ranks.cuda_tp_checks, 2, device="cuda",
                       args=(arch, mode), timeout=600)
    for out in outs:
        tp, single = out["tp"], out["single"]
        for m, s in zip(tp["metrics"], single["metrics"]):
            np.testing.assert_allclose(m["loss"], s["loss"], rtol=1e-5)
        for a, b in zip(tp["params"], single["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for a, b in zip(tp["keeps"], single["keeps"]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert tp["metrics"] == outs[0]["tp"]["metrics"]
