"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device.  On a
GPU machine run ``python -m pytest -m cuda tests/test_torch_cuda.py``
(this file imports no JAX).  K1, K2 and K3 must match exactly; K4 and
K5 within rtol=1e-5, atol=1e-6 (f32 sums in another order) and bit for
bit from one run to the next; K6 within rtol=atol=1e-5 on f32 pools and
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
