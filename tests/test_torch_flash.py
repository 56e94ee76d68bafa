"""K7 and the chunked flash attention of the port against the JAX package's.

Inputs come from numpy seeds and go through both packages; the JAX K7
runs in Pallas interpret mode, as its own tests run it.  Tolerances:
  * f32 attention outputs: atol 2e-5, rtol 1e-4, JAX's own for K7 and
    ``flash_attend`` (tests/test_kernels.py, tests/test_flash_attention.py):
    sums and exps in another order;
  * gradients: atol 5e-4, rtol 1e-3, JAX's own for K7's vjp;
  * bf16 ``flash_attend``: atol 1e-2, rtol 1e-2 compared in f32: both
    packages cast p to bf16 before P.V and the output to bf16, so a
    rounding flip moves an output by one bf16 ulp (2**-8 relative); the
    bf16 plain K7 against JAX's bf16 ``flash_attend`` at the same: it
    rounds p to bf16 too (JAX also rounds each chunk's P.V to bf16);
  * the port's bf16 ``attend`` against JAX's: atol 3e-2 compared in f32:
    the bf16 projections before and after attention round in other
    places, and JAX rounds each chunk's P.V to bf16;
  * grouped GQA against repeated K/V: bit for bit for K7's plain version
    (it reads kv head h // n_rep, the same values), 2e-5 for
    ``flash_attend`` (its grouped einsums sum in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_fwd import flash_fwd as jflash_fwd
from repro.models import attention as jattention
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro_torch.convert import params_from_jax
from repro_torch.kernels import blocks, ops
from repro_torch.kernels import flash_fwd as ff
from repro_torch.models import attention
from repro_torch.models import testing, transformer
import torch_one_thread  # noqa: F401 (one torch thread)

F32 = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=1e-3)


def _qkv(B, S, H, D, seed, n_kv=None):
    rng = np.random.default_rng(seed)
    n_kv = n_kv or H
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("S,window", [(512, 0), (1024, 0), (512, 128),
                                      (1024, 128)])
def test_plain_k7_matches_jax_k7(S, window):
    q, k, v = _qkv(2, S, 3, 32, seed=S + window)
    want = jflash_fwd(*_j(q, k, v), 128, 128, window, True)
    got = ff.flash_fwd_plain(*_t(q, k, v), window=window, q_chunk=128,
                             kv_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("S", [63, 512, 640, 1500])
def test_flash_attend_causal_matches_jax(S):
    q, k, v = _qkv(2, S, 4, 32, seed=0)
    want = jattention.flash_attend(*_j(q, k, v), causal=True, q_chunk=128,
                                   kv_chunk=256)
    got = attention.flash_attend(*_t(q, k, v), causal=True, q_chunk=128,
                                 kv_chunk=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [32, 128, 600])
def test_flash_attend_banded_matches_jax(window):
    q, k, v = _qkv(2, 640, 4, 32, seed=1)
    want = jattention.flash_attend(*_j(q, k, v), causal=True, window=window,
                                   q_chunk=128, kv_chunk=256)
    got = attention.flash_attend(*_t(q, k, v), causal=True, window=window,
                                 q_chunk=128, kv_chunk=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attend_bf16_matches_jax():
    q, k, v = _qkv(2, 512, 4, 32, seed=2)
    want = jattention.flash_attend(*_j(q, k, v, dtype=jnp.bfloat16),
                                   causal=True, q_chunk=128, kv_chunk=128)
    got = attention.flash_attend(*_t(q, k, v, dtype=torch.bfloat16),
                                 causal=True, q_chunk=128, kv_chunk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("n_rep", [1, 2])
def test_plain_k7_bf16_matches_jax_flash_attend(n_rep):
    q, k, v = _qkv(2, 512, 2 * n_rep, 32, seed=10, n_kv=2)
    want = jattention.flash_attend(*_j(q, k, v, dtype=jnp.bfloat16),
                                   causal=True, q_chunk=128, kv_chunk=128,
                                   n_rep=n_rep)
    got = ff.flash_fwd_plain(*_t(q, k, v, dtype=torch.bfloat16),
                             n_rep=n_rep, q_chunk=128, kv_chunk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_bf16_check_passes_the_tiled_plain_version_and_fails_a_dropped_tile():
    """``flash_fwd.bf16_check``, which holds the bf16 kernel on the card:
    the bf16 plain version at the kernel's key tile (128 at head_dim 32,
    the tile the test above holds against JAX) passes it; the same with
    the P.V of one key tile dropped, for the rows past that tile, fails."""
    q, k, v = _t(*_qkv(1, 512, 2, 32, seed=12, n_kv=1), dtype=torch.bfloat16)
    tile = ff.tc_kv_tile(32)
    good = ff.flash_fwd_plain(q, k, v, n_rep=2, kv_chunk=tile)
    accuracy = ff.bf16_check(good, q, k, v, n_rep=2)
    assert accuracy.ok and accuracy.worst == 0, str(accuracy)
    v_dropped = v.clone()
    v_dropped[:, 256:256 + tile] = 0
    bad = ff.flash_fwd_plain(q, k, v_dropped, n_rep=2, kv_chunk=tile)
    assert torch.equal(bad[:, :256], good[:, :256])
    assert not ff.bf16_check(bad, q, k, v, n_rep=2).ok


def test_flash_attend_banded_ragged_matches_dense_reference():
    """A band whose last query chunk runs past S (S = 300, chunk 128):
    the port's flash_attend equals the full-materialisation attention.
    JAX's does not there (its dynamic_slice clamps the last band's start
    and shifts its keys; ROADMAP Queue 3), so this case is held to the
    dense reference instead of to JAX."""
    S, window = 300, 50
    q, k, v = _t(*_qkv(1, S, 2, 16, seed=3))
    pos = torch.arange(S)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                              - window)
    want = attention._sdpa(q, k, v, mask[None, None], 1)
    got = attention.flash_attend(q, k, v, window=window, q_chunk=128,
                                 kv_chunk=128)
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("n_rep", [2, 4])
def test_flash_attend_grouped_matches_jax(n_rep):
    q, k, v = _qkv(2, 384, 3 * n_rep, 16, seed=4, n_kv=3)
    want = jattention.flash_attend(*_j(q, k, v), causal=True, q_chunk=128,
                                   kv_chunk=128, n_rep=n_rep)
    got = attention.flash_attend(*_t(q, k, v), causal=True, q_chunk=128,
                                 kv_chunk=128, n_rep=n_rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_n_rep_grouping_equals_repeated_kv(n_rep):
    q, k, v = _t(*_qkv(2, 300, 2 * n_rep, 16, seed=5, n_kv=2))
    kr, vr = (t.repeat_interleave(n_rep, dim=2) for t in (k, v))
    for window in (0, 50):
        grouped = ff.flash_fwd_plain(q, k, v, window=window, n_rep=n_rep,
                                     q_chunk=128, kv_chunk=128)
        repeated = ff.flash_fwd_plain(q, kr, vr, window=window, q_chunk=128,
                                      kv_chunk=128)
        assert torch.equal(grouped, repeated)
        torch.testing.assert_close(
            attention.flash_attend(q, k, v, window=window, q_chunk=128,
                                   kv_chunk=128, n_rep=n_rep),
            attention.flash_attend(q, kr, vr, window=window, q_chunk=128,
                                   kv_chunk=128), **F32)


@pytest.mark.parametrize("window,n_rep", [(0, 1), (64, 2)])
def test_flash_fwd_grads_match_jax(window, n_rep):
    """ops.flash_fwd's autograd rule (K7's plain version forward, the
    chunked flash_attend's vjp backward) against JAX flash_fwd's
    custom_vjp at the same chunks; GQA against JAX on repeated K/V."""
    S = 256
    q, k, v = _qkv(1, S, 2 * n_rep, 16, seed=6, n_kv=2)
    ct = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    qc, kc = blocks.divisor_chunk(S, blocks.Q_CHUNK), blocks.divisor_chunk(
        S, blocks.KV_CHUNK)

    def jloss(q_, k_, v_):
        k_, v_ = (jnp.repeat(t, n_rep, axis=2) for t in (k_, v_))
        return jnp.sum(jflash_fwd(q_, k_, v_, qc, kc, window, True) * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    ts = [t.requires_grad_(True) for t in _t(q, k, v)]
    out = ops.flash_fwd(*ts, window=window, n_rep=n_rep)
    (out * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, k, v = _t(*_qkv(1, 130, 4, 16, seed=8, n_kv=2))
    ops.reset_launches()
    got = ops.flash_fwd(q, k, v, window=0, n_rep=2)
    want = ff.flash_fwd_plain(q, k, v, n_rep=2,
                              q_chunk=blocks.divisor_chunk(130,
                                                           blocks.Q_CHUNK),
                              kv_chunk=blocks.divisor_chunk(130,
                                                            blocks.KV_CHUNK))
    assert torch.equal(got, want)
    assert ops.LAUNCHES["flash_fwd"] == 0
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.flash_fwd(q, k.to("meta"), v, n_rep=2)


def test_divisor_chunk_matches_jax():
    from repro.kernels.blocks import divisor_chunk as jdivisor_chunk

    for n in (1, 7, 256, 640, 1000, 1500, 4096, 4097):
        for target in (1, 128, 512, 1024):
            assert blocks.divisor_chunk(n, target) == jdivisor_chunk(n,
                                                                     target)


@pytest.fixture(scope="module")
def tiny():
    """A 2-layer tiny internlm2 (GQA 4/2, head_dim 16) from JAX weights."""
    cfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                              n_layers=2)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    tcfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                               n_layers=2)
    return cfg, tcfg, jparams, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_at_flash_min_seq_matches_jax(tiny, dtype):
    """attend's flash branch (S = 4096: K7 through ops.flash_fwd) against
    JAX attend's (the chunked flash_attend), on layer 0 of the tiny model;
    f32 first, then bf16 (see the module note on P.V)."""
    cfg, tcfg, jparams, params = tiny
    S = attention.FLASH_MIN_SEQ
    assert S == jattention.FLASH_MIN_SEQ
    x = np.random.default_rng(9).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["runs"][0]["attn"])
    tp = transformer.layer_unbind(params["runs"][0]["attn"], 1)[0]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    want = jattention.attend(jp, cfg, jnp.asarray(x, jdt), jnp.asarray(pos))
    got = attention.attend(tp, tcfg, torch.from_numpy(x).to(tdt),
                           torch.from_numpy(pos.copy()))
    tol = F32 if dtype == "float32" else dict(atol=3e-2, rtol=0.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
