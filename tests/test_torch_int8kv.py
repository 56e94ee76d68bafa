"""The port's int8 K/V cache against the JAX package's, on the same inputs.

``_quantize_kv`` / ``_dequantize_kv`` bit for bit on identical inputs
(random rows, rows of zeros, of +-the dtype's largest values, of values below
the 1e-6 floor, and rows built so that x / scale lands on .5 ties); the
prefill's codes and scales (``prefill(kv_dtype=torch.int8)``) for the
dense ring (qwen3-4b), hymba's rings and SSM, and whisper's ring and
encoder K/V; decode steps and a verify grid from a JAX int8 cache carried
across by ``convert.cache_from_jax``; JAX's own accuracy contract for an
int8 step; and the continuous dense ring with ``cache_dtype=torch.int8``:
frozen lanes, rollback and fused horizons, all with the scales beside the
codes.  Everything runs at ``models/testing.py::reduced_config`` sizes
with weights drawn by numpy (seed 0) in JAX's tree.

hymba and whisper are held against JAX's one-shot int8 prefill and steps,
not its continuous scheduler: JAX's ``init_cache(dtype=int8)`` makes the
encoder K/V and the SSM conv tail int8 too, and its admission casts the
bf16 prefill values into them (truncating them to integers), where the
port keeps them in the compute dtype as JAX's one-shot prefill does.

Tolerances:
  * quantization on identical inputs: bit for bit;
  * after a prefill (f32; the two frameworks' matmuls round apart, so a
    value may cross a .5 code boundary): codes within +-1, scales within
    one f16 ulp, every other cache leaf and the logits within 1e-5 of the
    largest |value|;
  * decode steps and verify rows from a converted JAX cache (f32): logits
    within 1e-5 of the largest |logit| (1e-3 at a step whose new row
    crossed a rounding boundary: ``CROSSED_REL``), the verify's stash
    (codes and scales) equal;
  * an int8 step (bf16): within 0.02 of the bf16 forward's largest
    |logit| (``tests/test_models_smoke.py::test_int8_kv_cache_decode``);
  * frozen lanes, rollback, fused against per-step: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention, decode, testing, transformer
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
from repro_torch.tree import leaves, leaves_with_path

QWEN, HYMBA, WHISPER = "qwen3-4b", "hymba-1.5b", "whisper-tiny"
S, N_DECODE = 10, 6
CONTEXT = S + N_DECODE
F32, I8 = torch.float32, torch.int8
REL = 1e-5


def _close(got, want, rel=REL):
    """max |got - want| within ``rel`` of the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _rows() -> np.ndarray:
    """(9, 2, 16) f32 rows: random at two scales, zeros, signs (scaled
    to +-the dtype's largest value by the caller), below the floor, and
    .5 ties (a row whose amax is 127 has scale 1.0, and k + 0.5 then
    rounds half to even; one whose amax is 63.5 has scale 0.5)."""
    rng = np.random.default_rng(0)
    x = np.zeros((9, 2, 16), np.float32)
    x[0] = rng.standard_normal((2, 16))
    x[1] = 300.0 * rng.standard_normal((2, 16))
    x[3] = rng.choice([-1.0, 1.0], (2, 16))
    x[4] = 3e-7 * rng.standard_normal((2, 16))
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5, 126.5, -126.5,
                     4.5, 5.5, -5.5, 6.5, 7.5, 8.5, 127.0], np.float32)
    x[5] = ties
    x[6] = -ties
    x[7] = ties / 2
    x[8, 0] = np.linspace(-127, 127, 16)
    x[8, 1] = rng.standard_normal(16)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bit_for_bit(dtype):
    """Codes, f16 scales and the dequantized values equal JAX's bit for
    bit, in f32 and in bf16, on rows that hold .5 ties."""
    x = _rows()
    x[3] *= float(torch.finfo(getattr(torch, dtype)).max)   # +-max values
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jattention._quantize_kv(jx)
    q, s = attention._quantize_kv(tx)
    assert q.dtype == I8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    xf = tx.float().numpy()
    ratio = xf[5:8] / np.abs(xf[5:8]).max(-1, keepdims=True) * 127
    assert (ratio - np.floor(ratio) == 0.5).sum() >= 16
    assert (q.numpy()[3] == np.sign(xf[3]) * 127).all()
    assert (q.numpy()[2] == 0).all()
    for out in (torch.float32, torch.bfloat16):
        jd = jattention._dequantize_kv(jq, js, getattr(jnp, str(out)[6:]))
        d = attention._dequantize_kv(q, s, out)
        np.testing.assert_array_equal(d.float().numpy(),
                                      np.asarray(jd, np.float32))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _draw(shapes, rng, std):
    """numpy leaves in the tree of ``shapes``: norm scales and ``d_skip``
    1, ``log_a`` JAX's S4D init, ``dt_bias`` N(0, 0.5), the rest N(0,
    std)."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name or name == "['d_skip']":
            return np.ones(leaf.shape, np.float32)
        if name == "['log_a']":
            return np.broadcast_to(np.log(np.arange(
                1, leaf.shape[-1] + 1, dtype=np.float32)), leaf.shape).copy()
        sd = 0.5 if name == "['dt_bias']" else std
        return (sd * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.cache
def _model(arch, std=0.1):
    """(JAX config, port config, JAX params, the port's copy); weights
    N(0, 0.1) by default, so that a row's K/V spread over many codes."""
    jcfg, cfg = jtesting.reduced_config(arch), testing.reduced_config(arch)
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    np_p = _draw(shapes, np.random.default_rng(0), std)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_p),
            params_from_jax(np_p, "cpu"))


@functools.cache
def _inputs(arch):
    """(tokens (2, CONTEXT), frames (2, T_enc, D) or None)."""
    cfg = _model(arch)[1]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, size=(2, CONTEXT)).astype(np.int32)
    frames = (rng.standard_normal((2, cfg.encoder_len, cfg.d_model))
              .astype(np.float32) if cfg.is_encdec else None)
    return tokens, frames


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@functools.cache
def _jax_prefill(arch):
    jcfg, _, jparams, _ = _model(arch)
    tokens, frames = _inputs(arch)
    return jdecode.prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]),
                           CONTEXT, encoder_frames=_jnp(frames),
                           compute_dtype=jnp.float32,
                           kv_dtype=jnp.int8)


def _same_quantized_cache(got, want_jax) -> int:
    """The port's cache against a JAX one: same leaves and dtypes; codes
    within +-1, scales within one f16 ulp, other leaves within REL.
    Returns how many codes and scales differ."""
    want = leaves_with_path(cache_from_jax(jax.device_get(want_jax), "cpu"))
    got = leaves_with_path(got)
    assert [p for p, _ in got] == [p for p, _ in want]
    n_codes = n_apart = 0
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype == I8:
            diff = (a.int() - b.int()).abs()
            assert diff.max() <= 1, path
            n_codes += diff.numel()
            n_apart += int((diff > 0).sum())
        elif a.dtype == torch.float16:
            an, bn = a.numpy(), b.numpy()
            ulp = np.spacing(np.maximum(np.abs(an), np.abs(bn)))
            assert (np.abs(an.astype(np.float32) - bn.astype(np.float32))
                    <= ulp.astype(np.float32)).all(), path
            n_apart += int((an != bn).sum())
        else:
            _close(a, b)
    assert n_codes > 0
    return n_apart


@pytest.mark.parametrize("arch", [QWEN, HYMBA, WHISPER])
def test_prefill_codes_within_one_of_jax(arch):
    """f32 ``prefill(kv_dtype=torch.int8)``: the last logits within 1e-5,
    every ring's codes within +-1 and scales within one f16 ulp of JAX's
    one-shot int8 prefill; hymba's SSM state and conv tail and whisper's
    encoder K/V stay in the compute dtype and within 1e-5."""
    _, cfg, _, params = _model(arch)
    tokens, frames = _inputs(arch)
    jlogits, jcache = _jax_prefill(arch)
    logits, cache = decode.prefill(cfg, params,
                                   torch.from_numpy(tokens[:, :S]), CONTEXT,
                                   encoder_frames=_torch(frames),
                                   compute_dtype=F32, kv_dtype=I8)
    _close(logits, jlogits)
    _same_quantized_cache(cache, jcache)
    for path, t in leaves_with_path(cache):
        assert t.dtype in ((I8,) if path.endswith(("/k", "/v")) and
                           "/kv/" in path else
                           (torch.float16,) if "scale" in path else (F32,))


# a step whose new K/V row crossed a code or f16-scale rounding boundary
# between the two frameworks (one f32 ulp of matmul rounding can): its
# logits move by what one code of one row's 254 moves the attention
# (1.3e-4 of the largest |logit| measured on whisper at this seed)
CROSSED_REL = 1e-3


@pytest.mark.parametrize("arch", [QWEN, HYMBA, WHISPER])
def test_decode_steps_from_a_converted_jax_cache(arch):
    """f32: six decode steps at a (B,) position, each from JAX's int8
    cache of that position carried across by ``cache_from_jax``: the
    rows the two steps write within one code and one scale ulp, and the
    logits within 1e-5 of JAX's wherever every code and scale came out
    equal (within CROSSED_REL where one crossed a rounding boundary,
    which happens at most once here)."""
    jcfg, cfg, jparams, params = _model(arch)
    tokens, _ = _inputs(arch)
    _, jcache = _jax_prefill(arch)
    dec = jax.jit(lambda p, t, pos, c: jdecode.decode_step(
        jcfg, p, t, pos, c, compute_dtype=jnp.float32))
    n_crossed = 0
    for pos in range(S, S + N_DECODE):
        cache = cache_from_jax(jax.device_get(jcache), "cpu")
        jlogits, jcache = dec(jparams, jnp.asarray(tokens[:, pos]),
                              jnp.full((2,), pos, jnp.int32), jcache)
        logits, cache = decode.decode_step(
            cfg, params, torch.from_numpy(tokens[:, pos]).long(),
            torch.full((2,), pos), cache, compute_dtype=F32)
        crossed = _same_quantized_cache(cache, jcache) > 0
        _close(logits, jlogits, CROSSED_REL if crossed else REL)
        n_crossed += crossed
    assert n_crossed <= 1


def test_decode_verify_from_a_converted_jax_cache():
    """f32: a verify grid of L = 3 over JAX's converted int8 cache: rows
    within 1e-5 of JAX's ``decode_verify``, its stash (the overwritten
    codes and scales) equal, the written rows within one code; rolling
    back every row restores the converted cache bit for bit."""
    jcfg, cfg, jparams, params = _model(QWEN)
    tokens, _ = _inputs(QWEN)
    _, jcache = _jax_prefill(QWEN)
    cache = cache_from_jax(jax.device_get(jcache), "cpu")
    before = [t.clone() for t in leaves(cache)]
    pos = np.array([S, S - 3], np.int32)
    feed = tokens[:, S:S + 3]
    jgrid, jcache2, jstash = jdecode.decode_verify(
        jcfg, jparams, jnp.asarray(feed), jnp.asarray(pos), jcache,
        compute_dtype=jnp.float32)
    grid, cache, stash = decode.decode_verify(
        cfg, params, torch.from_numpy(feed).long(),
        torch.from_numpy(pos).long(), cache, compute_dtype=F32)
    _close(grid, jgrid)
    want = leaves_with_path(cache_from_jax(jax.device_get(jstash), "cpu"))
    got = leaves_with_path(stash)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert {p.rsplit("/", 1)[1] for p, _ in got} == {"k", "v", "k_scale",
                                                     "v_scale"}
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _same_quantized_cache(cache, jcache2)
    decode.rollback_cache_runs(cache, stash, torch.from_numpy(pos).long(),
                               torch.zeros(2, dtype=torch.long))
    for a, b in zip(leaves(cache), before):
        assert torch.equal(a, b)


def test_int8_step_within_jax_contract_of_the_bf16_forward():
    """JAX's contract on the port, at its test's weight scale (N(0, 0.02),
    ``init_params``'s): after an int8 prefill, one bf16 decode step's
    logits lie within 0.02 of the bf16 forward's largest |logit| of the
    forward's at that position.  (At N(0, 0.1) the two packages' bf16
    forwards alone lie 0.04 apart, 0.8 of that limit.)"""
    _, cfg, _, params = _model(QWEN, 0.02)
    tokens = torch.from_numpy(_inputs(QWEN)[0]).long()
    full, _ = transformer.forward(cfg, params, tokens, remat=False)
    _, cache = decode.prefill(cfg, params, tokens[:, :S], CONTEXT,
                              kv_dtype=I8)
    assert cache[0]["kv"].k.dtype == I8
    lg, cache = decode.decode_step(cfg, params, tokens[:, S], S, cache)
    scale = float(full.abs().max())
    assert float((lg - full[:, S]).abs().max()) < 0.02 * max(scale, 1.0)


# ---------------------------------------------------------------------------
# the continuous dense ring
# ---------------------------------------------------------------------------

def _scheduler(**kw):
    _, cfg, _, params = _model(QWEN)
    return ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                               cache_dtype=I8, **kw)


def test_int8_frozen_lanes_keep_codes_and_scales():
    """Lane 1 served a request that finished: a step leaves its codes and
    scales bit for bit, while lane 0's move."""
    sch = _scheduler()
    vocab = sch.cfg.vocab
    prompts = np.random.default_rng(5).integers(0, vocab, size=(2, S))
    assert sch.admit("b", prompts[0].tolist(), N_DECODE, seed=0)
    assert sch.admit("a", prompts[1].tolist(), 2, seed=1)
    sch.step()
    assert sch.slots[1] is None and sch.slots[0] is not None
    before = leaves_with_path(sch.cache)
    before = [(p, t.clone()) for p, t in before]
    assert {p.rsplit("/", 1)[1] for p, _ in before} == {"k", "v", "k_scale",
                                                        "v_scale"}
    sch.step()
    for (path, old), t in zip(before, leaves(sch.cache)):
        assert torch.equal(t[:, 1], old[:, 1]), path
        assert not torch.equal(t[:, 0], old[:, 0]), path


def test_int8_verify_rollback_and_lane_freeze_restore_scales():
    """``rollback_cache_runs`` with nothing kept, and ``freeze_cache_lanes``
    with no lane active, put back the codes and the scales a verify grid
    or a step wrote, bit for bit."""
    _, cfg, _, params = _model(QWEN)
    tokens = torch.from_numpy(_inputs(QWEN)[0]).long()
    _, cache = decode.prefill(cfg, params, tokens[:, :S], CONTEXT,
                              kv_dtype=I8)
    before = [t.clone() for t in leaves(cache)]
    pos = torch.tensor([S, S - 2])
    _, cache, stash = decode.decode_verify(cfg, params, tokens[:, S:S + 4],
                                           pos, cache)
    assert any(not torch.equal(a, b) for a, b in zip(leaves(cache), before))
    decode.rollback_cache_runs(cache, stash, pos, torch.zeros(2).long())
    assert all(torch.equal(a, b) for a, b in zip(leaves(cache), before))
    lanes = decode.cache_lanes(cache, pos)
    assert lanes[0].k_scale.shape == (cfg.n_layers, 2, cfg.n_kv_heads)
    decode.decode_step(cfg, params, tokens[:, S], pos, cache)
    decode.freeze_cache_lanes(cache, lanes, pos,
                              torch.zeros(2, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(leaves(cache), before))


def _requests(vocab, sampler):
    rng = np.random.default_rng(9)
    n_new = [5, 3, 1, 6, 4]
    return [Request(f"r{i}", rng.integers(0, vocab, size=S).tolist(),
                    n_new[i], seed=10 + i, sampler=sampler, arrival=i // 2)
            for i in range(5)]


@pytest.mark.parametrize("draft_len", [1, 3])
def test_int8_fused_horizons_equal_per_step(draft_len):
    """Sampled requests (top-k, top-p, entropy) over two int8 slots, per
    step and speculative at draft_len 3: fused horizons of 4 stream what
    per-step serving streams, bit for bit (the speculative pair both with
    the device-capable repeat-last drafter)."""
    from repro_torch.serving.draft import RepeatLastDrafter

    _, cfg, _, params = _model(QWEN)
    sc = SamplerConfig(top_k=40, top_p=0.9, target_entropy=3.0)
    spec = (dict(draft_len=draft_len, drafter=RepeatLastDrafter())
            if draft_len > 1 else {})
    out = []
    for k in (1, 4):
        srv = RunaheadServer(cfg, params, n_slots=2,
                             context=CONTEXT + draft_len - 1,
                             cache_dtype=I8, step_horizon=k, **spec)
        out.append({c.rid: c.tokens for c in srv.run(
            _requests(cfg.vocab, sc))})
    assert out[0] == out[1]
    assert all(len(t) for t in out[0].values())


def test_int8_admission_refuses_a_float_prefill():
    """An int8 ring takes int8 codes only: writing a bf16 prefill into it
    raises instead of truncating its values to integers (what the JAX
    scheduler's cast does to an int8 cache's float leaves)."""
    _, cfg, _, params = _model(QWEN)
    cache = decode.init_cache(cfg, 2, CONTEXT, I8, device="cpu")
    tokens = torch.from_numpy(_inputs(QWEN)[0][:1, :S]).long()
    with pytest.raises(ValueError, match="kv_dtype"):
        decode.prefill_into_slot(cfg, params, tokens, CONTEXT, cache, 1)
    decode.prefill_into_slot(cfg, params, tokens, CONTEXT, cache, 1,
                             kv_dtype=I8)
    assert cache[0]["kv"].k[:, 1].abs().max() > 0
    assert cache[0]["kv"].k_scale[:, 1].abs().max() > 0


def test_paged_int8_raises_as_jax():
    """The page pool refuses int8 K/V, in ``init_paged_pool`` and in the
    scheduler, with JAX's message."""
    jcfg, cfg, jparams, params = _model(QWEN)
    with pytest.raises(ValueError, match="int8") as jerr:
        jdecode.init_paged_pool(jcfg, 8, 4, jnp.int8)
    with pytest.raises(ValueError, match="int8") as err:
        decode.init_paged_pool(cfg, 8, 4, I8, device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="int8"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            cache_dtype=I8, page_size=4)
