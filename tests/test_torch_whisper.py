"""The port's whisper-tiny (encoder, cross-attention, the ``whisper_dec``
kind) against the JAX package's, on the same inputs.

At ``models/testing.py::reduced_config`` sizes (2 encoder and 4 decoder
layers, encoder_len 16, d_model 64, vocab 256): the encoder, cross
attention in its full-sequence and decode forms, ``forward``,
``prefill`` (the cache held leaf by leaf through
``convert.cache_from_jax``, the encoder K/V included) and eight decode
steps at a scalar and at a (B,) position; greedy one-shot and continuous
streams against JAX's (the continuous ones admitting each request with
its own frames, per step and in fused horizons of 4); frozen lanes; the
refusals; the launcher.  Weights are drawn by numpy (seed 0) in JAX's
tree and shapes (``jax.eval_shape`` of its ``init_params``): norm scales
1, every other weight, biases and both learned position tables included,
N(0, 0.02).  Frames are numpy N(0, 1) (B, T_enc, D) in f32, cast by
both packages to the compute dtype.

Tolerances:
  * logits, encoder outputs and caches (f32): within 1e-5 of the largest
    |logit| (of the largest |value| for the encoder and cache leaves);
  * greedy token streams (bf16, JAX's serving dtype): equal, on prompts
    screened for a top-1 / top-2 logit gap above four bf16 ulps of the
    row's largest |logit| at every step (along the port's stream);
  * fused horizons against per-step serving, and a frozen lane's cache:
    bit for bit.
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
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro.serving import scheduler as jscheduler
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention, decode, testing, transformer
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.tree import leaves, leaves_with_path
import torch_one_thread  # noqa: F401 (one torch thread)

ARCH = "whisper-tiny"
S, N_DECODE = 8, 8
CONTEXT = S + N_DECODE
MAX_NEW = 6
F32 = torch.float32
REL = 1e-5


def _close(got, want, rel=REL):
    """max |got - want| within ``rel`` of the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


@functools.cache
def _model():
    """(JAX config, port config, JAX params, the port's copy)."""
    jcfg, cfg = jtesting.reduced_config(ARCH), testing.reduced_config(ARCH)
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if "scale" in jax.tree_util.keystr(path[-1:]):
            return np.ones(leaf.shape, np.float32)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    np_p = jax.tree_util.tree_map_with_path(draw, shapes)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_p),
            params_from_jax(np_p, "cpu"))


def _frames(n: int, seed: int = 3) -> np.ndarray:
    cfg = _model()[1]
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.encoder_len, cfg.d_model)).astype(np.float32)


@functools.cache
def _tokens():
    return np.random.default_rng(2).integers(
        0, _model()[1].vocab, size=(2, CONTEXT)).astype(np.int32)


def test_init_has_jax_tree_and_shapes():
    """The port's own init builds JAX's tree (the decoder's learned
    positions, the encoder's blocks, norm and positions), leaf shapes and
    dtypes, and ``ported_plan`` runs whisper_dec."""
    jcfg, cfg, _, params = _model()
    assert transformer.ported_plan(cfg) == jtransformer.layer_plan(jcfg)
    own = transformer.init_params(cfg, torch.Generator().manual_seed(0), F32)
    assert ([p for p, _ in leaves_with_path(own)]
            == [p for p, _ in leaves_with_path(params)])
    for a, b in zip(leaves(own), leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert own["pos_embed"].shape == (32_768, cfg.d_model)
    assert own["encoder"]["pos_embed"].shape == (cfg.encoder_len,
                                                 cfg.d_model)


def test_encode_matches_jax():
    """f32: the encoder's output over the frames against JAX's."""
    jcfg, cfg, jparams, params = _model()
    fr = _frames(2)
    want = jtransformer.encode(jcfg, jparams, jnp.asarray(fr))
    got = transformer.encode(cfg, params, torch.from_numpy(fr))
    _close(got, want)


def test_cross_attention_matches_jax():
    """f32: ``attend(kv_src=...)`` (K/V from the encoder output, no RoPE,
    no mask) and ``decode_cross_attend`` over the projected encoder K/V
    against JAX's, layer 0's cross-attention weights."""
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["runs"][0]["xattn"])
    p = {k: v[0] for k, v in params["runs"][0]["xattn"].items()}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want, (jk, jv) = jattention.attend(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=False,
        kv_src=jnp.asarray(enc), return_kv=True)
    got, (k, v) = attention.attend(
        p, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        causal=False, kv_src=torch.from_numpy(enc), return_kv=True)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)
    want = jattention.decode_cross_attend(jp, jcfg, jnp.asarray(x[:, :1]),
                                          jk, jv)
    got = attention.decode_cross_attend(p, cfg, torch.from_numpy(x[:, :1]),
                                        k, v)
    _close(got, want)


@functools.cache
def _jax_fns():
    jcfg = _model()[0]
    fwd = jax.jit(lambda p, t, f: jtransformer.forward(
        jcfg, p, t, encoder_frames=f, compute_dtype=jnp.float32)[0])
    pre = jax.jit(lambda p, t, f: jdecode.prefill(
        jcfg, p, t, CONTEXT, encoder_frames=f, compute_dtype=jnp.float32))
    dec = jax.jit(lambda p, t, pos, c: jdecode.decode_step(
        jcfg, p, t, pos, c, compute_dtype=jnp.float32))
    return fwd, pre, dec


def test_forward_matches_jax():
    """f32: the full forward's logits at every position against JAX's."""
    _, cfg, jparams, params = _model()
    tokens, fr = _tokens(), _frames(2)
    logits, aux = transformer.forward(
        cfg, params, torch.from_numpy(tokens),
        encoder_frames=torch.from_numpy(fr), compute_dtype=F32)
    _close(logits, _jax_fns()[0](jparams, jnp.asarray(tokens),
                                 jnp.asarray(fr)))
    assert float(aux) == 0.0


@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode_match_jax(per_slot):
    """f32: the prefill's last logits and its cache leaf by leaf (the
    self-attention ring, the encoder K/V), then eight decode steps at a
    scalar or a (B,) position (the learned position added as
    ``pos_embed[pos]``), logits and cache, against JAX's; and the port's
    own steps against its full forward."""
    _, cfg, jparams, params = _model()
    _, pre, dec = _jax_fns()
    tokens, fr = _tokens(), _frames(2)
    full, _ = transformer.forward(cfg, params, torch.from_numpy(tokens),
                                  encoder_frames=torch.from_numpy(fr),
                                  compute_dtype=F32)
    jlogits, jcache = pre(jparams, jnp.asarray(tokens[:, :S]),
                          jnp.asarray(fr))
    logits, cache = decode.prefill(cfg, params,
                                   torch.from_numpy(tokens[:, :S]), CONTEXT,
                                   encoder_frames=torch.from_numpy(fr),
                                   compute_dtype=F32)
    _close(logits, jlogits)
    _close(logits, full[:, S - 1])

    def same_cache():
        want = leaves_with_path(cache_from_jax(jax.device_get(jcache),
                                               "cpu"))
        got = leaves_with_path(cache)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert {p.split("/")[1] for p, _ in got} == {"kv", "enc_k", "enc_v"}
        for (_, a), (_, b) in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            _close(a, b)

    same_cache()
    enc_before = [cache[0]["enc_k"].clone(), cache[0]["enc_v"].clone()]
    for pos in range(S, S + N_DECODE):
        tok = tokens[:, pos]
        jpos = jnp.full((2,), pos, jnp.int32) if per_slot else jnp.int32(pos)
        tpos = torch.full((2,), pos) if per_slot else pos
        jlogits, jcache = dec(jparams, jnp.asarray(tok), jpos, jcache)
        logits, cache = decode.decode_step(
            cfg, params, torch.from_numpy(tok).long(), tpos, cache,
            compute_dtype=F32)
        _close(logits, jlogits)
        _close(logits, full[:, pos])
    same_cache()
    assert torch.equal(cache[0]["enc_k"], enc_before[0])
    assert torch.equal(cache[0]["enc_v"], enc_before[1])


def test_init_cache_holds_the_encoder_kv():
    """``init_cache`` allocates the encoder K/V (layers, B, T_enc, n_kv,
    hd) as JAX's does, in the cache dtype; under int8 K/V they stay in
    the compute dtype while the ring holds codes and scales."""
    jcfg, cfg, _, _ = _model()
    want = cache_from_jax(jax.device_get(jdecode.init_cache(
        jcfg, 2, CONTEXT, encoder_len=5)), "cpu")
    got = decode.init_cache(cfg, 2, CONTEXT, device="cpu", encoder_len=5)
    assert ([(p, t.shape, t.dtype) for p, t in leaves_with_path(got)]
            == [(p, t.shape, t.dtype) for p, t in leaves_with_path(want)])
    q8 = decode.init_cache(cfg, 2, CONTEXT, torch.int8, device="cpu",
                           compute_dtype=F32)
    assert q8[0]["enc_k"].dtype == F32 and q8[0]["kv"].quantized
    assert q8[0]["kv"].k_scale.shape == (cfg.n_layers, 2, CONTEXT,
                                         cfg.n_kv_heads)


# ---------------------------------------------------------------------------
# serving streams
# ---------------------------------------------------------------------------

def _gap_ok(logits) -> np.ndarray:
    """Rows whose top-1 / top-2 gap exceeds four bf16 ulps of the row's
    largest |logit| (the two packages' bf16 logits differ by up to one)."""
    lg = np.asarray(logits, np.float32)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > 4 * 2.0 ** -7 * np.abs(lg).max(-1)


@functools.cache
def _screened():
    """The first eight of 48 seeded (prompt, frames) candidates whose
    greedy bf16 stream is clear of ties at every step, decoded as one
    batch along the port's stream: ((8, S) prompts, (8, T, D) frames)."""
    _, cfg, _, params = _model()
    cand = np.random.default_rng(7).integers(
        0, cfg.vocab, size=(48, S)).astype(np.int32)
    fr = _frames(48, seed=8)
    lg, cache = decode.prefill(cfg, params, torch.from_numpy(cand).long(),
                               S + MAX_NEW,
                               encoder_frames=torch.from_numpy(fr))
    ok = np.ones(len(cand), bool)
    for i in range(MAX_NEW):
        ok &= _gap_ok(lg)
        if i < MAX_NEW - 1:
            lg, cache = decode.decode_step(cfg, params, lg.argmax(-1), S + i,
                                           cache)
    assert ok.sum() >= 8
    return cand[ok][:8], fr[ok][:8]


def test_greedy_oneshot_stream_matches_jax():
    """Four screened prompts with their frames in one batch:
    ``generate(encoder_frames=...)``'s greedy tokens equal JAX's (bf16)."""
    jcfg, cfg, jparams, params = _model()
    prompts, fr = (a[:4] for a in _screened())
    want = np.asarray(jengine.generate(
        jcfg, jparams, jnp.asarray(prompts), MAX_NEW, jax.random.PRNGKey(0),
        sampler=jsampler.SamplerConfig(greedy=True),
        encoder_frames=jnp.asarray(fr)))
    got = generate(cfg, params, torch.from_numpy(prompts).long(), MAX_NEW,
                   None, sampler=SamplerConfig(greedy=True),
                   encoder_frames=torch.from_numpy(fr))
    np.testing.assert_array_equal(got.numpy(), want)


def serve_with_frames(sched, requests, to_device):
    """Serve ``requests`` [(rid, prompt, n_new, seed, frames (T, D),
    arrival step)] through a scheduler of either package, each admitted
    with its own frames (the servers take none, in both packages): at
    decode step t the requests arrived by t are admitted while a slot is
    free, then one ``step``.  Returns {rid: tokens}."""
    sc = (SamplerConfig(greedy=True) if isinstance(sched, ContinuousScheduler)
          else jsampler.SamplerConfig(greedy=True))
    todo, out, t = list(requests), {}, 0
    while todo or sched.n_active:
        while todo and todo[0][5] <= t and sched.has_free_slot():
            rid, prompt, n_new, seed, fr, _ = todo.pop(0)
            assert sched.admit(rid, prompt, n_new, seed, sc,
                               encoder_frames=to_device(fr[None]))
        if sched.n_active:
            sched.step()
        for fin in sched.pop_finished():
            out[fin.rid] = list(fin.tokens)
        t += 1
    return out


def _requests():
    prompts, fr = (a[:5] for a in _screened())
    n_new = [5, 3, 1, 6, 4]
    return [(f"r{i}", p.tolist(), n_new[i], 10 + i, fr[i], i // 2)
            for i, p in enumerate(prompts)]


@functools.cache
def _jax_continuous():
    jcfg, _, jparams, _ = _model()
    sched = jscheduler.ContinuousScheduler(jcfg, jparams, n_slots=2,
                                           context=S + MAX_NEW)
    return serve_with_frames(sched, _requests(), jnp.asarray)


@pytest.mark.parametrize("step_horizon", [1, 4])
def test_continuous_streams_match_jax_per_step(step_horizon):
    """Five screened greedy requests, each admitted with its own frames,
    over two slots of the dense ring (staggered arrivals, queueing, a
    request done at admission, lanes frozen while idle): the port's
    streams, per step and in fused horizons of 4, equal JAX's per-step
    ``ContinuousScheduler``'s."""
    _, cfg, _, params = _model()
    sched = ContinuousScheduler(cfg, params, n_slots=2, context=S + MAX_NEW,
                                step_horizon=step_horizon)
    got = serve_with_frames(sched, _requests(), torch.from_numpy)
    assert got == _jax_continuous()
    assert all(len(got[r[0]]) == r[2] for r in _requests())


def test_inactive_lane_state_is_frozen():
    """Lane 1 served a request that finished: a step leaves its whole
    cache entry (the ring and the encoder K/V of that request) bit for
    bit as it was, while the live lane 0's ring moves."""
    _, cfg, _, params = _model()
    sch = ContinuousScheduler(cfg, params, n_slots=2, context=S + MAX_NEW)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, S))
    fr = torch.from_numpy(_frames(2, seed=6))
    assert sch.admit("b", prompts[0].tolist(), MAX_NEW, seed=0,
                     encoder_frames=fr[:1])
    assert sch.admit("a", prompts[1].tolist(), 2, seed=0,
                     encoder_frames=fr[1:])
    sch.step()
    assert sch.slots[1] is None and sch.slots[0] is not None
    before = [t.clone() for t in leaves(sch.cache)]
    assert before[0][:, 1].abs().max() > 0       # lane 1's encoder K/V
    sch.step()
    for (path, t), b in zip(leaves_with_path(sch.cache), before):
        assert torch.equal(t[:, 1], b[:, 1]), path
        if "enc_" in path:
            assert torch.equal(t[:, 0], b[:, 0]), path
    assert not torch.equal(sch.cache[0]["kv"].k[:, 0], before[2][:, 0])


def test_paged_speculative_and_missing_frames_raise_as_jax():
    """The paged cache and speculative verify stay refused for whisper
    with JAX's refusal (a ValueError naming the dense stack); a prefill
    of an enc-dec arch without frames raises."""
    jcfg, cfg, jparams, params = _model()
    assert not decode.paged_supported(cfg) and not jdecode.paged_supported(
        jcfg)
    assert not decode.verify_supported(cfg) and not jdecode.verify_supported(
        jcfg)
    for kw in (dict(draft_len=2), dict(page_size=4)):
        with pytest.raises(ValueError, match="dense") as jerr:
            jscheduler.ContinuousScheduler(jcfg, jparams, n_slots=2,
                                           context=CONTEXT, **kw)
        with pytest.raises(ValueError, match="dense") as err:
            ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                                **kw)
        assert (str(err.value).split(" ")[:6]
                == str(jerr.value).split(" ")[:6])
    with pytest.raises(ValueError, match="encoder_frames"):
        decode.prefill(cfg, params, torch.zeros((1, S), dtype=torch.long),
                       CONTEXT)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
          str(S), "--new-tokens", "4", "--top-k", "40", "--top-p", "0.9",
          "--target-entropy", "3.0"]


def test_launcher_serves_one_shot_on_cpu():
    """``launch.serve`` one-shot: frames drawn from the seed after the
    prompt, every token in range; the same seed gives the same tokens."""
    from repro_torch.launch import serve

    cfg = testing.reduced_config(ARCH)
    out = serve.main(LAUNCH + ["--batch", "2"])
    assert tuple(out.tokens.shape) == (2, 4)
    assert bool(((out.tokens >= 0) & (out.tokens < cfg.vocab)).all())
    again = serve.main(LAUNCH + ["--batch", "2"])
    assert torch.equal(out.tokens, again.tokens)


@pytest.mark.parametrize("flags", [["--continuous"],
                                   ["--continuous", "--page-size", "4"],
                                   ["--page-size", "4"],
                                   ["--draft-len", "3"]])
def test_launcher_refuses_continuous_paged_and_speculative(flags):
    """As the JAX launcher: ``--continuous`` does not drive an enc-dec
    arch, and the paged and speculative flags need it."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(LAUNCH + flags)
