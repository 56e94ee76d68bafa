"""The port's recurrent families against the JAX package's, on the same
inputs: xlstm-1.3b's mLSTM / sLSTM stack and hymba-1.5b's attention ||
SSM blocks.

The mixers (``repro_torch.models.xlstm``, ``repro_torch.models.ssm``)
first, each full-sequence form with its carried-out state and its decode
step, at S = CHUNK + 5 and CHUNK + 7 (the padded last chunk), and the
port's chunked forms against its own steps (``tests/test_mixers.py``'s
cases).  Then the slice as a whole at ``models/testing.py::
reduced_config`` sizes: ``forward``, ``prefill`` (the cache held leaf by
leaf through ``convert.cache_from_jax``) and eight decode steps; greedy
one-shot and continuous streams against JAX's; fused horizons against
per-step serving; frozen lanes; the launcher.  The hymba prompt runs past
the reduced window of 8, so its SWA ring wraps in the prefill and again
in the decode.  Weights are drawn by numpy (seed 0) in JAX's tree and
shapes (``jax.eval_shape`` of its ``init_params``): norm scales and
``d_skip`` 1, ``log_a`` JAX's S4D init, ``dt_bias`` N(0, 0.5) so the
softplus bias is exercised, every other weight N(0, std).

Tolerances (f32):
  * the mixers' outputs and states: atol 1e-5 + rtol 1e-4 of the
    reference (measured: within 1e-7 of each other's scale; JAX's own
    chunked-vs-step tests hold 2e-4 to 3e-4); the SSM's within-chunk
    scan groups its products as a Hillis-Steele scan where JAX's
    ``associative_scan`` takes another tree, which costs rounding only;
  * logits and caches: atol = rtol = 1e-5;
  * greedy token streams (bf16, JAX's serving dtype): equal, on prompts
    screened for a top-1 / top-2 logit gap above four bf16 ulps of the
    row's largest |logit| at every step (along the port's stream, which
    lies within one ulp of JAX's);
  * fused horizons against per-step serving, and a frozen lane's state:
    bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as jdecode
from repro.models import ssm as jssm
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro.serving import scheduler as jscheduler
from repro.serving import server as jserver
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import decode, ssm, testing, transformer, xlstm
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
from repro_torch.tree import leaves, leaves_with_path
import torch_one_thread  # noqa: F401 (one torch thread)

XLSTM, HYMBA = "xlstm-1.3b", "hymba-1.5b"
ARCHS = [XLSTM, HYMBA]
S, N_DECODE = 10, 8                # the prompt runs past hymba's window 8
CONTEXT = S + N_DECODE
MAX_NEW = 6
MIX_TOL = dict(atol=1e-5, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)


def _draw(shapes, rng, std):
    """numpy leaves in the tree of ``shapes`` (see the module docstring)."""
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


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

# (JAX module, port module, init, apply, step, state init, arch)
MIXERS = {
    "mlstm": (jxlstm, xlstm, "init_mlstm", "mlstm_apply", "mlstm_step",
              XLSTM),
    "slstm": (jxlstm, xlstm, "init_slstm", "slstm_apply", "slstm_step",
              XLSTM),
    "ssm": (jssm, ssm, "init_ssm", "ssm_apply", "ssm_step", HYMBA),
}


@functools.cache
def _mixer(name):
    """(JAX config, port config, JAX params, port params, JAX apply and
    step jitted) of one mixer at its arch's reduced size; weights N(0,
    0.2) so the gates move well away from their init."""
    jmod, _, init, apply, step, arch = MIXERS[name]
    jcfg, cfg = jtesting.reduced_config(arch), testing.reduced_config(arch)
    shapes = jax.eval_shape(lambda: getattr(jmod, init)(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    np_p = _draw(shapes, np.random.default_rng(0), 0.2)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    japply = jax.jit(lambda p, x: getattr(jmod, apply)(p, jcfg, x,
                                                       return_state=True))
    jstep = jax.jit(lambda p, x, st: getattr(jmod, step)(p, jcfg, x, st))
    return jcfg, cfg, jp, params_from_jax(np_p, "cpu"), japply, jstep


def _inputs(cfg, n, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (2, n, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("extra", [5, 7])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_apply_and_step_match_jax(name, extra):
    """The full-sequence form and its carried-out state at a length whose
    last chunk is padded, then three decode steps from that state, each
    output and state against JAX's."""
    _, mod, _, apply, step, _ = MIXERS[name]
    jcfg, cfg, jp, p, japply, jstep = _mixer(name)
    n = mod.CHUNK + extra
    x = _inputs(cfg, n + 3)
    jy, jst = japply(jp, jnp.asarray(x[:, :n]))
    y, st = getattr(mod, apply)(p, cfg, torch.from_numpy(x[:, :n]),
                                return_state=True)
    assert type(st).__name__ == type(jst).__name__
    _close(y, jy, MIX_TOL)
    for a, b in zip(st, jst):
        _close(a, b, MIX_TOL)
    for t in range(n, n + 3):
        jy, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = getattr(mod, step)(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                   st)
        _close(y, jy, MIX_TOL)
        for a, b in zip(st, jst):
            _close(a, b, MIX_TOL)


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_chunked_equals_steps(name):
    """``tests/test_mixers.py`` on the port: the full-sequence form (its
    padded chunks included) against token-by-token steps from the zero
    state, outputs and final state, atol 2e-4 / 3e-4 as there."""
    _, mod, _, apply, step, _ = MIXERS[name]
    _, cfg, _, p, _, _ = _mixer(name)
    n = mod.CHUNK + 7 if name != "slstm" else 19
    x = torch.from_numpy(_inputs(cfg, n, seed=2))
    y_full, st_full = getattr(mod, apply)(p, cfg, x, return_state=True)
    if name == "ssm":
        st = ssm.init_ssm_state(cfg, 2, cfg.n_heads * cfg.head_dim,
                                torch.float32, "cpu")
    elif name == "mlstm":
        st = xlstm.init_mlstm_state(cfg, 2, "cpu")
    else:
        st = xlstm.init_slstm_state(cfg, 2, "cpu")
    ys = []
    for t in range(n):
        y, st = getattr(mod, step)(p, cfg, x[:, t:t + 1], st)
        ys.append(y)
    atol = 3e-4 if name == "mlstm" else 2e-4
    _close(y_full, torch.cat(ys, dim=1), dict(atol=atol, rtol=0))
    for a, b in zip(st_full, st):
        _close(a, b, dict(atol=atol, rtol=0))


def test_ssm_chunk_boundary_invariance():
    """The chunked SSM does not see where its chunks fall: a prefix of the
    sequence gives the prefix of the output (``tests/test_mixers.py``)."""
    _, cfg, _, p, _, _ = _mixer("ssm")
    x = torch.from_numpy(_inputs(cfg, 2 * ssm.CHUNK, seed=3)[:1])
    y = ssm.ssm_apply(p, cfg, x)
    y_prefix = ssm.ssm_apply(p, cfg, x[:, :ssm.CHUNK + 3])
    _close(y[:, :ssm.CHUNK + 3], y_prefix, dict(atol=2e-4, rtol=0))


def test_chunk_scan_equals_the_serial_recurrence():
    """The Hillis-Steele scan against h_t = a_t h_{t-1} + b_t step by step,
    with decays down to 1e-30 whose running product underflows f32: no
    cumulative product is formed alone, so nothing turns into 0 / 0."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(np.exp(rng.uniform(-69.0, 0.0, (2, 128, 3, 2)))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 128, 3, 2))
                         .astype(np.float32))
    a_cum, b_cum = ssm._chunk_scan(a, b)
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 2)).astype(np.float32))
    h, want = h0, []
    for t in range(128):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = a_cum * h0[:, None] + b_cum
    assert torch.isfinite(got).all()
    _close(got, torch.stack(want, dim=1), dict(atol=1e-6, rtol=1e-5))


# ---------------------------------------------------------------------------
# the model: init, forward, prefill, decode
# ---------------------------------------------------------------------------

@functools.cache
def _model(arch):
    """Reduced ``arch``, weights N(0, 0.02) drawn by numpy in JAX's tree:
    (JAX config, port config, JAX params, the port's copy)."""
    jcfg, cfg = jtesting.reduced_config(arch), testing.reduced_config(arch)
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    np_p = _draw(shapes, np.random.default_rng(0), 0.02)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_p),
            params_from_jax(np_p, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_jax_tree_and_shapes(arch):
    """The port's own init builds JAX's tree, leaf shapes and dtypes, the
    plan JAX's ``layer_plan`` gives, and ``ported_plan`` accepts it."""
    jcfg, cfg, _, params = _model(arch)
    assert transformer.ported_plan(cfg) == jtransformer.layer_plan(jcfg)
    own = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  torch.float32)
    assert ([p for p, _ in leaves_with_path(own)]
            == [p for p, _ in leaves_with_path(params)])
    for a, b in zip(leaves(own), leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


@functools.cache
def _jax_fns(arch):
    jcfg = _model(arch)[0]
    fwd = jax.jit(lambda p, t: jtransformer.forward(
        jcfg, p, t, compute_dtype=jnp.float32)[0])
    pre = jax.jit(lambda p, t: jdecode.prefill(
        jcfg, p, t, CONTEXT, compute_dtype=jnp.float32))
    dec = jax.jit(lambda p, t, pos, c: jdecode.decode_step(
        jcfg, p, t, pos, c, compute_dtype=jnp.float32))
    return fwd, pre, dec


@functools.cache
def _tokens(arch):
    return np.random.default_rng(2).integers(
        0, _model(arch)[1].vocab, size=(2, CONTEXT)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """f32: the full forward's logits at every position against JAX's."""
    _, cfg, jparams, params = _model(arch)
    fwd = _jax_fns(arch)[0]
    tokens = _tokens(arch)
    logits, aux = transformer.forward(cfg, params, torch.from_numpy(tokens),
                                      compute_dtype=torch.float32)
    _close(logits, fwd(jparams, jnp.asarray(tokens)), TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """f32: the prefill's last logits and its cache leaf by leaf (K/V
    rings, the SWA ring wrapped, SSM h and conv tail, mLSTM/sLSTM c, n,
    m), then eight decode steps, logits and cache, against JAX's; and the
    port's own steps against its full forward at every position."""
    _, cfg, jparams, params = _model(arch)
    _, pre, dec = _jax_fns(arch)
    tokens = _tokens(arch)
    full, _ = transformer.forward(cfg, params, torch.from_numpy(tokens),
                                  compute_dtype=torch.float32)
    jlogits, jcache = pre(jparams, jnp.asarray(tokens[:, :S]))
    logits, cache = decode.prefill(cfg, params,
                                   torch.from_numpy(tokens[:, :S]), CONTEXT,
                                   compute_dtype=torch.float32)
    _close(logits, jlogits, TOL)
    _close(logits, full[:, S - 1], TOL)

    def same_cache():
        want = leaves_with_path(cache_from_jax(jax.device_get(jcache),
                                               "cpu"))
        got = leaves_with_path(cache)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            _close(a, b, TOL)

    same_cache()
    if arch == HYMBA:
        assert decode._kv_capacity("hymba_swa", cfg, CONTEXT) == 8
        assert cache[1]["kv"].capacity == 8 < S
    for pos in range(S, S + N_DECODE):
        jlogits, jcache = dec(jparams, jnp.asarray(tokens[:, pos]),
                              jnp.int32(pos), jcache)
        logits, cache = decode.decode_step(
            cfg, params, torch.from_numpy(tokens[:, pos]).long(), pos, cache,
            compute_dtype=torch.float32)
        _close(logits, jlogits, TOL)
        _close(logits, full[:, pos], TOL)
    same_cache()


def test_cache_from_jax_maps_states_onto_the_port():
    """``cache_from_jax`` (and ``params_from_jax`` on a NamedTuple) gives
    the port's classes, never the JAX package's; an int8 cache crosses
    with its codes and f16 scales, and equals the port's own int8
    ``init_cache`` (the conv tail in the compute dtype, as JAX's
    prefill keeps it)."""
    jcfg = _model(HYMBA)[0]
    jc = jax.device_get(jdecode.init_cache(jcfg, 2, CONTEXT))
    cache = cache_from_jax(jc, "cpu")
    assert type(cache[0]["kv"]) is decode.KVCache
    assert type(cache[0]["ssm"]) is ssm.SSMState
    xc = cache_from_jax(jax.device_get(jdecode.init_cache(
        _model(XLSTM)[0], 2, CONTEXT)), "cpu")
    assert {type(e["state"]) for e in xc} == {xlstm.MLSTMState,
                                              xlstm.SLSTMState}
    own = decode.init_cache(testing.reduced_config(HYMBA), 2, CONTEXT,
                            device="cpu")
    for a, b in zip(leaves(own), leaves(cache)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    q8 = cache_from_jax(jax.device_get(jdecode.init_cache(
        jcfg, 2, CONTEXT, dtype=jnp.int8)), "cpu")
    own8 = decode.init_cache(testing.reduced_config(HYMBA), 2, CONTEXT,
                             torch.int8, device="cpu")
    for e, o in zip(q8, own8):
        assert e["kv"].quantized and o["kv"].quantized
        for a, b in zip(e["kv"], o["kv"]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert e["kv"].k_scale.dtype == torch.float16
        assert o["ssm"].conv_buf.dtype == torch.bfloat16


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
def _screened(arch):
    """The first eight of 64 seeded candidate prompts whose greedy bf16
    stream is clear of ties at every step, (8, S).  The stream screened
    is the port's, all candidates decoded as one batch: a gap of four bf16
    ulps covers the rounding between the two packages (at most one ulp)
    and between a row decoded in that batch, in a batch of four or
    alone."""
    _, cfg, _, params = _model(arch)
    cand = np.random.default_rng(7).integers(
        0, cfg.vocab, size=(64, S)).astype(np.int32)
    lg, cache = decode.prefill(cfg, params, torch.from_numpy(cand).long(),
                               S + MAX_NEW)
    ok = np.ones(len(cand), bool)
    for i in range(MAX_NEW):
        ok &= _gap_ok(lg)
        if i < MAX_NEW - 1:
            lg, cache = decode.decode_step(cfg, params, lg.argmax(-1), S + i,
                                           cache)
    found = cand[ok][:8]
    assert len(found) == 8
    return found


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_oneshot_stream_matches_jax(arch):
    """Four screened prompts in one batch: ``generate``'s greedy tokens
    equal JAX's ``generate``'s (bf16 compute)."""
    jcfg, cfg, jparams, params = _model(arch)
    prompts = _screened(arch)[:4]
    want = np.asarray(jengine.generate(
        jcfg, jparams, jnp.asarray(prompts), MAX_NEW, jax.random.PRNGKey(0),
        sampler=jsampler.SamplerConfig(greedy=True)))
    got = generate(cfg, params, torch.from_numpy(prompts).long(), MAX_NEW,
                   None, sampler=SamplerConfig(greedy=True))
    np.testing.assert_array_equal(got.numpy(), want)


def _requests(prompts, make, sampler):
    n_new = [5, 3, 1, 6, 4]
    return [make(f"r{i}", p.tolist(), n_new[i], seed=10 + i, sampler=sampler,
                 arrival=i // 2) for i, p in enumerate(prompts)]


@functools.cache
def _jax_continuous(arch):
    jcfg, _, jparams, _ = _model(arch)
    srv = jserver.RunaheadServer(jcfg, jparams, n_slots=2,
                                 context=S + MAX_NEW)
    reqs = _requests(_screened(arch)[:5], jserver.Request,
                     jsampler.SamplerConfig(greedy=True))
    return {c.rid: c.tokens for c in srv.run(reqs)}


@pytest.mark.parametrize("step_horizon", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_streams_match_jax_per_step(arch, step_horizon):
    """Five screened greedy requests over two slots of the dense ring
    (staggered arrivals, queueing, a request done at admission, lanes
    frozen while idle): the port's streams, per step and in fused
    horizons of 4, equal JAX's per-step ``ContinuousScheduler``'s."""
    _, cfg, _, params = _model(arch)
    want = _jax_continuous(arch)
    reqs = _requests(_screened(arch)[:5], Request,
                     SamplerConfig(greedy=True))
    srv = RunaheadServer(cfg, params, n_slots=2, context=S + MAX_NEW,
                         step_horizon=step_horizon)
    got = {c.rid: c.tokens for c in srv.run(reqs)}
    assert got == want
    assert all(len(got[r.rid]) == r.n_new for r in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_fused_horizon_equals_per_step(arch):
    """Sampled requests (top-k, top-p, entropy; each its own seed) over
    two slots: fused horizons of 4 stream what per-step serving streams,
    bit for bit."""
    _, cfg, _, params = _model(arch)
    sc = SamplerConfig(top_k=40, top_p=0.9, target_entropy=3.0)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, size=(5, S))
    out = []
    for k in (1, 4):
        srv = RunaheadServer(cfg, params, n_slots=2, context=S + MAX_NEW,
                             step_horizon=k)
        out.append({c.rid: c.tokens for c in srv.run(
            _requests(prompts, Request, sc))})
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_lane_state_is_frozen(arch):
    """One request in two slots: a step leaves the idle lane's whole cache
    entry (mLSTM/sLSTM c, n, m; SSM h and conv tail; K/V ring) bit for bit
    as it was, while the live lane's recurrent state moves."""
    _, cfg, _, params = _model(arch)
    sch = ContinuousScheduler(cfg, params, n_slots=2, context=S + MAX_NEW)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, S))
    # fill lane 1 with a real state, then free it: its state is stale and
    # must stay so while lane 0 serves
    assert sch.admit("a", prompts[1].tolist(), 1, seed=0)
    assert sch.admit("b", prompts[0].tolist(), MAX_NEW, seed=0)
    assert sch.slots[1] is None and sch.slots[0] is not None
    before = [t.clone() for t in leaves(sch.cache)]
    sch.step()
    moved = False
    for (path, t), b in zip(leaves_with_path(sch.cache), before):
        assert torch.equal(t[:, 1], b[:, 1]), path
        if "state" in path or "ssm/h" in path:
            moved |= not torch.equal(t[:, 0], b[:, 0])
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_speculative_raise_as_jax(arch):
    """The paged cache and speculative verify stay refused for the
    recurrent families, with JAX's refusal (a ValueError naming the dense
    stack)."""
    jcfg, cfg, jparams, params = _model(arch)
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


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--reduced", "--device", "cpu", "--prompt-len", str(S),
          "--new-tokens", "4", "--top-k", "40", "--top-p", "0.9",
          "--target-entropy", "3.0"]


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(arch, continuous):
    """``launch.serve`` end to end, one-shot and continuous (fused
    horizons of 2 on the dense ring): every token in range."""
    from repro_torch.launch import serve

    cfg = testing.reduced_config(arch)
    extra = (["--continuous", "--requests", "3", "--slots", "2",
              "--step-horizon", "2"] if continuous else ["--batch", "2"])
    out = serve.main(["--arch", arch] + LAUNCH + extra)
    if continuous:
        toks = [t for c in out.completions for t in c.tokens]
        assert len(out.completions) == 3
    else:
        toks = out.tokens.flatten().tolist()
        assert tuple(out.tokens.shape) == (2, 4)
    assert toks and all(0 <= t < cfg.vocab for t in toks)


@pytest.mark.parametrize("flags", [["--page-size", "4"],
                                   ["--draft-len", "3"]])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_paged_and_speculative(arch, flags):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--continuous"] + LAUNCH + flags
    with pytest.raises((ValueError, SystemExit)):
        serve.main(argv)
