"""The port's MoE family against the JAX package's, on the same inputs.

The MoE layer (``repro_torch.models.moe``) mirrors ``tests/test_moe.py``
case by case as parity tests, then the slice as a whole: reduced
qwen2-moe-a2.7b and granite-moe-3b-a800m (8 experts padded to 16) through
``forward``, ``prefill`` and ``decode_step`` in both capacity modes, a
greedy one-shot stream, continuous dense-ring streams against JAX's
per-step scheduler, two training steps against ``jax.grad`` of JAX's
``loss_fn``, and the paged and speculative paths refused as JAX refuses
them.  Weights come from the JAX ``init_params`` / ``init_moe``, carried
across by ``repro_torch.convert``; activations from numpy seeds.  The
port's capacity solve takes its default ``"hopper"`` backend (K3's plain
version here), JAX's its ``"jnp"`` default.

Tolerances:
  * keep masks, dispatch slots, dropped fractions and the bisect
    thresholds' keeps: bit for bit (counts are exact on both backends);
  * the layer's output (f32): atol 1e-5; the load-balance loss: 1e-6;
  * logits and caches in f32: atol=rtol=1e-5;
  * greedy token streams (bf16, JAX's serving dtype): equal, on prompts
    screened along JAX's own stream for a top-1 / top-2 logit gap above
    four bf16 ulps of the row's largest |logit|;
  * the training step (param_dtype f32) with an f32 forward: loss rtol
    1e-5, the aux loss within 1e-6, every gradient leaf at l2 rtol 1e-5
    (why not bf16: ``test_train_steps_match_jax_grad``); the launcher's
    bf16 run on the CPU, end to end: finite losses that fall.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as jdecode
from repro.models import moe as jmoe
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro.serving import scheduler as jscheduler
from repro.serving import server as jserver
from repro.train import step as jstep
from repro_torch.convert import params_from_jax
from repro_torch.models import decode, moe, testing, transformer
from repro_torch.optim.adamw import adamw_init
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
from repro_torch.train import step
from repro_torch.tree import leaves, unflatten
import torch_one_thread  # noqa: F401 (one torch thread)

QWEN, GRANITE = "qwen2-moe-a2.7b", "granite-moe-3b-a800m"
S, CONTEXT, N_DECODE = 6, 13, 2
MAX_NEW = 7


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jtesting.reduced_config(arch), **overrides),
            dataclasses.replace(testing.reduced_config(arch), **overrides))


# ---------------------------------------------------------------------------
# the MoE layer (tests/test_moe.py, case by case)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 16, 40, 60, 64, 65])
def test_padded_experts(n):
    assert moe.padded_experts(n) == jmoe.padded_experts(n)


@pytest.mark.parametrize("args", [(1024, 8, 2, 1.25), (4, 64, 1, 1.0),
                                  (6, 8, 2, 1.25), (256, 60, 4, 1.25),
                                  (8192, 40, 8, 1.25)])
def test_capacity_formula(args):
    assert moe._capacity(*args) == jmoe._capacity(*args)


@pytest.mark.parametrize("A,e_pad,cap,n_real", [
    (24, 16, 4, 8),        # the reduced layer's shape, under pressure
    (8, 16, 4, 8),         # decode: every expert under capacity
    (2048, 64, 43, 60),    # a qwen2-moe prompt of 512 tokens
    (512, 48, 20, 40),     # granite's top-8, a heavy expert
])
def test_bisect_keep_matches_jax(A, e_pad, cap, n_real):
    """The per-expert threshold solve on equal scores: keep masks bit for
    bit, the port's "hopper" (K3's plain version) and "torch" backends
    alike; at most cap keepers per expert."""
    rng = np.random.default_rng(A + cap)
    scores = rng.uniform(0.05, 1.0, A).astype(np.float32)
    skew = rng.dirichlet(np.full(n_real, 0.3))        # a few heavy experts
    expert = rng.choice(n_real, size=A, p=skew).astype(np.int32)
    want = np.asarray(jmoe._bisect_keep(jnp.asarray(scores),
                                        jnp.asarray(expert), e_pad, cap))
    for backend in ("hopper", "torch"):
        got = moe._bisect_keep(torch.from_numpy(scores),
                               torch.from_numpy(expert).long(), e_pad, cap,
                               backend)
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.bincount(expert[want], minlength=e_pad).max() <= cap
    for e in np.unique(expert[~want]):         # a priority drop
        mine = expert == e
        assert scores[mine & want].min(initial=2.0) > scores[
            mine & ~want].max()


def _layer(arch, cf=1.25, router_to_padding=False, shared=True, x_shape=None):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    if not shared:
        jcfg, cfg = (dataclasses.replace(c, n_shared_experts=0)
                     for c in (jcfg, cfg))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    if router_to_padding:                 # try to attract padded experts
        router = np.array(jp["router"])
        router[:, jcfg.n_experts:] = 100.0
        jp = dict(jp, router=jnp.asarray(router))
    x = np.random.default_rng(1).standard_normal(
        x_shape or (2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, params_from_jax(jax.device_get(jp), "cpu"), x


_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=1,
                      static_argnames=("capacity_mode", "n_groups"))
_jdispatch = jax.jit(jmoe._dispatch_group, static_argnums=(1, 3, 4))


def _moe_both(jcfg, cfg, jp, p, x, **kw):
    jout, jst = _jmoe_apply(jp, jcfg, jnp.asarray(x), **kw)
    out, st = moe.moe_apply(p, cfg, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(st.aux_loss), float(jst.aux_loss),
                               atol=1e-6, rtol=0)
    assert float(st.dropped_frac) == float(jst.dropped_frac)
    return out, st


def _dispatch_both(jcfg, cfg, jp, p, x, mode, n_groups=1):
    """Each group's dispatch: keep masks and slots bit for bit (the port
    lays the groups' slots out one after another), gates and the expert
    inputs within 1e-6."""
    T = x.shape[0] * x.shape[1]
    if T % n_groups:
        n_groups = 1
    tg = T // n_groups
    cap = moe._capacity(tg, cfg.n_experts, cfg.moe_top_k,
                        cfg.capacity_factor)
    d = moe._dispatch(p, cfg, torch.from_numpy(x), mode, n_groups, "hopper",
                      moe.NO_SPLIT)
    e_cap = moe.padded_experts(cfg.n_experts) * cap
    assert d.expert_in.shape[:3] == (n_groups, e_cap // cap, cap)
    a_g = tg * cfg.moe_top_k
    keeps = []
    for g, xt in enumerate(x.reshape(n_groups, tg, -1)):
        jin, jslot, jkeep, jgate, _, _, _ = _jdispatch(
            jp, jcfg, jnp.asarray(xt), cap, mode)
        part = slice(g * a_g, (g + 1) * a_g)
        keep, slot = d.keep[part].numpy(), d.slot[part].numpy()
        np.testing.assert_array_equal(keep, np.asarray(jkeep))
        np.testing.assert_array_equal(
            slot, np.where(keep, np.asarray(jslot) + g * e_cap,
                           n_groups * e_cap))
        np.testing.assert_allclose(d.a_gate[part].numpy(), np.asarray(jgate),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(d.expert_in[g].numpy(), np.asarray(jin),
                                   atol=1e-6, rtol=0)
        keeps.append((keep, slot - g * e_cap, cap))
    return keeps


@pytest.mark.parametrize("mode", ["fifo", "bisect"])
def test_output_shape_finite(mode):
    jcfg, cfg, jp, p, x = _layer(QWEN)
    out, st = _moe_both(jcfg, cfg, jp, p, x, capacity_mode=mode)
    _dispatch_both(jcfg, cfg, jp, p, x, mode)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(st.dropped_frac) >= 0.0


@pytest.mark.parametrize("mode", ["fifo", "bisect"])
def test_padding_experts_never_routed(mode):
    """Router weights pulled toward the padded columns: they stay at -inf,
    so every kept slot belongs to a real expert, as in JAX."""
    jcfg, cfg, jp, p, x = _layer(QWEN, router_to_padding=True)
    out, _ = _moe_both(jcfg, cfg, jp, p, x, capacity_mode=mode)
    assert bool(torch.isfinite(out).all())
    for keep, slot, cap in _dispatch_both(jcfg, cfg, jp, p, x, mode):
        assert (slot[keep] < cfg.n_experts * cap).all()


def test_dropless_fifo_equals_bisect():
    """Capacity above every expert's demand: neither mode drops, and both
    modes' outputs agree, in the port as in JAX."""
    jcfg, cfg, jp, p, x = _layer(QWEN, cf=100.0)
    out_f, st_f = _moe_both(jcfg, cfg, jp, p, x, capacity_mode="fifo")
    out_b, st_b = _moe_both(jcfg, cfg, jp, p, x, capacity_mode="bisect")
    assert float(st_f.dropped_frac) == 0.0
    assert float(st_b.dropped_frac) <= 1e-6
    np.testing.assert_allclose(out_f.numpy(), out_b.numpy(), atol=2e-5)


def test_bisect_drops_lowest_gates():
    """Under pressure both modes drop, and bisect keeps each expert's
    highest gates: keep masks and slots equal JAX's bit for bit."""
    jcfg, cfg, jp, p, x = _layer(QWEN, cf=0.4)
    st = {}
    for mode in ("fifo", "bisect"):
        _, st[mode] = _moe_both(jcfg, cfg, jp, p, x, capacity_mode=mode)
        _dispatch_both(jcfg, cfg, jp, p, x, mode)
    assert float(st["fifo"].dropped_frac) > 0.0
    assert float(st["bisect"].dropped_frac) > 0.0
    assert abs(float(st["fifo"].dropped_frac)
               - float(st["bisect"].dropped_frac)) < 0.3


@pytest.mark.parametrize("mode", ["fifo", "bisect"])
def test_groups_shard_semantics(mode):
    """n_groups=2 equals JAX's and running each half as its own group."""
    jcfg, cfg, jp, p, x = _layer(QWEN, cf=1.0)
    out_g, _ = _moe_both(jcfg, cfg, jp, p, x, capacity_mode=mode,
                         n_groups=2)
    _dispatch_both(jcfg, cfg, jp, p, x, mode, n_groups=2)
    B, S_, D = x.shape
    halves = torch.from_numpy(x).reshape(2, B * S_ // 2, D)
    manual = torch.cat([moe.moe_apply(p, cfg, h[None], capacity_mode=mode)[0]
                        for h in halves], dim=1).reshape(B, S_, D)
    np.testing.assert_allclose(out_g.numpy(), manual.numpy(), atol=2e-5)


def test_shared_experts_contribute():
    jcfg, cfg, jp, p, x = _layer(QWEN)
    out_with, _ = _moe_both(jcfg, cfg, jp, p, x)
    jcfg0, cfg0, jp0, p0, _ = _layer(QWEN, shared=False)
    assert "shared" not in p0
    out_without, _ = _moe_both(jcfg0, cfg0, jp0, p0, x)
    assert float((out_with - out_without).abs().max()) > 1e-3


@pytest.mark.parametrize("mode", ["fifo", "bisect"])
def test_granite_no_shared(mode):
    jcfg, cfg, jp, p, x = _layer(GRANITE, x_shape=(1, 16, 64))
    assert cfg.n_shared_experts == 0 and "shared" not in p
    out, _ = _moe_both(jcfg, cfg, jp, p, x, capacity_mode=mode)
    _dispatch_both(jcfg, cfg, jp, p, x, mode)
    assert out.shape == x.shape


# ---------------------------------------------------------------------------
# the model: init, forward, prefill, decode
# ---------------------------------------------------------------------------

@functools.cache
def _model(arch):
    """Reduced arch with weights drawn by numpy (seed 0) in JAX's tree,
    shapes and scale (``jax.eval_shape`` of its ``init_params``): norm
    scales 1, weights N(0, 0.02), and the QKV biases (zero at init) N(0,
    0.1), so the bias path is exercised.  Returns (JAX config, port
    config, JAX params, the port's copy via ``params_from_jax``)."""
    jcfg, cfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        std = 0.1 if name in ("['bq']", "['bk']", "['bv']") else 0.02
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(draw, shapes)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, cfg, jparams, params_from_jax(np_params, "cpu")


@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_params_cross_bit_for_bit_and_init_shapes_match(arch):
    """The MoE tree (router, stacked (e_pad, d, f) experts, shared) crosses
    bit for bit in bf16, and the port's own init has JAX's tree, shapes
    and dtypes (those of ``_model``'s draw, JAX's ``eval_shape``)."""
    jcfg, cfg, jparams, params = _model(arch)
    jbf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jnp.bfloat16), jax.device_get(jparams))
    crossed = params_from_jax(jbf16, "cpu")
    run = crossed["runs"][0]["moe"]
    e_pad = moe.padded_experts(cfg.n_experts)
    assert tuple(run["w_gate"].shape) == (cfg.n_layers, e_pad, cfg.d_model,
                                          cfg.d_ff)
    assert tuple(run["w_down"].shape) == (cfg.n_layers, e_pad, cfg.d_ff,
                                          cfg.d_model)
    assert ("shared" in run) == (cfg.n_shared_experts > 0)
    jleaves = jax.tree_util.tree_leaves(jbf16)
    tleaves = jax.tree_util.tree_leaves(crossed)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))
    own = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  torch.float32)
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


@functools.cache
def _jax_fns(arch):
    jcfg = _model(arch)[0]
    fwd = jax.jit(lambda p, t, mode: jtransformer.forward(
        jcfg, p, t, capacity_mode=mode, compute_dtype=jnp.float32),
        static_argnums=2)
    pre = jax.jit(lambda p, t, mode: jdecode.prefill(
        jcfg, p, t, CONTEXT, compute_dtype=jnp.float32, capacity_mode=mode),
        static_argnums=2)
    dec = jax.jit(lambda p, t, pos, c, mode: jdecode.decode_step(
        jcfg, p, t, pos, c, compute_dtype=jnp.float32, capacity_mode=mode),
        static_argnums=4)
    return fwd, pre, dec


@pytest.mark.parametrize("mode", ["fifo", "bisect"])
@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_forward_prefill_decode_match_jax(arch, mode):
    """f32: the full forward's logits and aux, the prefill's last logits
    and K/V cache, then two decode steps, each against JAX."""
    jcfg, cfg, jparams, params = _model(arch)
    fwd, pre, dec = _jax_fns(arch)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, S + N_DECODE)).astype(np.int32)
    tol = dict(atol=1e-5, rtol=1e-5)
    jlogits, jaux = fwd(jparams, jnp.asarray(tokens), mode)
    logits, aux = transformer.forward(cfg, params, torch.from_numpy(tokens),
                                      capacity_mode=mode,
                                      compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    assert float(aux) > 0.0
    jlogits, jcache = pre(jparams, jnp.asarray(tokens[:, :S]), mode)
    logits, cache = decode.prefill(cfg, params, torch.from_numpy(tokens[:, :S]),
                                   CONTEXT, compute_dtype=torch.float32,
                                   capacity_mode=mode)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(cache[0]["kv"], name).float().numpy(),
            np.asarray(getattr(jcache[0]["kv"], name), np.float32), **tol)
    for pos in range(S, S + N_DECODE):
        jlogits, jcache = dec(jparams, jnp.asarray(tokens[:, pos]),
                              jnp.int32(pos), jcache, mode)
        logits, cache = decode.decode_step(
            cfg, params, torch.from_numpy(tokens[:, pos]).long(), pos, cache,
            compute_dtype=torch.float32, capacity_mode=mode)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)


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
def _jax_greedy_fns(arch):
    """JAX's bf16 prefill and decode step, jitted, each batch row of the
    vmapped axis served alone (a batch of one)."""
    jcfg, _, jparams, _ = _model(arch)

    def pre(t):
        return jdecode.prefill(jcfg, jparams, t, S + MAX_NEW)

    def dec(t, pos, c):
        return jdecode.decode_step(jcfg, jparams, t, pos, c)

    return (jax.jit(pre), jax.jit(dec), jax.jit(jax.vmap(pre)),
            jax.jit(jax.vmap(dec, in_axes=(0, None, 0))))


def _greedy_gaps_ok(prompts, pre, dec) -> np.ndarray:
    """Per leading index of ``prompts``, whether JAX's greedy stream keeps
    its gap at every step and row."""
    lg, cache = pre(jnp.asarray(prompts))
    ok = np.ones(prompts.shape[0], bool)
    for i in range(MAX_NEW):
        gaps = _gap_ok(np.asarray(lg).reshape(-1, lg.shape[-1]))
        ok &= gaps.reshape(prompts.shape[0], -1).all(axis=1)
        if i < MAX_NEW - 1:
            lg, cache = dec(jnp.argmax(lg, -1).astype(jnp.int32),
                            jnp.int32(S + i), cache)
    return ok


def _jax_greedy_ok(arch, prompts) -> bool:
    """JAX's bf16 one-shot greedy stream of ``prompts`` (one batch: MoE
    capacity couples its rows) keeps every row's gap at every step."""
    pre, dec, _, _ = _jax_greedy_fns(arch)
    return bool(_greedy_gaps_ok(prompts[None], lambda t: pre(t[0]), dec)[0])


@functools.cache
def _screened(arch):
    """The first eight of 128 seeded candidate prompts whose JAX greedy
    stream, each prompt alone (as continuous admission prefills it), is
    clear of ties."""
    cand = np.random.default_rng(7).integers(
        0, _model(arch)[1].vocab, size=(128, 1, S)).astype(np.int32)
    _, _, vpre, vdec = _jax_greedy_fns(arch)
    found = cand[_greedy_gaps_ok(cand, vpre, vdec)][:8]
    assert len(found) == 8
    return found[:, 0]


def test_greedy_oneshot_stream_matches_jax(arch=QWEN):
    """Four screened prompts in one batch, the first four-prompt choice
    whose batched JAX stream is clear of ties too: ``generate``'s greedy
    tokens equal JAX's ``generate``'s (bf16 compute, the routing of the
    batch's rows coupled through capacity in both)."""
    jcfg, cfg, jparams, params = _model(arch)
    prompts = next(b for b in map(list, itertools.combinations(
        _screened(arch), 4)) if _jax_greedy_ok(arch, np.stack(b)))
    prompts = np.stack(prompts)
    want = np.asarray(jengine.generate(
        jcfg, jparams, jnp.asarray(prompts), MAX_NEW, jax.random.PRNGKey(0),
        sampler=jsampler.SamplerConfig(greedy=True)))
    got = generate(cfg, params, torch.from_numpy(prompts).long(), MAX_NEW,
                   None, sampler=SamplerConfig(greedy=True))
    np.testing.assert_array_equal(got.numpy(), want)


def _requests(prompts, make, sampler):
    n_new = [5, 3, 1, 7, 4]
    return [make(f"r{i}", p.tolist(), n_new[i], seed=10 + i, sampler=sampler,
                 arrival=i // 2) for i, p in enumerate(prompts)]


@functools.cache
def _jax_continuous(arch):
    jcfg, _, jparams, _ = _model(arch)
    srv = jserver.RunaheadServer(jcfg, jparams, n_slots=2, context=CONTEXT)
    reqs = _requests(_screened(arch)[:5], jserver.Request,
                     jsampler.SamplerConfig(greedy=True))
    return {c.rid: c.tokens for c in srv.run(reqs)}


@pytest.mark.parametrize("step_horizon", [1, 4])
@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_continuous_streams_match_jax_per_step(arch, step_horizon):
    """Five screened greedy requests over two slots of the dense ring
    (staggered arrivals, queueing, a request done at admission): the
    port's streams, per step and in fused horizons of 4, equal JAX's
    per-step ``ContinuousScheduler``'s."""
    _, cfg, _, params = _model(arch)
    want = _jax_continuous(arch)
    reqs = _requests(_screened(arch)[:5], Request,
                     SamplerConfig(greedy=True))
    srv = RunaheadServer(cfg, params, n_slots=2, context=CONTEXT,
                         step_horizon=step_horizon)
    got = {c.rid: c.tokens for c in srv.run(reqs)}
    assert got == want
    assert all(len(got[r.rid]) == r.n_new for r in reqs)


def test_paged_and_speculative_moe_raise_as_jax():
    """The paged cache and speculative verify stay dense-only for MoE, with
    JAX's refusal (a ValueError naming the dense stack)."""
    jcfg, cfg, jparams, params = _model(QWEN)
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
    with pytest.raises(ValueError, match="dense"):
        decode.init_paged_pool(cfg, 4, 4, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,groups", [("fifo", 1), ("bisect", 1),
                                         ("bisect", 2)])
def test_train_steps_match_jax_grad(monkeypatch, mode, groups):
    """Two train steps of reduced granite (remat, quantile clip, 1 or 2
    GShard groups): at each, the loss, aux and every gradient leaf of the
    port's ``loss_fn`` against ``jax.grad`` of JAX's on the same params
    (loss rtol 1e-5, aux 1e-6, each leaf at l2 rtol 1e-5; about 6e-7
    measured), then the port's ``train_step`` advances them (its loss
    equal to the one compared).

    Both packages' ``loss_fn`` run with the forward computing in f32 (each
    module's ``forward`` wrapped to that compute dtype).  With the bf16
    forward of the default the two frameworks round intermediates at
    other places, 1 - 3 bf16 ulps of a hidden state after 4 layers, and
    bf16 router logits then tie or cross differently for some tokens:
    the aux loss moves by about 1e-3 of itself and the router's gradient
    by about 17% of its norm, which no tolerance tells from a fault."""
    monkeypatch.setattr(jstep, "forward", functools.partial(
        jtransformer.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(step, "forward", functools.partial(
        transformer.forward, compute_dtype=torch.float32))
    jcfg, cfg, _, params = _model(GRANITE)
    kw = dict(capacity_mode=mode, moe_groups=groups, clip_mode="quantile",
              param_dtype="float32", lr=1e-3, warmup_steps=1, total_steps=10)
    jtc, tc = jstep.TrainConfig(**kw), step.TrainConfig(**kw)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(jcfg, p, b, jtc), has_aux=True))
    fn = step.make_train_step(cfg, tc, lambda s: torch.full((), 1e-3))
    params = jax.tree_util.tree_map(torch.clone, params)
    opt = adamw_init(params)
    rng = np.random.default_rng(11)
    for i in range(2):
        toks = rng.integers(0, cfg.vocab, size=(2, 17)).astype(np.int32)
        jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
                  "targets": jnp.asarray(toks[:, 1:])}
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                 "targets": torch.from_numpy(toks[:, 1:]).long()}
        jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
        (jloss, jm), jg = jgrad(jp, jbatch)
        inputs = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, m = step.loss_fn(cfg, unflatten(params, inputs), batch, tc)
        grads = torch.autograd.grad(loss, inputs)
        loss = loss.detach()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                                   atol=1e-6, rtol=0)
        for g, j in zip(grads, jax.tree_util.tree_leaves(jg)):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(g.numpy() - j) <= 1e-5 * np.linalg.norm(j)
        params, opt, metrics = fn(params, opt, batch)
        assert float(metrics["loss"]) == float(loss)


def test_launcher_trains_moe_with_bisect_on_cpu():
    """``launch.train`` end to end for reduced granite with the bisect cut
    and the quantile clip (bf16, as it runs on the card)."""
    from repro_torch.launch import train as launch_train

    out = launch_train.main([
        "--arch", GRANITE, "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq", "32", "--capacity-mode", "bisect",
        "--clip-mode", "quantile", "--lr", "3e-3", "--log-every", "10"])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["last_loss"] < out["first_loss"]
