"""The port's speculative decoding (``draft_len`` L > 1: draft, verify,
rollback) against the JAX package on the CPU, at the tiny config of
``tests/test_torch_horizon.py`` (reduced internlm2-1.8b cut to 2 layers,
d_model 32, vocab 128), weights from JAX's ``init_params`` through
``params_from_jax``.

Tolerances and why:
  * ``decode_verify`` / ``decode_verify_paged`` against JAX's, f32: logits
    within 1e-5 (the same forward, different matmul libraries); the stash
    equal (a gather of equal inputs);
  * ``rollback_*`` at mixed ``n_keep`` on JAX's written cache and stash:
    bit for bit (pure data movement);
  * verify row l against the port's l-th serial step: argmax equal,
    logits within 1e-4, as JAX's ``test_verify_grid_matches_serial_steps``
    (a B·L-row forward may round apart from a B-row one);
  * greedy acceptance against JAX's ``verify_slots``: equal;
  * rejection sampling: the emitted token's distribution, 20000 seeded
    draws over V = 8, within total-variation distance 0.02 of the target
    (the sampling error at that count is about 0.008);
  * greedy speculative streams against JAX's per-step speculative
    ``RunaheadServer`` and the port's serial streams: equal, on prompts
    screened along JAX's one-shot stream for a top-1/top-2 gap above 10x
    the bf16 tolerance (2**-6 * max|logit|), the unembedding sharpened
    toward a fixed successor token (acceptance decisions read only rows on
    the serial path, so the counters are equal too);
  * fused speculative horizons against per-step speculative serving with
    the same device-capable drafter: bit for bit (the same body, drafts
    and noise);
  * drafters and ``decide_draft_len``: equal (host Python, copies of the
    JAX functions).

Sampled speculative streams draw the port's own noise (torch generators,
not threefry), so they are held to JAX's own contract for them:
deterministic per seed, exact lengths, no cross-slot coupling, and the
target distribution.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.serving import draft as jdraft
from repro.serving import sampler as jsampler
from repro.serving import server as jserver
from repro_torch.convert import params_from_jax
from repro_torch.core import tuning
from repro_torch.launch import serve
from repro_torch.models import attention, decode, testing
from repro_torch.serving import draft
from repro_torch.serving.sampler import (
    SamplerConfig,
    SlotSamplers,
    masked_logits,
    verify_slots,
)
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
import torch_one_thread  # noqa: F401 (one torch thread)

CONTEXT = 32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=128)
S_PROMPT, N_NEW = 4, [5, 3, 6, 4]
F32 = torch.float32


@pytest.fixture(autouse=True)
def _fixed_decisions():
    """JAX's solves run the caller's (rounds, spec_k), the only behaviour
    the port has."""
    with jtuning.disabled():
        yield


def _tiny_jax(perm=None, scale=4.0):
    cfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                              **TINY)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    if perm is not None:
        jparams["unembed"] = (jparams["unembed"]
                              + scale * jparams["embed"][perm].T)
    return cfg, jparams


def _port(jparams):
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    return cfg, params_from_jax(jax.device_get(jparams), "cpu")


@pytest.fixture(scope="module")
def sharp():
    """The unembedding sharpened toward a fixed successor token (as
    ``tests/test_torch_horizon.py``): wide greedy margins."""
    perm = np.random.default_rng(1).permutation(TINY["vocab"])
    jcfg, jparams = _tiny_jax(perm)
    cfg, params = _port(jparams)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def looping():
    """The unembedding sharpened toward the token itself for even tokens
    and a shuffled successor for odd ones: repeat-last drafts are
    accepted after an even token and rejected after an odd one, so fused
    speculative horizons take both acceptance arms."""
    V = TINY["vocab"]
    perm = np.arange(V)
    odd = perm[1::2].copy()
    np.random.default_rng(2).shuffle(odd)
    perm[1::2] = odd
    _, jparams = _tiny_jax(perm)
    return _port(jparams)


def _serve(cfg, params, reqs, **kw):
    kw = dict(dict(n_slots=2, context=CONTEXT, cache_dtype=F32,
                   compute_dtype=F32), **kw)
    srv = RunaheadServer(cfg, params, **kw)
    return ({c.rid: c.tokens for c in srv.run([dataclasses.replace(r)
                                                for r in reqs])},
            srv.scheduler)


# ---------------------------------------------------------------------------
# verify forwards and rollback
# ---------------------------------------------------------------------------

FEED = [[5, 6, 7, 8], [1, 2, 3, 4]]
POS = [6, 9]            # page 4: rows 6..9 and 9..12 each cross a page


def _random_ring(jcache, rng):
    """Every K/V leaf of a JAX cache or pool refilled with seeded normals;
    returns the JAX tree and the leaves as numpy."""
    leaves = []
    out = []
    for e in jcache:
        kv = e["kv"]
        k = rng.standard_normal(kv.k.shape).astype(np.float32)
        v = rng.standard_normal(kv.v.shape).astype(np.float32)
        leaves.append((k, v))
        out.append({"kv": kv._replace(k=jnp.asarray(k), v=jnp.asarray(v))})
    return out, leaves


def _fill(cache, leaves):
    for e, (k, v) in zip(cache, leaves):
        e["kv"].k.copy_(torch.from_numpy(k))
        e["kv"].v.copy_(torch.from_numpy(v))
    return cache


def _to_torch(tree):
    return [{"kv": decode.KVCache(k=torch.from_numpy(np.array(e["kv"].k)),
                                  v=torch.from_numpy(np.array(e["kv"].v)))}
            for e in tree]


def _leaves(tree):
    return [t.numpy() for e in tree for t in (e["kv"].k, e["kv"].v)]


def _jleaves(tree):
    return [np.asarray(t) for e in tree for t in (e["kv"].k, e["kv"].v)]


@pytest.mark.parametrize("paged", [False, True])
def test_verify_and_rollback_match_jax(sharp, paged):
    """One verify over L = 4 at two slots' own depths, f32: logits and
    stash against JAX's, rollback at mixed n_keep on JAX's written state
    bit for bit, and row l against the port's l-th serial step."""
    jcfg, jparams, cfg, params = sharp
    rng = np.random.default_rng(0)
    P = 4
    n = -(-CONTEXT // P)
    table = np.asarray([list(range(1, n + 1)),
                        list(range(n + 1, 2 * n + 1))], np.int32)
    if paged:
        jstate, leaves = _random_ring(
            jdecode.init_paged_pool(jcfg, 2 * n + 1, P, jnp.float32), rng)
        state = _fill(decode.init_paged_pool(cfg, 2 * n + 1, P, F32,
                                             device="cpu"), leaves)
    else:
        jstate, leaves = _random_ring(
            jdecode.init_cache(jcfg, 2, CONTEXT, jnp.float32), rng)
        state = _fill(decode.init_cache(cfg, 2, CONTEXT, F32, device="cpu"),
                      leaves)
    before = [(k.copy(), v.copy()) for k, v in leaves]
    feed, pos = torch.tensor(FEED), torch.tensor(POS)
    jfeed, jpos = jnp.asarray(FEED, jnp.int32), jnp.asarray(POS, jnp.int32)
    ttable = torch.from_numpy(table)
    if paged:
        want, jwide, jstash = jdecode.decode_verify_paged(
            jcfg, jparams, jfeed, jpos, jstate, jnp.asarray(table),
            context=CONTEXT, compute_dtype=jnp.float32)
        got, wide, stash = decode.decode_verify_paged(
            cfg, params, feed, pos, state, ttable, context=CONTEXT,
            compute_dtype=F32)
    else:
        want, jwide, jstash = jdecode.decode_verify(
            jcfg, jparams, jfeed, jpos, jstate, compute_dtype=jnp.float32)
        got, wide, stash = decode.decode_verify(cfg, params, feed, pos,
                                                state, compute_dtype=F32)
    assert wide is state                       # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(_leaves(stash), _jleaves(jstash)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(wide), _jleaves(jwide)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)

    # rollback on JAX's written state: bit for bit, and n_keep 0 restores
    n_keep = np.asarray([0, 2], np.int32)
    if paged:
        jback = jdecode.rollback_paged_runs(
            jwide, jstash, jnp.asarray(table), jpos, jnp.asarray(n_keep),
            context=CONTEXT)
        back = decode.rollback_paged_runs(
            _to_torch(jwide), _to_torch(jstash), ttable, pos,
            torch.from_numpy(n_keep).long(), context=CONTEXT)
    else:
        jback = jdecode.rollback_cache_runs(jwide, jstash, jpos,
                                            jnp.asarray(n_keep))
        back = decode.rollback_cache_runs(_to_torch(jwide),
                                          _to_torch(jstash), pos,
                                          torch.from_numpy(n_keep).long())
    for a, b in zip(_leaves(back), _jleaves(jback)):
        np.testing.assert_array_equal(a, b)
    zero = torch.zeros(2, dtype=torch.long)
    if paged:
        all_back = decode.rollback_paged_runs(wide, stash, ttable, pos, zero,
                                              context=CONTEXT)
    else:
        all_back = decode.rollback_cache_runs(wide, stash, pos, zero)
    for a, (k, v) in zip(all_back, before):
        assert np.array_equal(a["kv"].k.numpy(), k)
        assert np.array_equal(a["kv"].v.numpy(), v)

    # row l against the l-th serial step on the pre-verify state
    state = all_back
    for l in range(len(FEED[0])):
        if paged:
            lg, _ = decode.decode_step_paged(
                cfg, params, feed[:, l], pos + l, state, ttable,
                context=CONTEXT, compute_dtype=F32)
        else:
            lg, _ = decode.decode_step(cfg, params, feed[:, l], pos + l,
                                       state, compute_dtype=F32)
        np.testing.assert_allclose(got[:, l].numpy(), lg.numpy(), atol=1e-4)
        assert torch.equal(got[:, l].argmax(-1), lg.argmax(-1))


def test_paged_stash_off_and_int8_refused(sharp):
    """The serial paged step asks for no stash; a quantized page pool is
    refused, as the JAX paged path refuses it (the dense ring's int8
    verify: tests/test_torch_int8kv.py)."""
    _, _, cfg, params = sharp
    p = params["runs"][0]["attn"]
    p0 = {k: v[0] for k, v in p.items()}
    x = torch.zeros((1, 2, cfg.d_model))
    pool8 = decode.KVCache(k=torch.zeros((3, 4, 2, 16), dtype=torch.int8),
                           v=torch.zeros((3, 4, 2, 16), dtype=torch.int8),
                           k_scale=torch.zeros((3, 4, 2),
                                               dtype=torch.float16),
                           v_scale=torch.zeros((3, 4, 2),
                                               dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="int8"):
        attention.paged_decode_attend_multi(
            p0, cfg, x, torch.tensor([0]), pool8,
            torch.tensor([[1, 2]], dtype=torch.int32), context=8)
    pool = decode.KVCache(k=torch.zeros((3, 4, 2, 16)),
                          v=torch.zeros((3, 4, 2, 16)))
    out = attention.paged_decode_attend_multi(
        p0, cfg, x, torch.tensor([0]), pool,
        torch.tensor([[1, 2]], dtype=torch.int32), context=8, stash=False)
    assert out[2] is None and out[0].shape == (1, 2, cfg.d_model)


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------

def _grid_and_draft(rng, B=3, L=4, V=128):
    grid = rng.standard_normal((B, L, V)).astype(np.float32) * 3
    am = grid.argmax(-1)
    dr = np.stack([am[0, :L - 1],                       # all accepted
                   np.r_[am[1, 0], (am[1, 1:L - 1] + 1) % V],  # one
                   (am[2, :L - 1] + 1) % V]).astype(np.int64)  # none
    return grid, dr


def test_greedy_acceptance_matches_jax():
    """Greedy ``verify_slots`` against JAX's on one grid and draft, with
    the top-k solve enabled (greedy argmax ignores it): greedy-only, and
    greedy rows of a mixed batch."""
    grid, dr = _grid_and_draft(np.random.default_rng(3))
    B = grid.shape[0]
    kw = dict(enable=(False, True, False), top_k_static=12)
    for greedy_only, flags in ((True, [True] * 3),
                               (False, [True, True, False])):
        cfgs = [SamplerConfig(greedy=g, top_k=12) for g in flags]
        jcfgs = [jsampler.SamplerConfig(greedy=g, top_k=12) for g in flags]
        out, n_acc = verify_slots(
            torch.from_numpy(grid), torch.from_numpy(dr),
            [None if g else torch.Generator().manual_seed(0) for g in flags],
            SlotSamplers.stack(cfgs, "cpu"), greedy_only=greedy_only, **kw)
        jout, jn = jsampler.verify_slots(
            jnp.asarray(grid), jnp.asarray(dr, jnp.int32),
            jnp.zeros((B, 2), jnp.uint32), jsampler.SlotSamplers.stack(jcfgs),
            greedy_only=greedy_only, **kw)
        rows = [i for i, g in enumerate(flags) if g]
        np.testing.assert_array_equal(out.numpy()[rows],
                                      np.asarray(jout)[rows])
        np.testing.assert_array_equal(n_acc.numpy()[rows],
                                      np.asarray(jn)[rows])
    assert n_acc.tolist()[:2] == [3, 1]


@pytest.mark.parametrize("top_k", [0, 3])
def test_rejection_sampling_reproduces_the_target(top_k):
    """Fixed logits over V = 8 and a fixed draft token: the first emitted
    token of 20000 seeded verify rows (accepted draft or residual draw)
    is distributed as the masked softmax, within TV 0.02."""
    N, V = 20000, 8
    z = torch.tensor([[1.5, 0.2, -0.4, 2.0, 0.0, -1.0, 0.9, 0.3],
                      [0.1, 1.0, 0.0, -0.5, 0.7, 0.2, -0.2, 0.4]])
    grid = z[None].expand(N, 2, V).contiguous()
    dr = torch.full((N, 1), 3)
    sc = SamplerConfig(top_k=top_k)
    slots = SlotSamplers.stack([sc], "cpu")
    slots = SlotSamplers(*(f.expand(N) for f in slots))
    g = torch.Generator().manual_seed(0)
    coins = torch.rand((N, 1), generator=g)
    uniforms = torch.rand((N, 2, V), generator=g)
    out, n_acc = verify_slots(grid, dr, [None] * N, slots,
                              enable=(False, top_k > 0, False),
                              top_k_static=top_k or None, coins=coins,
                              uniforms=uniforms)
    target = torch.softmax(masked_logits(z[:1], sc), dim=-1)[0]
    freq = torch.bincount(out[:, 0], minlength=V).float() / N
    assert 0.5 * (freq - target).abs().sum().item() < 0.02
    assert 0 < n_acc.float().mean().item() < 1
    # an accepted draft's bonus token is a draw from the last row
    bonus = out[n_acc == 1, 1]
    target1 = torch.softmax(masked_logits(z[1:], sc), dim=-1)[0]
    freq1 = torch.bincount(bonus, minlength=V).float() / bonus.numel()
    assert 0.5 * (freq1 - target1).abs().sum().item() < 0.03


def test_sampled_spec_deterministic_and_complete(looping):
    """JAX's probe: the same seed gives the same stream whatever the
    co-resident request, at exact lengths, dense and paged."""
    cfg, params = looping
    sc = SamplerConfig(top_k=12)
    probe = Request("p", [6, 6, 6, 6], 8, seed=1, sampler=sc)
    outs = []
    for other_seed, page_size in itertools.product((1, 2), (None, 4)):
        other = Request("o", [5, 9, 2, 6], 8, seed=other_seed, sampler=sc)
        got, sched = _serve(cfg, params, [probe, other], draft_len=3,
                            page_size=page_size)
        assert len(got["p"]) == 8 and len(got["o"]) == 8
        outs.append(got["p"])
    assert all(o == outs[0] for o in outs)
    assert sched.n_accepted > 0


# ---------------------------------------------------------------------------
# greedy streams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def screened(sharp):
    """Prompts whose JAX one-shot greedy streams keep a wide top-1/top-2
    gap for n_new + 3 steps (the deepest row a verify of L = 4 reads),
    the workload of 4 staggered requests on them, and JAX's per-step
    speculative streams and counters at L = 2 and 4."""
    jcfg, jparams, _, _ = sharp
    steps = max(N_NEW) + 3
    cand = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(32, S_PROMPT)).astype(np.int32)
    lg, cache = jdecode.prefill(jcfg, jparams, jnp.asarray(cand),
                                S_PROMPT + steps)
    ok = np.ones(len(cand), bool)
    for i in range(steps):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        ok &= top2[:, 1] - top2[:, 0] > 10 * 2.0 ** -6 * np.abs(lg).max(-1)
        if i < steps - 1:
            lg, cache = jdecode.decode_step(
                jcfg, jparams, jnp.asarray(lg.argmax(-1), jnp.int32),
                jnp.int32(S_PROMPT + i), cache)
    rows = np.flatnonzero(ok)[:len(N_NEW)]
    assert len(rows) == len(N_NEW)
    reqs = [Request(f"r{i}", cand[r].tolist(), N_NEW[i], seed=i,
                    sampler=SamplerConfig(greedy=True), arrival=i // 2)
            for i, r in enumerate(rows)]
    jax_spec = {}
    for L in (2, 4):
        jsrv = jserver.RunaheadServer(jcfg, jparams, n_slots=2,
                                      context=CONTEXT, draft_len=L)
        done = jsrv.run([jserver.Request(
            r.rid, r.prompt, r.n_new, seed=r.seed,
            sampler=jsampler.SamplerConfig(greedy=True),
            arrival=r.arrival) for r in reqs])
        s = jsrv.scheduler
        jax_spec[L] = ({c.rid: c.tokens for c in done},
                       (s.n_drafted, s.n_accepted, s.n_decode_steps))
    return reqs, jax_spec


@pytest.fixture(scope="module")
def serial(sharp, screened):
    _, _, cfg, params = sharp
    return _serve(cfg, params, screened[0])[0]


@pytest.mark.parametrize("draft_len,page_size",
                         list(itertools.product([2, 4], [None, 4])))
def test_greedy_spec_streams_match_jax_and_serial(sharp, screened, serial,
                                                  draft_len, page_size):
    _, _, cfg, params = sharp
    reqs, jax_spec = screened
    got, s = _serve(cfg, params, reqs, draft_len=draft_len,
                    page_size=page_size)
    want, counts = jax_spec[draft_len]
    assert got == want == serial
    assert (s.n_drafted, s.n_accepted, s.n_decode_steps) == counts
    if page_size is not None:
        assert s.alloc.n_used == 0


class _Oracle:
    """Drafts the recorded serial continuation of the request whose prompt
    opens the history (``shift`` added to every token: a wrong drafter
    for shift != 0)."""

    device_capable = False

    def __init__(self, prompts_streams, shift=0):
        self.streams = {tuple(p): s for p, s in prompts_streams}
        self.shift = shift

    def __call__(self, history, n):
        stream = self.streams[tuple(history[:S_PROMPT])]
        done = len(history) - S_PROMPT
        out = stream[done:done + n]
        out = out + [out[-1] if out else history[-1]] * (n - len(out))
        return [(t + self.shift) % TINY["vocab"] for t in out]


@pytest.mark.parametrize("page_size", [None, 4])
def test_oracle_and_wrong_drafters(sharp, screened, serial, page_size):
    """Both acceptance arms, forced: an oracle drafter is accepted
    (fewer decode steps than tokens), a wrong one never; both streams
    are the serial ones."""
    _, _, cfg, params = sharp
    reqs = screened[0]
    book = [(r.prompt, serial[r.rid]) for r in reqs]
    got, s = _serve(cfg, params, reqs, draft_len=4, page_size=page_size,
                    drafter=_Oracle(book))
    assert got == serial
    assert s.n_accepted > 0 and s.acceptance_rate > 0.5
    total = sum(len(t) for t in got.values())
    assert s.n_decode_steps < total - len(reqs)
    got, s = _serve(cfg, params, reqs, draft_len=4, page_size=page_size,
                    drafter=_Oracle(book, shift=1))
    assert got == serial
    assert s.n_accepted == 0 and s.n_drafted > 0


def test_mid_draft_eos_and_budget_truncation(sharp, screened, serial):
    """An EOS inside an accepted run cuts the stream there; a run accepted
    past the budget is cut at the budget."""
    _, _, cfg, params = sharp
    reqs = screened[0]
    long = {r.rid: _serve(cfg, params, [dataclasses.replace(
        r, n_new=12, arrival=0)])[0][r.rid] for r in reqs[:2]}
    book = [(r.prompt, long[r.rid]) for r in reqs[:2]]
    r = dataclasses.replace(reqs[0], n_new=12, arrival=0)
    eos = long[r.rid][4]
    stop = long[r.rid].index(eos)
    got, s = _serve(cfg, params, [dataclasses.replace(r, eos_id=eos)],
                    draft_len=4, drafter=_Oracle(book))
    assert got[r.rid] == long[r.rid][:stop + 1]
    assert s.n_accepted > 0
    for n_new in (3, 6):
        cut = [dataclasses.replace(q, n_new=n_new, arrival=0)
               for q in reqs[:2]]
        got, _ = _serve(cfg, params, cut, draft_len=4,
                        drafter=_Oracle(book))
        assert got == {q.rid: long[q.rid][:n_new] for q in cut}


# ---------------------------------------------------------------------------
# fused speculative horizons
# ---------------------------------------------------------------------------

def _spec_workload(*, greedy: bool, backend: str = "torch"):
    """Repetitive prompts of even and odd tokens (the ``looping`` model
    accepts repeat-last drafts after even tokens only)."""
    sc = SamplerConfig(backend=backend, greedy=greedy, top_k=12,
                       temperature=0.9)
    pats = [[4, 4, 6], [3, 5, 7], [8, 8, 1]]
    return [Request(f"r{i}", (pats[i % 3] * 3)[:8], 7 + (i % 3), seed=i,
                    sampler=sc, arrival=i // 3) for i in range(5)]


@pytest.mark.parametrize("greedy,page_size",
                         list(itertools.product([True, False], [None, 4])))
def test_fused_spec_equals_per_step(looping, greedy, page_size):
    cfg, params = looping
    reqs = _spec_workload(greedy=greedy)
    kw = dict(draft_len=3, drafter=draft.RepeatLastDrafter(),
              page_size=page_size)
    ref, s1 = _serve(cfg, params, reqs, **kw)
    got, sK = _serve(cfg, params, reqs, step_horizon=4, **kw)
    assert got == ref
    assert {r: len(t) for r, t in got.items()} == {
        r.rid: r.n_new for r in reqs}
    assert sK.n_horizons >= 1
    assert (sK.n_drafted, sK.n_accepted) == (s1.n_drafted, s1.n_accepted)
    assert 0 < s1.n_accepted < s1.n_drafted
    if page_size is not None:
        assert sK.alloc.n_used == 0


def test_fused_spec_hopper_backend(looping):
    """The kernels' plain versions (backend ``hopper`` on the CPU) under
    the verify grid's B·L rows, fused against per-step."""
    cfg, params = looping
    reqs = _spec_workload(greedy=False, backend="hopper")[:3]
    kw = dict(draft_len=2, drafter=draft.RepeatLastDrafter(),
              backend="hopper", page_size=4, page_impl="hopper")
    ref, _ = _serve(cfg, params, reqs, **kw)
    got, _ = _serve(cfg, params, reqs, step_horizon=4, **kw)
    assert got == ref


# ---------------------------------------------------------------------------
# drafters, tuning, retuning and validation
# ---------------------------------------------------------------------------

def test_drafters_match_jax():
    rng = np.random.default_rng(5)
    drafters = [(draft.RepeatLastDrafter(), jdraft.RepeatLastDrafter())]
    for lo, hi in ((1, 4), (2, 3), (1, 1)):
        drafters.append((draft.NGramDrafter(min_ngram=lo, max_ngram=hi),
                         jdraft.NGramDrafter(min_ngram=lo, max_ngram=hi)))
    for _ in range(300):
        h = rng.integers(0, 4, size=rng.integers(0, 24)).tolist()
        n = int(rng.integers(0, 6))
        for mine, ref in drafters:
            assert mine(h, n) == ref(h, n), (h, n)
    assert draft.RepeatLastDrafter.device_capable
    assert not draft.NGramDrafter.device_capable
    with pytest.raises(ValueError, match="min_ngram"):
        draft.NGramDrafter(min_ngram=3, max_ngram=2)


def test_decide_draft_len_matches_jax():
    for a, over, cap, cost in itertools.product(
            [0.0, 0.1, 0.5, 0.6, 0.9, 0.99, 1.0], [0.0073, 0.5, 4.3, 20.0],
            [1, 4, 8], [1.0, 2.5]):
        kw = dict(acceptance=a, overhead=over, max_draft_len=cap,
                  token_cost=cost)
        assert tuning.decide_draft_len(**kw) == jtuning.decide_draft_len(
            **kw), kw
    # the card's own overhead at the launcher's prior picks L = 1
    assert tuning.decide_draft_len(acceptance=0.6) == 1


def test_retunes_from_measured_acceptance(looping):
    """JAX's ``TestAdaptiveDraftLen``: once the window fills, L contracts
    to the floor of 2 (the card's overhead prices drafts above their
    yield) and the retune is counted; greedy streams survive it."""
    cfg, params = looping
    reqs = _spec_workload(greedy=False)
    kw = dict(draft_len=4, drafter=draft.RepeatLastDrafter(),
              draft_len_auto=True, step_horizon=2)
    _, sched = _serve(cfg, params, reqs, **kw)
    assert sched.n_draft_retunes >= 1
    assert sched.draft_len == 2
    assert sched.max_draft_len == 8
    greedy = _spec_workload(greedy=True)
    ref, _ = _serve(cfg, params, greedy, draft_len=4,
                    drafter=draft.RepeatLastDrafter())
    srv = RunaheadServer(cfg, params, n_slots=2, context=CONTEXT,
                         cache_dtype=F32, compute_dtype=F32, **kw)
    srv.scheduler.draft_retune_min = 8     # retune inside this short serve
    got = {c.rid: c.tokens for c in srv.run(greedy)}
    assert got == ref
    assert srv.scheduler.n_draft_retunes >= 1


def test_suggested_step_horizon_priced_by_acceptance(looping):
    cfg, params = looping
    sched = ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                                draft_len=4)
    sched.admit("x", [1, 2, 3], 24, 0, SamplerConfig())
    sched.n_drafted, sched.n_accepted = 30, 15
    assert sched.suggested_step_horizon(max_horizon=16) == (
        tuning.decide_step_horizon(mean_remaining=23 / 2.5, max_horizon=16))


def test_validation(looping):
    cfg, params = looping
    mk = lambda **kw: ContinuousScheduler(cfg, params, n_slots=2,
                                          context=CONTEXT, **kw)
    with pytest.raises(ValueError, match="draft_len must be"):
        mk(draft_len=0)
    with pytest.raises(ValueError, match="draft_len_auto"):
        mk(draft_len=1, draft_len_auto=True)
    with pytest.raises(ValueError, match="max_draft_len"):
        mk(draft_len=4, max_draft_len=2)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        mk(draft_len=CONTEXT + 1)
    with pytest.raises(ValueError, match="device-capable"):
        mk(step_horizon=2, draft_len=3, drafter=draft.NGramDrafter())
    with pytest.raises(ValueError, match="dense"):
        ContinuousScheduler(testing.reduced_config("qwen2-moe-a2.7b"),
                            params, n_slots=2, context=CONTEXT, draft_len=2)
    assert not decode.verify_supported(
        testing.reduced_config("qwen2-moe-a2.7b"))
    assert isinstance(mk(draft_len=3).drafter, draft.NGramDrafter)
    # paged chains hold the largest L's overshoot
    s = mk(draft_len=3, page_size=4, cache_pages=4)
    with pytest.raises(ValueError, match="never succeed"):
        s.validate_request(2, SamplerConfig(), prompt_len=11)
    s.validate_request(2, SamplerConfig(), prompt_len=9)


def test_launcher_flags():
    for bad in ("0", "x"):
        with pytest.raises(SystemExit):
            serve.parse_args(["--continuous", "--draft-len", bad,
                              "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--draft-len", "3", "--device", "cpu"])
    cfg = testing.reduced_config("qwen3-4b")
    args = serve.parse_args(["--continuous", "--draft-len", "auto",
                             "--step-horizon", "auto", "--new-tokens", "200",
                             "--device", "cpu"])
    assert serve.resolve_draft_len(args, cfg) == tuning.decide_draft_len(
        acceptance=0.6)
    assert serve.resolve_step_horizon(args, 3) == (
        tuning.decide_step_horizon(mean_remaining=150 / 2.2))


@pytest.mark.parametrize("extra", [[], ["--adaptive-draft",
                                        "--step-horizon", "4"]])
def test_serve_speculative_runs_end_to_end_on_cpu(extra):
    out = serve.main(["--arch", "qwen3-4b", "--reduced", "--continuous",
                      "--requests", "5", "--slots", "2", "--prompt-len", "6",
                      "--new-tokens", "4", "--top-k", "40", "--draft-len",
                      "3", "--page-size", "4", "--page-impl", "hopper",
                      "--device", "cpu"] + extra)
    s = out.scheduler
    assert sorted(c.rid for c in out.completions) == list(range(5))
    assert all(2 <= len(c.tokens) <= 4 for c in out.completions)
    assert s.draft_len >= 2 and s.n_drafted > 0
    assert out.counts["drafted"] == s.n_drafted
    if extra:
        assert isinstance(s.drafter, draft.RepeatLastDrafter)
        assert s.draft_len_auto and s.n_horizons > 0
