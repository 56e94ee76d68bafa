"""The port's fused decode horizons (``ContinuousScheduler(step_horizon=K)``,
DESIGN.md §14) on the CPU, at the tiny config of ``tests/test_horizon.py``
(reduced internlm2-1.8b cut to 2 layers, d_model 32, vocab 128).

On the CPU the graphed bodies run eagerly (``core/graphs.py``), so these
tests hold the horizon's logic: K iterations of the per-step body with
EOS and budget detected inside, the host replay, the counters.  The card
tests (``tests/test_torch_cuda.py``) hold the graph replays.

Tolerances and why:
  * fused streams against per-step streams, dense and paged, backends
    ``torch`` and ``hopper`` (the kernels' plain versions here): bit for
    bit, the same body on the same inputs and noise;
  * the state a mid-horizon finish leaves (token, pos, cache; on the
    paged cache every page but the null page): bit for bit;
  * ``decide_step_horizon`` against JAX's at the same ``overhead``:
    equal (host arithmetic, a copy of the JAX function);
  * greedy streams at K = 2 against JAX's ``ContinuousScheduler(
    step_horizon=2)``: equal, on prompts screened along JAX's one-shot
    stream for a top-1/top-2 logit gap above 10x the bf16 tolerance
    (2**-6 * max|logit|), the unembedding sharpened toward a fixed
    successor token as ``tests/test_torch_continuous.py`` does.
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
from repro.serving import sampler as jsampler
from repro.serving import server as jserver
from repro_torch.convert import params_from_jax
from repro_torch.core import tuning
from repro_torch.launch import serve
from repro_torch.models import testing
from repro_torch.models.transformer import init_params
from repro_torch.serving.draft import NGramDrafter
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
import torch_one_thread  # noqa: F401 (one torch thread)

CONTEXT = 32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=128)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    return cfg, params


def _workload(backend: str = "torch") -> list[Request]:
    """Staggered arrivals and mixed samplers on 2 slots: queueing, slot
    reuse and mid-horizon finishes all occur."""
    sc = lambda **kw: SamplerConfig(backend=backend, **kw)
    return [
        Request("a", [1, 2, 3, 4], 5, seed=11, sampler=sc(top_k=12)),
        Request("b", [9, 8, 7, 6, 5], 3, seed=22, sampler=sc(top_p=0.9)),
        Request("c", [4, 4, 4], 1, seed=33,
                sampler=sc(target_entropy=2.0), arrival=1),
        Request("d", [10, 20, 30, 40], 6, seed=44,
                sampler=sc(temperature=0.7), arrival=2),
        Request("e", [2, 4, 6, 8], 4, seed=55,
                sampler=sc(top_k=8, top_p=0.95), arrival=4),
    ]


def _serve(cfg, params, reqs, **kw):
    kw = dict(dict(n_slots=2, context=CONTEXT), **kw)
    srv = RunaheadServer(cfg, params, **kw)
    return ({c.rid: c.tokens for c in srv.run([dataclasses.replace(r)
                                                for r in reqs])},
            srv.scheduler)


@pytest.fixture(scope="module")
def per_step(tiny):
    """The per-step dense streams of the workload, per backend."""
    cfg, params = tiny
    return {be: _serve(cfg, params, _workload(be), backend=be)[0]
            for be in ("torch", "hopper")}


# ---------------------------------------------------------------------------
# fused streams equal per-step streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,page_size,horizon",
                         list(itertools.product(["torch", "hopper"],
                                                [None, 4], [2, 4])))
def test_fused_streams_equal_per_step(tiny, per_step, backend, page_size,
                                      horizon):
    """Mixed samplers through queueing and slot recycling at horizon
    boundaries: fused (dense or paged) == per-step dense, bit for bit."""
    cfg, params = tiny
    got, sched = _serve(cfg, params, _workload(backend), backend=backend,
                        page_size=page_size, step_horizon=horizon)
    assert got == per_step[backend]
    assert sched.n_horizons >= 1
    assert {r: len(t) for r, t in got.items()} == {
        r.rid: r.n_new for r in _workload()}
    if page_size is not None:
        assert sched.alloc.n_used == 0        # every chain released


# ---------------------------------------------------------------------------
# mid-horizon termination
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [None, 4])
def test_state_frozen_after_budget_finish(tiny, page_size):
    """One request, K far past its budget: the slot finishes at iteration
    j < K and the rest of the horizon leaves token, pos and cache exactly
    as per-step eviction left them."""
    cfg, params = tiny
    req = Request("solo", [5, 6, 7], 4, seed=3,
                  sampler=SamplerConfig(top_k=8))
    ref, s_ref = _serve(cfg, params, [req], page_size=page_size)
    got, s_fused = _serve(cfg, params, [req], page_size=page_size,
                          step_horizon=8)
    assert got == ref
    assert s_fused.n_horizons == 1            # 3 decode steps fit in K=8
    assert torch.equal(s_fused.token, s_ref.token)
    assert torch.equal(s_fused.pos, s_ref.pos)
    if page_size is None:
        for a, b in zip(s_fused.cache, s_ref.cache):
            assert torch.equal(a["kv"].k, b["kv"].k)
            assert torch.equal(a["kv"].v, b["kv"].v)
    else:
        # frozen slots write through a null-masked table: every page but
        # the null page equals the per-step pool
        for a, b in zip(s_fused.pool, s_ref.pool):
            assert torch.equal(a["kv"].k[:, 1:], b["kv"].k[:, 1:])
            assert torch.equal(a["kv"].v[:, 1:], b["kv"].v[:, 1:])


def test_eos_mid_horizon(tiny):
    """EOS fires inside the horizon: the stream stops where per-step host
    truncation stops it, and a co-resident request decodes on
    unperturbed."""
    cfg, params = tiny
    sc = SamplerConfig(greedy=True)
    probe = Request("p", [5, 6, 7], 12, seed=3, sampler=sc)
    mate = Request("m", [8, 9, 10, 11], 12, seed=4, sampler=sc)
    full, _ = _serve(cfg, params, [probe, mate])
    eos = full["p"][5]
    stop_at = full["p"].index(eos)
    reqs = [dataclasses.replace(probe, eos_id=eos), mate]
    ref, _ = _serve(cfg, params, reqs)
    got, _ = _serve(cfg, params, reqs, step_horizon=8)
    assert got == ref
    assert got["p"] == full["p"][:stop_at + 1]
    assert got["m"] == full["m"]


@pytest.mark.parametrize("page_size", [None, 4])
def test_slot_recycled_at_next_boundary(tiny, page_size):
    """A slot freed mid-horizon admits a queued request at the next
    boundary, and that request's stream is its per-step stream: the
    frozen interlude left nothing behind in the recycled slot."""
    cfg, params = tiny
    reqs = [
        Request("short", [1, 2, 3], 2, seed=7,
                sampler=SamplerConfig(top_k=8)),
        Request("long", [4, 5, 6, 7], 9, seed=8, sampler=SamplerConfig()),
        Request("late", [7, 7, 2], 6, seed=9,
                sampler=SamplerConfig(temperature=0.8)),
    ]
    ref, _ = _serve(cfg, params, reqs, page_size=page_size)
    got, sched = _serve(cfg, params, reqs, page_size=page_size,
                        step_horizon=4)
    assert got == ref
    assert sched.n_admissions == 3


# ---------------------------------------------------------------------------
# counters and horizon sizing
# ---------------------------------------------------------------------------

def test_fused_dispatch_counts(tiny):
    """Every slot admitted up front: ceil(steps / K) horizons, each one
    dispatch and one host sync, plus two dispatches and one sync per
    admission (DESIGN.md §14)."""
    cfg, params = tiny
    sc = SamplerConfig(top_k=8)
    reqs = [Request("a", [1, 2, 3], 5, seed=1, sampler=sc),
            Request("b", [4, 5, 6], 9, seed=2, sampler=sc)]
    K = 4
    ref, s1 = _serve(cfg, params, reqs)
    got, sK = _serve(cfg, params, reqs, step_horizon=K)
    assert got == ref
    per_step = s1.n_decode_steps              # 8: the longest tail
    horizons = -(-per_step // K)
    assert sK.n_horizons == horizons
    assert sK.n_decode_steps == K * horizons
    assert sK.n_admissions == 2
    assert sK.n_dispatches == horizons + 2 * sK.n_admissions
    assert sK.n_host_syncs == horizons + sK.n_admissions
    assert s1.n_dispatches == per_step + 2 * s1.n_admissions
    assert s1.n_host_syncs == per_step + s1.n_admissions
    assert s1.n_horizons == s1.n_wasted_steps == 0


def test_wasted_iterations_counted(tiny):
    """A lone 4-token request in a K=8 horizon: the iterations after its
    finish run with every slot frozen and are counted."""
    cfg, params = tiny
    req = Request("w", [5, 6, 7], 4, seed=3, sampler=SamplerConfig())
    _, sched = _serve(cfg, params, [req], step_horizon=8)
    assert sched.n_horizons == 1
    assert sched.n_wasted_steps == 8 - 3      # 3 live iterations
    assert sched.n_decode_steps == 8


def test_suggested_step_horizon_reads_live_counters(tiny):
    cfg, params = tiny
    sched = ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                                step_horizon=2)
    assert sched.suggested_step_horizon() == 2        # empty: keep K
    sched.admit("x", [1, 2, 3], 24, 0, SamplerConfig())
    sched.admit("y", [4, 5], 11, 0, SamplerConfig())
    k = sched.suggested_step_horizon(max_horizon=16)
    assert k == tuning.decide_step_horizon(mean_remaining=(23 + 10) / 2,
                                           max_horizon=16)
    small = ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT)
    small.admit("z", [1, 2, 3], 2, 0, SamplerConfig())
    assert small.suggested_step_horizon() <= k        # short tail


@pytest.mark.parametrize("overhead", [0.0, 0.05, 0.5, 4.3, 20.0])
def test_decide_step_horizon_matches_jax(overhead):
    for m, load, cap, cost in itertools.product(
            [1, 1.5, 4, 23, 200], [0.0, 0.5, 1.0], [1, 8, 64], [1.0, 2.5]):
        kw = dict(mean_remaining=m, token_cost=cost, overhead=overhead,
                  load=load, max_horizon=cap)
        assert (tuning.decide_step_horizon(**kw)
                == jtuning.decide_step_horizon(**kw)), kw


def test_validation(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="step_horizon"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            step_horizon=0)
    # a fused speculative horizon drafts on the card: a host drafter
    # cannot run inside its graph (JAX's TestAdaptiveDraftLen check)
    with pytest.raises(ValueError, match="device-capable"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            draft_len=3, step_horizon=2,
                            drafter=NGramDrafter())
    for bad in ("0", "-2", "x"):
        with pytest.raises(SystemExit):
            serve.parse_args(["--continuous", "--step-horizon", bad,
                              "--device", "cpu"])
    args = serve.parse_args(["--continuous", "--step-horizon", "auto",
                             "--new-tokens", "32", "--device", "cpu"])
    assert serve.resolve_step_horizon(args) == tuning.decide_step_horizon(
        mean_remaining=24.0)


def test_serve_step_horizon_runs_end_to_end_on_cpu():
    out = serve.main(["--arch", "qwen3-4b", "--reduced", "--continuous",
                      "--requests", "5", "--slots", "2", "--prompt-len", "6",
                      "--new-tokens", "4", "--page-size", "4", "--top-k",
                      "40", "--step-horizon", "4", "--device", "cpu"])
    s = out.scheduler
    assert sorted(c.rid for c in out.completions) == list(range(5))
    assert s.step_horizon == 4 and s.n_horizons > 0
    assert s.n_dispatches == s.n_horizons + 2 * s.n_admissions
    assert s.n_host_syncs == s.n_horizons + s.n_admissions


# ---------------------------------------------------------------------------
# against the JAX scheduler
# ---------------------------------------------------------------------------

S_PROMPT, N_NEW = 4, [5, 3, 6, 4]


def test_greedy_horizon_streams_match_jax():
    """K = 2 greedy streams, dense and paged, equal JAX's
    ``ContinuousScheduler(step_horizon=2)`` streams on a tie-screened
    workload, on the same weights."""
    jcfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                               **TINY)
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    perm = np.random.default_rng(1).permutation(jcfg.vocab)
    jparams["unembed"] = jparams["unembed"] + 4.0 * jparams["embed"][perm].T
    cand = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(32, S_PROMPT)).astype(np.int32)
    lg, cache = jdecode.prefill(jcfg, jparams, jnp.asarray(cand),
                                S_PROMPT + max(N_NEW))
    ok = np.ones(len(cand), bool)
    for i in range(max(N_NEW)):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        ok &= top2[:, 1] - top2[:, 0] > 10 * 2.0 ** -6 * np.abs(lg).max(-1)
        if i < max(N_NEW) - 1:
            lg, cache = jdecode.decode_step(
                jcfg, jparams, jnp.asarray(lg.argmax(-1), jnp.int32),
                jnp.int32(S_PROMPT + i), cache)
    rows = np.flatnonzero(ok)[:len(N_NEW)]
    assert len(rows) == len(N_NEW)
    reqs = [Request(f"r{i}", cand[r].tolist(), N_NEW[i], seed=i,
                    sampler=SamplerConfig(greedy=True), arrival=i // 2)
            for i, r in enumerate(rows)]
    jsrv = jserver.RunaheadServer(jcfg, jparams, n_slots=2, context=CONTEXT,
                                  step_horizon=2)
    want = {c.rid: c.tokens for c in jsrv.run([
        jserver.Request(r.rid, r.prompt, r.n_new, seed=r.seed,
                        sampler=jsampler.SamplerConfig(greedy=True),
                        arrival=r.arrival) for r in reqs])}
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    for page_size in (None, 4):
        got, sched = _serve(cfg, params, reqs, page_size=page_size,
                            step_horizon=2)
        assert got == want
        assert sched.n_horizons == jsrv.scheduler.n_horizons
        assert sched.n_dispatches == jsrv.scheduler.n_dispatches
