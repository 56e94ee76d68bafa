"""Mesh-native continuous serving in the port (``ContinuousScheduler(
mesh=)``, ``launch/serve.py --mesh``) on gloo ranks on the CPU, and
Queue 1 item 2f: qwen1.5-4b, chameleon-34b and deepseek-coder-33b held
against JAX at reduced width.

The ranks run ``tests/torch_mesh_ranks.py`` (no JAX); this process holds
their streams against the single-rank port and against JAX.

Contracts:
  * under a 2x2 mesh (a data and a vocab split) on the dense ring and
    the paged pool at horizons 1 and 4, under 4x1 (data only) paged at
    horizon 4 and under 1x4 (vocab only) dense per step: greedy and
    top-k streams equal the single-rank port's bit for bit, and the
    greedy streams equal JAX's per-step
    ``ContinuousScheduler`` on prompts screened along JAX's stream for a
    top-1/top-2 logit gap above 10x the bf16 tolerance (2**-6 of the
    row's largest |logit|), the unembedding sharpened toward a fixed
    successor (``tests/test_torch_horizon.py``'s workload);
  * ``launch/serve.py --mesh 2x2 --host-devices 4`` spawns its ranks and
    serves the same streams as the single-rank launcher;
  * speculation under a mesh (``draft_len=3``) on JAX's workload of
    ``tests/test_sharded_serving.py`` (reduced internlm2, 2 layers,
    d_model 32, f32, a greedy repetitive workload; two top-k requests
    added, which the solves of the verify grid vocab-shard): under 2x2,
    4x1 and 1x4, dense and paged, the streams equal the single-rank
    port's bit for bit, and the greedy ones JAX's single-device
    speculative server's (never JAX's mesh, whose own speculative case
    fails); drafts accepted on every run; each rank's drafts a step equal
    the single-rank scheduler's rows of its slots, and a live retune of
    L happens at the same steps on every rank; a fused speculative
    horizon under 2x2 equals its per-step run;
  * ``mesh=`` with ``draft_len > 1`` raises for a config that cannot
    verify, as without a mesh;
  * 2f: each config's greedy one-shot ``generate`` equals JAX's
    ``generate`` on screened prompts, single-rank and served under a 2x2
    mesh (whose top-k stream also equals the single-rank port's).

Every meshed serve of the module runs on one group of four gloo ranks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro.serving import server as jserver
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_local
from repro_torch.models import decode, testing
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine
from repro_torch.serving.draft import RepeatLastDrafter
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Request, RunaheadServer
import torch_one_thread  # noqa: F401 (one torch thread)

CONTEXT = 32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=128)
S_PROMPT, N_NEW = 4, [5, 3, 6, 4]
RUNS = [dict(), dict(page_size=4), dict(step_horizon=4),
        dict(page_size=4, step_horizon=4)]
# (mesh, run) served: every run under 2x2; 4x1 and 1x4 each take the run
# whose code they add to (slot partitions of the page pool and fused
# horizons under a data split; the vocab-sharded solves alone)
PLAN = [("2x2", run) for run in range(len(RUNS))] + [("4x1", 3), ("1x4", 0)]
LOCAL_SLOTS = {"2x2": 2, "4x1": 1, "1x4": 4}


def _screened(cfg, params, n_rows: int, n_new: int, n_cand: int = 64,
              seed: int = 7) -> np.ndarray:
    """Candidate prompts whose greedy stream keeps a top-1/top-2 logit
    gap above 10x the bf16 tolerance at every step, screened along the
    port's f32 stream (a prompt JAX then decodes otherwise fails the
    comparison, it cannot pass it)."""
    cand = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(n_cand, S_PROMPT))
    kw = dict(compute_dtype=torch.float32)
    lg, cache = decode.prefill(cfg, params, torch.from_numpy(cand),
                               S_PROMPT + n_new, **kw)
    ok = np.ones(n_cand, bool)
    for i in range(n_new):
        top2 = lg.float().sort(dim=-1).values[:, -2:].numpy()
        tol = 2.0 ** -6 * lg.float().abs().amax(-1).numpy()
        ok &= top2[:, 1] - top2[:, 0] > 10 * tol
        if i < n_new - 1:
            lg, cache = decode.decode_step(cfg, params, lg.argmax(-1),
                                           S_PROMPT + i, cache, **kw)
    rows = np.flatnonzero(ok)[:n_rows]
    assert len(rows) == n_rows
    return cand[rows].astype(np.int32)


def _sharpened(cfg, scale: float):
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    perm = np.random.default_rng(1).permutation(cfg.vocab)
    jparams["unembed"] = jparams["unembed"] + scale * jparams["embed"][perm].T
    return jparams


@functools.cache
def _tiny():
    """The workload: four screened greedy requests and four top-k ones,
    arriving two a step over 4 slots; JAX's per-step greedy streams."""
    jcfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                               **TINY)
    jparams = _sharpened(jcfg, 4.0)
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    prompts = _screened(cfg, params_from_jax(jax.device_get(jparams), "cpu"),
                        len(N_NEW), max(N_NEW), n_cand=32)
    greedy = [Request(f"g{i}", prompts[i].tolist(), N_NEW[i], seed=i,
                      sampler=SamplerConfig(greedy=True), arrival=i // 2)
              for i in range(len(N_NEW))]
    jsrv = jserver.RunaheadServer(jcfg, jparams, n_slots=4, context=CONTEXT)
    want = {c.rid: c.tokens for c in jsrv.run([
        jserver.Request(r.rid, r.prompt, r.n_new, seed=r.seed,
                        sampler=jsampler.SamplerConfig(greedy=True),
                        arrival=r.arrival) for r in greedy])}
    topk = [Request(f"k{i}", [(7 * i + j) % 128 for j in range(5)], 4 + i,
                    seed=40 + i, sampler=SamplerConfig(top_k=8),
                    arrival=1 + i // 2) for i in range(4)]
    return jax.device_get(jparams), greedy + topk, want


def _single_rank(tree, requests, kw) -> dict:
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    srv = RunaheadServer(cfg, params_from_jax(tree, "cpu"), n_slots=4,
                         context=CONTEXT, **kw)
    return {c.rid: c.tokens
            for c in srv.run([dataclasses.replace(r) for r in requests])}


@functools.cache
def _meshed() -> tuple[list, dict]:
    """Every meshed serve of the module on one group of four ranks: the
    tiny workload's runs as ``PLAN`` says ([per rank: a result per plan
    entry]), and each 2f config under 2x2 ({arch: [per rank: its
    result]})."""
    tree, requests, _ = _tiny()
    runs = [(requests, dict(n_slots=4, context=CONTEXT, **kw))
            for kw in RUNS]
    jobs = [(PLAN, ("internlm2-1.8b", TINY, tree, 0), runs)]
    for arch in ARCHS_2F:
        tree_2f, prompt, _ = _jax_2f(arch)
        jobs.append(([("2x2", 0)], (arch, {}, tree_2f, 0),
                     [(_requests_2f(prompt),
                       dict(n_slots=2, context=S_PROMPT + N_2F))]))
    tree_spec, requests_spec, _ = _spec_workload()
    jobs.append((SPEC_PLAN, ("internlm2-1.8b", TINY, tree_spec, 0),
                 [(requests_spec, dict(n_slots=4, context=CONTEXT, **kw))
                  for kw in SPEC_RUNS]))
    results = spawn_local(ranks.serve_many, 4,
                          args=(jobs, SPEC_LAUNCH + ["--mesh", "2x2"]),
                          timeout=300)
    tiny = [per_rank[0] for per_rank in results]
    two_f = {arch: [per_rank[i + 1][0] for per_rank in results]
             for i, arch in enumerate(ARCHS_2F)}
    spec = [per_rank[-2] for per_rank in results]
    launched = [per_rank[-1] for per_rank in results]
    return tiny, two_f, spec, launched


@pytest.mark.parametrize("run", range(len(RUNS)))
def test_meshed_streams_equal_single_rank_and_jax(run):
    tree, requests, want = _tiny()
    ref = _single_rank(tree, requests, RUNS[run])
    assert {rid: ref[rid] for rid in want} == want
    results = _meshed()[0]
    served = [i for i, (_, r) in enumerate(PLAN) if r == run]
    for r, per_rank in enumerate(results):
        for i in served:
            spec, got = PLAN[i][0], per_rank[i]
            assert got["streams"] == ref, (spec, r, RUNS[run])
            assert got["local"] == LOCAL_SLOTS[spec]
            assert got["checksum"] == results[0][0]["checksum"]


def test_launcher_mesh_on_host_ranks():
    argv = ["--arch", "qwen3-4b", "--reduced", "--continuous",
            "--requests", "6", "--slots", "4", "--prompt-len", "8",
            "--new-tokens", "6", "--top-k", "40", "--top-p", "0.9",
            "--target-entropy", "3.0", "--page-size", "4"]
    want = serve.main(argv + ["--device", "cpu"])
    got = serve.main(argv + ["--mesh", "2x2", "--host-devices", "4"])
    assert got.scheduler is None              # it came back from rank 0
    assert ({c.rid: c.tokens for c in got.completions}
            == {c.rid: c.tokens for c in want.completions})
    with pytest.raises(SystemExit, match="--mesh requires --continuous"):
        serve.parse_args(["--mesh", "2x2"])
    if not torch.cuda.is_available():
        # a mesh started in this process keeps to --device: cuda raises
        with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
            serve.setup(argv + ["--mesh", "1x1"])
    with pytest.raises(SystemExit):
        serve.parse_args(argv + ["--mesh", "2x2", "--host-devices", "3"])


def test_mesh_with_speculation_raises():
    mesh = mesh_lib.parse_mesh("1x1")
    moe_cfg = testing.reduced_config("granite-moe-3b-a800m")
    moe_params = init_params(moe_cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    with pytest.raises(ValueError, match="all-dense layer stack"):
        ContinuousScheduler(moe_cfg, moe_params, n_slots=2, context=CONTEXT,
                            mesh=mesh, draft_len=3)
    # one rank: the meshed speculative scheduler serves as the plain one
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    params = params_from_jax(_tiny()[0], "cpu")
    sched = ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                                mesh=mesh, draft_len=3)
    assert sched.n_local == 2 and sched.draft_len == 3


# ---------------------------------------------------------------------------
# speculation under a mesh: JAX's workload of test_sharded_serving.py
# ---------------------------------------------------------------------------

F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32)
SPEC_RUNS = [
    dict(draft_len=3, **F32),
    dict(draft_len=3, page_size=4, **F32),
    # a live retune of L every 4 drafted tokens
    dict(draft_len=3, draft_len_auto=True, max_draft_len=4,
         draft_retune_min=4, **F32),
    dict(draft_len=3, step_horizon=4, drafter=RepeatLastDrafter(), **F32),
]
SPEC_PLAN = ([("2x2", run) for run in range(len(SPEC_RUNS))]
             + [(m, run) for m in ("4x1", "1x4") for run in (0, 1)])


@functools.cache
def _spec_workload():
    """JAX's speculative workload (``tests/test_sharded_serving.py``):
    five greedy requests on repeated patterns, three arriving a step,
    plus two top-k 12 requests; JAX's single-device speculative server's
    greedy streams (four slots, ``draft_len=3``).  The port serves in
    f32 (forward and cache)."""
    jcfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                               **TINY)
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    # drafts of JAX's random tiny model are never accepted: the
    # unembedding sharpened toward the token itself for even tokens and
    # a shuffled successor for odd ones (``tests/test_torch_speculative
    # .py``'s ``looping``) makes streams settle into runs the n-gram
    # drafter predicts
    perm = np.arange(jcfg.vocab)
    odd = perm[1::2].copy()
    np.random.default_rng(2).shuffle(odd)
    perm[1::2] = odd
    jparams["unembed"] = jparams["unembed"] + 4.0 * jparams["embed"][perm].T
    pats = [[3, 5, 7], [2, 4, 6], [9, 9, 1]]
    greedy = [Request(f"r{i}", (pats[i % 3] * 3)[:8], 7 + (i % 3), seed=i,
                      sampler=SamplerConfig(greedy=True, top_k=12),
                      arrival=i // 3) for i in range(5)]
    jsrv = jserver.RunaheadServer(jcfg, jparams, n_slots=4, context=CONTEXT,
                                  draft_len=3)
    want = {c.rid: c.tokens for c in jsrv.run([
        jserver.Request(r.rid, r.prompt, r.n_new, seed=r.seed,
                        sampler=jsampler.SamplerConfig(greedy=True,
                                                       top_k=12),
                        arrival=r.arrival) for r in greedy])}
    assert jsrv.scheduler.n_accepted > 0
    topk = [Request(f"k{i}", (pats[i] * 3)[:8], 8, seed=20 + i,
                    sampler=SamplerConfig(top_k=12), arrival=1)
            for i in range(2)]
    return jax.device_get(jparams), greedy + topk, want


@functools.cache
def _spec_single(run: int, drafter=None):
    """The single-rank port's serve of the speculative workload under
    ``SPEC_RUNS[run]`` (``drafter`` replacing its drafter): (streams,
    each step's (L, drafts), accepted count)."""
    tree, requests, _ = _spec_workload()
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    kw = dict(SPEC_RUNS[run], n_slots=4, context=CONTEXT)
    if drafter is not None:
        kw["drafter"] = drafter
    done, s, drafts = ranks.serve_recorded(
        cfg, params_from_jax(tree, "cpu"), requests, kw)
    return {c.rid: c.tokens for c in done}, drafts, s.n_accepted


@pytest.mark.parametrize("entry", range(len(SPEC_PLAN)),
                         ids=[f"{m}-run{r}" for m, r in SPEC_PLAN])
def test_meshed_speculation_equals_single_rank_and_jax(entry):
    spec, run = SPEC_PLAN[entry]
    _, _, want = _spec_workload()
    ref, ref_drafts, accepted = _spec_single(run)
    assert {rid: ref[rid] for rid in want} == want
    assert accepted > 0
    results = _meshed()[2]
    for r, per_rank in enumerate(results):
        got = per_rank[entry]
        assert got["streams"] == ref, (spec, r, SPEC_RUNS[run])
        assert got["local"] == LOCAL_SLOTS[spec]
        assert got["accepted"] > 0
        assert got["accepted"] == results[0][entry]["accepted"]
        assert got["retunes"] == results[0][entry]["retunes"]
        # this rank's drafts are the single-rank scheduler's rows of its
        # slots, at the same L, step by step
        lo, n = got["slot0"], got["local"]
        assert [L for L, _ in got["drafts"]] == [L for L, _ in ref_drafts]
        for (L, d), (_, d_ref) in zip(got["drafts"], ref_drafts):
            assert d == d_ref[lo:lo + n], (spec, r, L)
    if "draft_len_auto" in SPEC_RUNS[run]:
        assert results[0][entry]["retunes"] > 0
        assert len({L for L, _ in ref_drafts}) > 1


SPEC_LAUNCH = ["--arch", "qwen3-4b", "--reduced", "--continuous",
               "--requests", "6", "--slots", "4", "--prompt-len", "8",
               "--new-tokens", "6", "--top-k", "40", "--page-size", "4",
               "--draft-len", "3", "--adaptive-draft", "--device", "cpu"]


def test_launcher_speculates_under_a_mesh():
    """``launch/serve.py --mesh 2x2 --draft-len 3 --adaptive-draft`` in
    the group: every rank serves the single-rank launcher's streams with
    its counters (drafted, accepted, retunes: global) and L."""
    want = serve.main(SPEC_LAUNCH)
    for got in _meshed()[3]:
        assert got["streams"] == {c.rid: c.tokens for c in want.completions}
        assert got["counts"] == want.counts
        assert got["draft_len"] == want.scheduler.draft_len
    assert want.counts["drafted"] > 0


def test_meshed_fused_speculation_equals_per_step():
    fused = SPEC_PLAN.index(("2x2", 3))
    per_step, _, _ = _spec_single(0, drafter=RepeatLastDrafter())
    assert _spec_single(3)[0] == per_step
    for per_rank in _meshed()[2]:
        assert per_rank[fused]["streams"] == per_step


# ---------------------------------------------------------------------------
# Queue 1 item 2f: three configs held against JAX at reduced width
# ---------------------------------------------------------------------------

ARCHS_2F = ["qwen1.5-4b", "chameleon-34b", "deepseek-coder-33b"]
N_2F = 6


@functools.cache
def _jax_2f(arch: str):
    """Two screened prompts, JAX's greedy generate over them, and the
    weights (sharpened as ``tests/test_torch_serving.py`` does)."""
    cfg = jtesting.reduced_config(arch)
    jparams = _sharpened(cfg, 2.0)
    prompt = _screened(testing.reduced_config(arch),
                       params_from_jax(jax.device_get(jparams), "cpu"), 2,
                       N_2F)
    want = np.asarray(jengine.generate(
        cfg, jparams, jnp.asarray(prompt), N_2F, jax.random.PRNGKey(0),
        sampler=jsampler.SamplerConfig(greedy=True)))
    return jax.device_get(jparams), prompt, want


def _requests_2f(prompt) -> list:
    greedy = [Request(f"g{i}", row.tolist(), N_2F, seed=i,
                      sampler=SamplerConfig(greedy=True))
              for i, row in enumerate(prompt)]
    return greedy + [Request("k", prompt[0].tolist(), N_2F, seed=9,
                             sampler=SamplerConfig(top_k=12), arrival=1)]


@pytest.mark.parametrize("arch", ARCHS_2F)
def test_2f_configs_match_jax_generate(arch):
    tree, prompt, want = _jax_2f(arch)
    cfg = testing.reduced_config(arch)
    params = params_from_jax(tree, "cpu")
    got = engine.generate(cfg, params, torch.from_numpy(prompt), N_2F, None,
                          sampler=SamplerConfig(greedy=True))
    np.testing.assert_array_equal(got.numpy(), want)
    srv = RunaheadServer(cfg, params, n_slots=2, context=S_PROMPT + N_2F)
    single = {c.rid: c.tokens for c in srv.run(_requests_2f(prompt))}
    assert [single[f"g{i}"] for i in range(2)] == want.tolist()
    for got in _meshed()[1][arch]:
        assert got["streams"] == single
