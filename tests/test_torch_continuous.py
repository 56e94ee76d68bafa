"""The port's continuous batching over the dense ring and the paged KV
cache (allocator, per-slot sampler, per-slot and paged decode, K6's plain
version, scheduler and server) against the JAX package's, on the CPU,
at ``reduced_config("qwen3-4b")`` with the JAX ``init_params`` weights.

Tolerances and why:
  * the allocator, plan geometry and page tables are host Python: equal;
  * ``sample_slots`` row b against a B=1 ``sample`` with that slot's
    config and noise: the masked logits and tokens bit for bit (the same
    solves on the same row); against JAX's pipeline: masks equal, values
    within rtol 1e-5 (mass and entropy sums in another order);
  * per-slot ``decode_step`` and ``decode_step_paged`` (gather) against
    JAX's at float32 compute: atol = rtol = 1e-5 on the logits (f32 sums
    in another order);
  * the paged gather path against the port's own dense ring, and prefill
    skip against cold prefill: bit for bit, at the serving dtype (bf16)
    as JAX's tests hold them.  (At float32 a one-row suffix goes through
    another matmul kernel than the full prompt and can round an ulp
    apart; at bf16 both round to the same bf16 values.)
  * K6's plain version against JAX ``paged_attend(interpret=True)``:
    rtol = atol = 1e-5 in f32, the JAX test's own, and 1e-2 for bf16
    inputs compared in f32 (bf16 rounding of the output); its split
    version (the kernel's split-chain merge, any ``n_split``) at the same
    f32 tolerance (the merge reorders the sums);
  * token streams: greedy, on a workload screened for ties (every step's
    top-1/top-2 logit gap above 10x the bf16 tolerance 2**-6 * max|logit|
    along JAX's own one-shot stream), equal to JAX's streams, dense and
    paged, and to one-shot streams per request.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import tuning
from repro.kernels.paged_attend import paged_attend as jpaged_attend
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.serving import paged as jpaged
from repro.serving import sampler as jsampler
from repro.serving import server as jserver
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attend as pa
from repro_torch.launch import serve
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import decode, testing
from repro_torch.serving import paged, sampler
from repro_torch.serving.draft import RepeatLastDrafter
from repro_torch.serving.sampler import SamplerConfig, SlotSamplers
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import (
    Request,
    RunaheadServer,
    generate_oneshot_reference,
)
import torch_one_thread  # noqa: F401 (one torch thread)

ARCH = "qwen3-4b"
CONTEXT = 24
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fixed_decisions():
    """JAX's solves run the caller's (rounds, spec_k), the only behaviour
    the port has."""
    with tuning.disabled():
        yield


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3-4b, JAX weights in both packages; the unembedding is
    sharpened toward a fixed successor of the current token (2x a
    row-permuted copy of the embedding table), which opens wide greedy
    margins for the stream tests."""
    cfg = jtesting.reduced_config(ARCH)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    perm = np.random.default_rng(1).permutation(cfg.vocab)
    jparams["unembed"] = jparams["unembed"] + 2.0 * jparams["embed"][perm].T
    params = params_from_jax(jax.device_get(jparams), "cpu")
    return testing.reduced_config(ARCH), jparams, params


# ---------------------------------------------------------------------------
# allocator and chain geometry (host Python, a copy of the JAX module)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,n_new,context,page,draft",
                         [(10, 6, 32, 4, 1), (10, 6, 32, 4, 4),
                          (10, 40, 32, 4, 1), (12, 4, 32, 4, 1),
                          (13, 4, 32, 4, 1), (8, 1, 32, 4, 1),
                          (544, 32, 544, 16, 1)])
def test_plan_chain_matches_jax(prompt, n_new, context, page, draft):
    assert (dataclasses.asdict(paged.plan_chain(prompt, n_new, context, page,
                                                draft))
            == dataclasses.asdict(jpaged.plan_chain(prompt, n_new, context,
                                                    page, draft)))
    assert paged.pages_for(12, 5) == jpaged.pages_for(12, 5) == 3
    assert paged.prefix_key([3, 1, 4], 2) == (3, 1)


def test_mask_table_rows_matches_jax():
    table = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    active = np.asarray([True, False, True])
    np.testing.assert_array_equal(
        decode.mask_table_rows(torch.from_numpy(table),
                               torch.from_numpy(active)).numpy(),
        np.asarray(jdecode.mask_table_rows(jnp.asarray(table),
                                           jnp.asarray(active))))


def test_allocator_invariants():
    a = paged.PageAllocator(8, 4)
    got = [a.alloc() for _ in range(10)]
    assert 0 not in got and got[7:] == [None] * 3
    for p in got[:7]:
        a.decref(p)
    with pytest.raises(ValueError, match="double free"):
        a.decref(got[0])
    with pytest.raises(ValueError, match="dead page"):
        a.incref(2)
    chain = [a.alloc(), a.alloc()]
    a.register_prefix(("k",), chain[0])
    a.register_prefix(("k",), chain[1])           # first writer wins
    assert a.lookup_prefix(("k",)) == chain[0]
    forked = a.fork_prefix(chain)
    assert a.refcount(chain[0]) == 2
    a.release(forked)
    a.release(chain)
    assert a.n_used == 0 and a.lookup_prefix(("k",)) is None
    assert a.peak_used == 7


def _fuzz_differential(seed: int, steps: int) -> None:
    """One random alloc / release / register / fork walk driven through
    the port's allocator and JAX's side by side: the same ids, refcounts,
    free lists and lookups after every op, and the invariants of the JAX
    suite (no leak, no double free, refcounts == live references)."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(2, 20))
    mine, ref = paged.PageAllocator(n_pages, 4), jpaged.PageAllocator(
        n_pages, 4)
    chains: list[list[int]] = []
    keys: list[tuple] = []
    for step in range(steps):
        op = int(rng.integers(0, 4))
        if op == 0:
            chain = []
            for _ in range(int(rng.integers(1, 4))):
                pid = mine.alloc()
                assert pid == ref.alloc()
                if pid is None:
                    break
                chain.append(pid)
            if chain:
                chains.append(chain)
        elif op == 1 and chains:
            chain = chains.pop(int(rng.integers(len(chains))))
            mine.release(chain)
            ref.release(chain)
        elif op == 2 and chains:
            pid = chains[int(rng.integers(len(chains)))][0]
            mine.register_prefix(("k", step), pid)
            ref.register_prefix(("k", step), pid)
            keys.append(("k", step))
        elif op == 3 and keys:
            key = keys[int(rng.integers(len(keys)))]
            pid = mine.lookup_prefix(key)
            assert pid == ref.lookup_prefix(key)
            if pid is not None:
                chains.append(mine.fork_prefix([pid]))
                ref.fork_prefix([pid])
        live: dict[int, int] = {}
        for chain in chains:
            for pid in chain:
                live[pid] = live.get(pid, 0) + 1
        assert mine._free == ref._free
        assert mine.n_used == len(live) and 0 not in live
        assert mine.n_used + mine.n_free == n_pages - 1
        for pid in range(n_pages):
            assert mine.refcount(pid) == ref.refcount(pid) == live.get(pid, 0)
    for chain in chains:
        mine.release(chain)
    assert mine.n_used == 0 and mine.n_free == n_pages - 1


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 2024])
def test_allocator_fuzz_against_jax(seed):
    _fuzz_differential(seed, 200)


@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
@settings(max_examples=40, deadline=None)
def test_allocator_fuzz_property(seed):
    _fuzz_differential(seed, 60)


# ---------------------------------------------------------------------------
# per-slot sampler
# ---------------------------------------------------------------------------

SLOT_CONFIGS = [dict(top_k=12), dict(top_p=0.9, temperature=0.7),
                dict(target_entropy=2.0), dict(top_k=8, top_p=0.95),
                dict(greedy=True), dict()]


def _slot_logits(rows=len(SLOT_CONFIGS), vocab=300, seed=0):
    return (np.random.default_rng(seed).normal(size=(rows, vocab)) * 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("uniform_k", [False, True])
def test_sample_slots_rows_equal_b1_sample(backend, uniform_k):
    """Row b of sample_slots is a B=1 ``sample`` with slot b's config and
    noise: masked logits and tokens bit for bit, with a mixed per-row k
    (the engine's count solve, K2's plain version under "hopper") and
    with a static k (the fused K3 path)."""
    confs = [dict(c, top_k=12) if uniform_k and not c.get("greedy") else c
             for c in SLOT_CONFIGS]
    scs = [SamplerConfig(backend=backend, **c) for c in confs]
    logits = torch.from_numpy(_slot_logits())
    noise = -torch.log(-torch.log(torch.from_numpy(
        np.random.default_rng(1).uniform(1e-6, 1.0, logits.shape)
        .astype(np.float32))))
    slots = SlotSamplers.stack(scs, "cpu")
    from repro_torch.serving.scheduler import _enable_bits, _static_top_k
    kw = dict(spec_k=5, rounds=8, backend=backend, enable=_enable_bits(scs),
              top_k_static=_static_top_k(scs))
    assert (kw["top_k_static"] == 12) == uniform_k
    z = sampler._masked_slot_logits(logits, slots, **kw)
    tok = sampler.sample_slots(logits, [None] * len(scs), slots, noise=noise,
                               **kw)
    for b, sc in enumerate(scs):
        want = sampler.masked_logits(logits[b:b + 1], sc)
        if sc.greedy:                 # greedy rows only keep the argmax
            assert int(z[b].argmax()) == int(want[0].argmax())
        else:
            assert torch.equal(z[b:b + 1], want), b
        assert int(tok[b]) == int(sampler.sample(
            logits[b:b + 1], None, sc, noise=noise[b:b + 1])[0]), b


def test_sample_slots_generators_draw_the_b1_stream():
    """A slot's generator gives the same (1, V) draw as ``sample`` with a
    generator seeded alike, and greedy or idle rows draw nothing."""
    scs = [SamplerConfig(top_k=12), SamplerConfig(greedy=True),
           SamplerConfig(top_p=0.8)]
    logits = torch.from_numpy(_slot_logits(rows=3))
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    from repro_torch.serving.scheduler import _enable_bits, _static_top_k
    got = sampler.sample_slots(
        logits, [gens[0], None, gens[2]], SlotSamplers.stack(scs, "cpu"),
        enable=_enable_bits(scs), top_k_static=_static_top_k(scs))
    untouched = gens[1].get_state()
    for b, sc in enumerate(scs):
        ref = torch.Generator().manual_seed((3, 4, 5)[b])
        assert int(got[b]) == int(sampler.sample(logits[b:b + 1], ref, sc)[0])
    assert torch.equal(gens[1].get_state(), untouched)


def test_masked_slot_logits_match_jax():
    scs = [SamplerConfig(**c) for c in SLOT_CONFIGS]
    jscs = [jsampler.SamplerConfig(**c) for c in SLOT_CONFIGS]
    logits = _slot_logits(seed=3)
    from repro_torch.serving.scheduler import _enable_bits
    en = _enable_bits(scs)
    got = sampler._masked_slot_logits(
        torch.from_numpy(logits), SlotSamplers.stack(scs, "cpu"), spec_k=5,
        rounds=8, backend="torch", enable=en, top_k_static=None).numpy()
    want = np.asarray(jsampler._masked_slot_logits(
        jnp.asarray(logits), jsampler.SlotSamplers.stack(jscs), spec_k=5,
        rounds=8, backend="jnp", enable=en, top_k_static=None))
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="uniform"):
        SlotSamplers.stack([SamplerConfig(), SamplerConfig(spec_k=3)], "cpu")


# ---------------------------------------------------------------------------
# per-slot and paged decode
# ---------------------------------------------------------------------------

PROMPTS = [[5, 3, 8, 2, 6], [9, 1, 4, 1, 5, 9, 2, 6]]
STEP_TOKENS = [[7, 11], [3, 200], [42, 17]]


def _jax_slotted(cfg, jparams, dtype):
    cache = jdecode.init_cache(cfg, 2, CONTEXT, dtype)
    for slot, prompt in enumerate(PROMPTS):
        _, cache = jdecode.prefill_into_slot(
            cfg, jparams, jnp.asarray([prompt], jnp.int32), CONTEXT, cache,
            slot, compute_dtype=dtype, kv_dtype=dtype)
    return cache


def _chains(page):
    n = paged.pages_for(CONTEXT, page)
    return [list(range(1, n + 1)), list(range(n + 1, 2 * n + 1))], n


def _table(chains, n):
    return np.asarray([c + [0] * (n - len(c)) for c in chains], np.int32)


def test_per_slot_and_paged_decode_match_jax(model):
    """Two slots at their own depths (prompts of 5 and 8 tokens), three
    steps, float32 compute: port against JAX for the dense ring and the
    paged gather path; the port's gather equals its dense ring bit for
    bit and its K6 path (plain version) within 1e-5."""
    cfg, jparams, params = model
    f32 = torch.float32
    jcache = _jax_slotted(cfg, jparams, jnp.float32)
    cache = decode.init_cache(cfg, 2, CONTEXT, f32, device="cpu")
    P = 4
    chains, n = _chains(P)
    jpool = jdecode.init_paged_pool(cfg, 2 * n + 1, P, jnp.float32)
    pools = {impl: decode.init_paged_pool(cfg, 2 * n + 1, P, f32,
                                          device="cpu")
             for impl in ("gather", "hopper")}
    for slot, prompt in enumerate(PROMPTS):
        tok = torch.tensor([prompt])
        _, cache = decode.prefill_into_slot(cfg, params, tok, CONTEXT, cache,
                                            slot, compute_dtype=f32)
        _, jpool = jdecode.paged_prefill(
            cfg, jparams, jnp.asarray([prompt], jnp.int32), CONTEXT, jpool,
            jnp.asarray(chains[slot], jnp.int32), page_size=P,
            compute_dtype=jnp.float32)
        for impl, pool in pools.items():
            decode.paged_prefill(cfg, params, tok, CONTEXT, pool,
                                 torch.tensor(chains[slot]), page_size=P,
                                 compute_dtype=f32)
    table = _table(chains, n)
    pos = np.asarray([len(p) for p in PROMPTS])
    for toks in STEP_TOKENS:
        jtok = jnp.asarray(toks, jnp.int32)
        jpos = jnp.asarray(pos, jnp.int32)
        want, jcache = jdecode.decode_step(cfg, jparams, jtok, jpos, jcache,
                                           compute_dtype=jnp.float32)
        jwant, jpool = jdecode.decode_step_paged(
            cfg, jparams, jtok, jpos, jpool, jnp.asarray(table),
            context=CONTEXT, compute_dtype=jnp.float32)
        tok, tpos = torch.tensor(toks), torch.from_numpy(pos)
        got, cache = decode.decode_step(cfg, params, tok, tpos, cache,
                                        compute_dtype=f32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        paged_out = {
            impl: decode.decode_step_paged(
                cfg, params, tok, tpos, pool, torch.from_numpy(table),
                context=CONTEXT, compute_dtype=f32, impl=impl)[0]
            for impl, pool in pools.items()}
        np.testing.assert_allclose(paged_out["gather"].numpy(),
                                   np.asarray(jwant), **F32)
        assert torch.equal(paged_out["gather"], got)
        torch.testing.assert_close(paged_out["hopper"], got, **F32)
        pos = pos + 1


@pytest.mark.parametrize("page_size", [4, 5])
def test_gather_path_bit_equal_to_dense(model, page_size):
    """On a chain holding the same rows, the paged gather decode step
    gives the dense slotted step's logits bit for bit (bf16, the serving
    dtype, as the JAX test holds it)."""
    cfg, _, params = model
    prompt = torch.tensor([[5, 3, 8, 2, 6, 1, 9]])
    S = prompt.shape[1]
    dense = decode.init_cache(cfg, 1, CONTEXT, torch.bfloat16, device="cpu")
    dlogits, dense = decode.prefill_into_slot(cfg, params, prompt, CONTEXT,
                                              dense, 0)
    chain_len = paged.pages_for(
        paged.plan_chain(S, 4, CONTEXT, page_size).n_positions, page_size)
    pool = decode.init_paged_pool(cfg, chain_len + 1, page_size,
                                  torch.bfloat16, device="cpu")
    chain = torch.arange(1, chain_len + 1)
    plogits, pool = decode.paged_prefill(cfg, params, prompt, CONTEXT, pool,
                                         chain, page_size=page_size)
    assert torch.equal(dlogits, plogits)
    table = torch.zeros((1, paged.pages_for(CONTEXT, page_size)),
                        dtype=torch.int32)
    table[0, :chain_len] = chain.int()
    tok, pos = torch.tensor([7]), torch.tensor([S])
    dstep, _ = decode.decode_step(cfg, params, tok, pos, dense)
    pstep, _ = decode.decode_step_paged(cfg, params, tok, pos, pool, table,
                                        context=CONTEXT)
    assert torch.equal(dstep, pstep)


def test_prefill_skip_bit_equal_to_cold(model):
    """Suffix prefill over cached prefix pages gives the cold prefill's
    first-token logits bit for bit (bf16, the serving dtype)."""
    cfg, _, params = model
    P = 4
    prompt = torch.tensor([list(range(1, 13)) + [77]])
    chain_len = paged.pages_for(
        paged.plan_chain(prompt.shape[1], 4, CONTEXT, P).n_positions, P)
    pool = decode.init_paged_pool(cfg, 2 * chain_len + 1, P, torch.bfloat16,
                                  device="cpu")
    chain = torch.arange(1, chain_len + 1)
    cold, pool = decode.paged_prefill(cfg, params, prompt, CONTEXT, pool,
                                      chain, page_size=P)
    chain2 = torch.cat([chain[:3], torch.arange(chain_len + 1,
                                                2 * chain_len - 2)])
    warm, pool = decode.paged_prefill(cfg, params, prompt, CONTEXT, pool,
                                      chain2, page_size=P, skip=3)
    assert torch.equal(cold, warm)
    with pytest.raises(ValueError, match="suffix must recompute"):
        decode.paged_prefill(cfg, params, prompt[:, :12], CONTEXT, pool,
                             chain2, page_size=P, skip=3)


def _paged_state(seed, n_pages, P, nkv, hd, B, L, nq, chain_len):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((n_pages, P, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, P, nkv, hd)).astype(np.float32)
    perm = rng.permutation(n_pages - 1)[:B * chain_len] + 1
    table = perm.reshape(B, chain_len).astype(np.int32)
    q = rng.standard_normal((B, L, nq, hd)).astype(np.float32)
    return pk, pv, table, q


K6_CASES = {
    # (P, C): page sizes that divide (4 | 8) and don't (5, 3), rows below
    # and past the wrap point; L = 4 verify positions, n_rep 2
    "P4C8": (4, 8, 2, 16, 4, 4, [2, 6, 11]),
    "P5C8": (5, 8, 2, 16, 4, 4, [2, 6, 11]),
    "P3C10": (3, 10, 2, 16, 4, 4, [2, 8, 13]),
    # n_rep 3 and L = 1, the serial decode shape
    "gqa_L1": (4, 8, 2, 8, 1, 6, [3, 7]),
    # the served geometry at a small chain: n_rep 4, head_dim 128, P 16
    "served": (16, 40, 2, 128, 1, 8, [5, 39, 45]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_plain_matches_pallas_interpret(case, dtype):
    P, C, nkv, hd, L, nq, pos = K6_CASES[case]
    B = len(pos)
    chain_len = paged.pages_for(C, P)
    pk, pv, table, q = _paged_state(0, B * chain_len + 1, P, nkv, hd, B, L,
                                    nq, chain_len)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jargs = [jnp.asarray(a).astype(jdt) for a in (pk, pv)] + [
        jnp.asarray(table), jnp.asarray(pos, jnp.int32),
        jnp.asarray(q).astype(jdt)]
    want = np.asarray(jpaged_attend(*jargs, context=C, interpret=True)
                      .astype(jnp.float32))
    targs = [torch.from_numpy(a).to(tdt) for a in (pk, pv)] + [
        torch.from_numpy(table), torch.tensor(pos, dtype=torch.int32),
        torch.from_numpy(q).to(tdt)]
    got = pa.paged_attend_plain(*targs, context=C)
    assert got.dtype == tdt and got.shape == (B, L, nq, hd)
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the wrapper takes the plain version on the CPU
    ops.reset_launches()
    assert torch.equal(ops.paged_attend(*targs, context=C), got)
    assert ops.LAUNCHES["paged_attend"] == 0


# (P, C, n_kv, hd, L, n_heads, positions, live pages per row): a page
# size that does not divide the context (5 | 12), L = 3 verify positions
# with a row that wraps and a row that sees page 0 only, so later splits
# hold only masked rows; and a chain whose tail names the null page
K6_SPLIT_CASES = {
    "P5C12_L3": (5, 12, 2, 16, 3, 4, [1, 9, 14], None),
    "null_tail": (4, 16, 2, 8, 1, 4, [5, 6], 2),
}


@functools.cache
def _k6_split_case(case):
    P, C, nkv, hd, L, nq, pos, live = K6_SPLIT_CASES[case]
    B, chain_len = len(pos), paged.pages_for(C, P)
    pk, pv, table, q = _paged_state(5, B * chain_len + 1, P, nkv, hd, B, L,
                                    nq, chain_len)
    if live is not None:
        table[:, live:] = 0
    want = np.asarray(jpaged_attend(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(pos, jnp.int32), jnp.asarray(q), context=C,
        interpret=True))
    return [torch.from_numpy(a) for a in (pk, pv, table)] + [
        torch.tensor(pos, dtype=torch.int32), torch.from_numpy(q)], want


@pytest.mark.parametrize("n_split", [1, 2, 3, "chain"])
@pytest.mark.parametrize("case", list(K6_SPLIT_CASES))
def test_k6_split_plain_matches_pallas_interpret(case, n_split):
    """The kernel's split-and-merge, mirrored by the plain version, at
    split counts up to one page per split: splits whose pages are all
    masked or null weigh exactly 0."""
    args, want = _k6_split_case(case)
    C = K6_SPLIT_CASES[case][1]
    n = args[2].shape[1] if n_split == "chain" else n_split
    got = pa.paged_attend_plain(*args, context=C, n_split=n)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert torch.isfinite(got).all()


def test_k6_masks_the_null_page_exactly():
    """A slot whose chain is shorter than the table row: the tail entries
    name the null page, whose contents must not reach the output."""
    P, C, nkv, hd = 4, 16, 2, 8
    pk, pv, table, q = _paged_state(3, 9, P, nkv, hd, 2, 1, 4, 4)
    table[:, 2:] = 0                  # two live pages, then the null page
    pos = torch.tensor([5, 6], dtype=torch.int32)
    args = [torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(table), pos, torch.from_numpy(q)]
    out = pa.paged_attend_plain(*args, context=C)
    args[0][0] = 1e4                  # poison the null page
    args[1][0] = -1e4
    assert torch.equal(pa.paged_attend_plain(*args, context=C), out)


# ---------------------------------------------------------------------------
# scheduler and server
# ---------------------------------------------------------------------------

S_PROMPT = 6
MAX_NEW = 7


@pytest.fixture(scope="module")
def screened(model):
    """Five prompts from 64 candidates (np.random.default_rng(7)) whose
    every greedy step, along JAX's own bf16 one-shot stream, has a
    top-1/top-2 logit gap above 10x the bf16 tolerance."""
    cfg, jparams, _ = model
    cand = np.random.default_rng(7).integers(
        0, cfg.vocab, size=(64, S_PROMPT)).astype(np.int32)
    lg, cache = jdecode.prefill(cfg, jparams, jnp.asarray(cand),
                                S_PROMPT + MAX_NEW)
    ok = np.ones(64, bool)
    for i in range(MAX_NEW):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        ok &= top2[:, 1] - top2[:, 0] > 10 * 2.0 ** -6 * np.abs(lg).max(-1)
        if i < MAX_NEW - 1:
            lg, cache = jdecode.decode_step(
                cfg, jparams, jnp.asarray(lg.argmax(-1), jnp.int32),
                jnp.int32(S_PROMPT + i), cache)
    rows = np.flatnonzero(ok)[:5]
    assert len(rows) == 5
    return [cand[r].tolist() for r in rows]


def _greedy_requests(prompts):
    """Staggered arrivals and budgets from 1 (done at admission) to 7:
    on two slots this queues and recycles."""
    n_new = [5, 3, 1, 7, 4]
    return [Request(f"r{i}", p, n_new[i], seed=10 + i,
                    sampler=SamplerConfig(greedy=True), arrival=i // 2)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def jax_streams(model, screened):
    """JAX's continuous greedy streams of the screened workload, dense and
    paged (page size 4)."""
    cfg, jparams, _ = model
    out = []
    for page_size in (None, 4):
        srv = jserver.RunaheadServer(cfg, jparams, n_slots=2,
                                     context=CONTEXT, page_size=page_size)
        reqs = [jserver.Request(r.rid, r.prompt, r.n_new, seed=r.seed,
                                sampler=jsampler.SamplerConfig(greedy=True),
                                arrival=r.arrival)
                for r in _greedy_requests(screened)]
        out.append({c.rid: c.tokens for c in srv.run(reqs)})
    return out


@pytest.mark.parametrize("mode", ["dense", "gather", "hopper"])
def test_greedy_streams_match_jax_and_oneshot(model, screened, jax_streams,
                                              mode):
    """Port continuous streams (dense ring; paged gather; paged K6 plain)
    equal JAX's continuous streams (dense and paged) and the port's
    one-shot stream per request."""
    cfg, _, params = model
    jdense, jpaged_ = jax_streams
    assert jdense == jpaged_
    kw = {} if mode == "dense" else dict(page_size=4, page_impl=mode)
    reqs = _greedy_requests(screened)
    srv = RunaheadServer(cfg, params, n_slots=2, context=CONTEXT, **kw)
    done = srv.run(reqs)
    got = {c.rid: c.tokens for c in done}
    assert got == jdense
    assert any(c.queue_steps > 0 for c in done)
    for r in reqs:
        assert got[r.rid] == generate_oneshot_reference(cfg, params, r,
                                                        context=CONTEXT)
        assert len(got[r.rid]) == r.n_new
    s = srv.scheduler
    assert s.n_host_syncs == s.n_decode_steps + s.n_admissions
    if mode != "dense":
        assert s.alloc.n_used == 0            # every page came back


def _sampled_workload(backend="hopper"):
    sc = lambda **kw: SamplerConfig(backend=backend, **kw)
    return [
        Request("a", [1, 2, 3, 4], 5, seed=11, sampler=sc(top_k=12)),
        Request("b", [9, 8, 7, 6, 5], 3, seed=22, sampler=sc(top_p=0.9)),
        Request("c", [4, 4, 4], 1, seed=33, sampler=sc(temperature=0.7),
                arrival=1),
        Request("d", [2, 3, 5, 7, 11, 13], 8, seed=44,
                sampler=sc(target_entropy=2.0), arrival=2),
        Request("e", [6, 6], 6, seed=55, sampler=sc(greedy=True), arrival=4),
    ]


def _serve(cfg, params, reqs, n_slots=2, backend="hopper", **kw):
    srv = RunaheadServer(cfg, params, context=CONTEXT, n_slots=n_slots,
                         backend=backend, **kw)
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    return {c.rid: c.tokens for c in srv.drain()}, srv.scheduler


def test_sampled_paged_equals_dense_and_pool_exhaustion_queues(model):
    """Heterogeneous sampled requests: the paged gather path serves the
    dense path's streams bit for bit (same batch, same reductions), also
    from a pool too small for two worst-case requests at once, which
    parks requests and completes everything as pages free."""
    cfg, _, params = model
    reqs = _sampled_workload()
    dense, _ = _serve(cfg, params, reqs)
    again, _ = _serve(cfg, params, reqs)
    assert dense == again
    assert {r: len(t) for r, t in dense.items()} == {
        r.rid: r.n_new for r in reqs}
    paged_, _ = _serve(cfg, params, reqs, page_size=4)
    assert paged_ == dense
    small, sch = _serve(cfg, params, reqs, page_size=4, cache_pages=9)
    assert small == dense
    assert sch.alloc.n_used == 0


PRE = list(range(1, 13))                      # 12-token shared prefix


def test_shared_prefix_allocates_once_skips_prefill_and_never_mutates(model):
    cfg, _, params = model
    reqs = [Request(f"s{i}", PRE + [50 + i], 6, seed=7 + i)
            for i in range(3)]
    dense, _ = _serve(cfg, params, reqs, n_slots=3, backend="torch")
    srv = RunaheadServer(cfg, params, n_slots=3, context=CONTEXT,
                         page_size=4)
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    srv._admit_pending()
    sch = srv.scheduler
    assert sch.n_prefix_hits == 2 and sch.n_prefill_skipped == 2 * 3 * 4
    chains = [c for c in sch._chains if c is not None]
    shared = chains[0][:3]
    for c in chains[1:]:
        assert c[:3] == shared and not set(shared) & set(c[3:])
    assert all(sch.alloc.refcount(p) == 3 for p in shared)
    ids = torch.tensor(shared)
    snap = [(e["kv"].k[:, ids].clone(), e["kv"].v[:, ids].clone())
            for e in sch.pool]
    got = {c.rid: c.tokens for c in srv.drain()}
    assert got == dense                        # prefill skip, same streams
    for e, (k0, v0) in zip(sch.pool, snap):
        assert torch.equal(e["kv"].k[:, ids], k0)
        assert torch.equal(e["kv"].v[:, ids], v0)
    assert sch.alloc.n_used == 0


def test_inactive_dense_lanes_come_out_bit_unchanged(model):
    cfg, _, params = model
    sch = ContinuousScheduler(cfg, params, n_slots=3, context=CONTEXT)
    assert sch.admit("x", [1, 2, 3], 4, seed=0)
    before = [(e["kv"].k.clone(), e["kv"].v.clone()) for e in sch.cache]
    sch.step()
    for e, (k0, v0) in zip(sch.cache, before):
        assert torch.equal(e["kv"].k[:, 1:], k0[:, 1:])
        assert torch.equal(e["kv"].v[:, 1:], v0[:, 1:])
        assert not torch.equal(e["kv"].k[:, 0], k0[:, 0])


def test_rejections(model):
    cfg, _, params = model
    srv = RunaheadServer(cfg, params, n_slots=2, context=CONTEXT,
                         page_size=4, cache_pages=3)
    with pytest.raises(ValueError, match="never succeed"):
        srv.submit(Request("big", list(range(1, 16)), 8, seed=0))
    with pytest.raises(ValueError, match="n_new"):
        srv.submit(Request("z", [1, 2], 0))
    with pytest.raises(ValueError, match="must match"):
        srv.submit(Request("z", [1, 2], 2,
                           sampler=SamplerConfig(backend="hopper")))
    srv.submit(Request("z", [1, 2], 2))        # the failed submits left no trace
    assert [c.rid for c in srv.drain()] == ["z"]
    # speculative decoding and the mesh are ported, together too: these
    # construct (the fused one with the device-capable drafter a fused
    # horizon needs)
    mesh = parse_mesh("1x1")
    for kw in (dict(draft_len=2),
               dict(draft_len=2, step_horizon=4,
                    drafter=RepeatLastDrafter()),
               dict(draft_len=2, mesh=mesh)):
        sch = ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                                  **kw)
        assert sch.draft_len == 2
    assert ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                               mesh=mesh).n_local == 2
    with pytest.raises(ValueError, match="step_horizon"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            step_horizon=0)
    with pytest.raises(ValueError, match="dense"):
        ContinuousScheduler(testing.reduced_config("hymba-1.5b"), params,
                            n_slots=2, context=CONTEXT, page_size=4)
    with pytest.raises(ValueError, match="cache_pages requires"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            cache_pages=16)
    with pytest.raises(ValueError, match="page_impl"):
        ContinuousScheduler(cfg, params, n_slots=2, context=CONTEXT,
                            page_size=4, page_impl="pallas")


@pytest.mark.parametrize("paging", [[], ["--page-size", "4", "--page-impl",
                                         "hopper"]])
def test_serve_continuous_runs_end_to_end_on_cpu(paging):
    ops.reset_launches()
    out = serve.main(["--arch", ARCH, "--reduced", "--continuous",
                      "--requests", "5", "--slots", "2", "--prompt-len", "6",
                      "--new-tokens", "4", "--top-k", "40", "--top-p", "0.9",
                      "--target-entropy", "3.0", "--backend", "hopper",
                      "--device", "cpu"] + paging)
    assert sorted(c.rid for c in out.completions) == list(range(5))
    assert all(2 <= len(c.tokens) <= 4 for c in out.completions)
    assert out.scheduler.n_decode_steps > 0
    assert all(n == 0 for n in ops.LAUNCHES.values())
