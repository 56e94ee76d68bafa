"""The port's sampler, generate loop and serve entry point against the JAX
package's, on the CPU.

The sampler's masks come from count solves and must match exactly; the
masked values (scaled by an entropy-calibrated temperature) within
rtol=1e-5.  Draws use the same Gumbel noise on both sides
(``jax.random.categorical`` is argmax(logits + gumbel)).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as japps
from repro.core import tuning
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import testing
from repro_torch.serving import engine
from repro_torch.serving.sampler import SamplerConfig, masked_logits, sample
import torch_one_thread  # noqa: F401 (one torch thread)

CONFIGS = [dict(top_k=40, top_p=0.9, target_entropy=3.0),
           dict(temperature=0.7, top_k=12),
           dict(top_p=0.8)]
# Greedy workload: reduced qwen3-4b with the unembedding sharpened toward a
# fixed successor of the current token (plus 2x a row-permuted copy of the
# embedding table), and two prompt rows screened from 64 candidates
# (np.random.default_rng(7)) so that every step's top-1/top-2 gap is above
# 10x the bf16 logit tolerance, taken as 2**-6 of the row's largest |logit|
# (four bf16 ulps).
S, N_NEW = 8, 6
GREEDY_ROWS = [6, 7]


@pytest.fixture(autouse=True)
def _fixed_decisions():
    with tuning.disabled():
        yield


def _jax_masked(logits, sc):
    """The JAX sampler's mask pipeline (``repro/serving/sampler.py``)."""
    z = jnp.maximum(logits, jnp.max(logits, axis=-1, keepdims=True) - 80.0)
    kw = dict(spec_k=sc.spec_k, rounds=sc.rounds, backend=sc.backend)
    if sc.target_entropy is not None:
        z = z / japps.entropy_temperature(z, sc.target_entropy, **kw)[:, None]
    elif sc.temperature != 1.0:
        z = z / sc.temperature
    if sc.top_k > 0:
        z = jnp.where(japps.topk_mask(z, sc.top_k, **kw), z, -1e30)
    if sc.top_p > 0.0:
        probs = jax.nn.softmax(z, axis=-1)
        z = jnp.where(japps.topp_mask(probs, sc.top_p, **kw), z, -1e30)
    return z


def _logits(cfg_i):
    return (np.random.default_rng(cfg_i).normal(size=(3, 1000)) * 3.0
            ).astype(np.float32)


@functools.cache
def _jax_sample(cfg_i):
    """JAX's masked logits, Gumbel noise and sampled tokens for a config,
    computed once for both port backends."""
    logits = jnp.asarray(_logits(cfg_i))
    jsc = jsampler.SamplerConfig(backend="jnp", **CONFIGS[cfg_i])
    key = jax.random.PRNGKey(cfg_i)
    with tuning.disabled():
        masked = _jax_masked(logits, jsc)
        tokens = jsampler.sample(logits, key, jsc)
    noise = jax.random.gumbel(key, logits.shape, jnp.float32)
    return np.asarray(masked), np.array(noise), np.asarray(tokens)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("cfg_i", range(len(CONFIGS)))
def test_sample_matches_jax(backend, cfg_i):
    logits = torch.from_numpy(_logits(cfg_i))
    sc = SamplerConfig(backend=backend, **CONFIGS[cfg_i])
    want, noise, jtok = _jax_sample(cfg_i)
    got = masked_logits(logits, sc).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    tok = sample(logits, None, sc, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tok.numpy(), jtok)


@pytest.fixture(scope="module")
def greedy_model():
    cfg = jtesting.reduced_config("qwen3-4b")
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    perm = np.random.default_rng(1).permutation(cfg.vocab)
    jparams["unembed"] = jparams["unembed"] + 2.0 * jparams["embed"][perm].T
    cand = np.random.default_rng(7).integers(0, cfg.vocab, size=(64, S))
    prompt = cand[GREEDY_ROWS].astype(np.int32)
    return cfg, jparams, params_from_jax(jax.device_get(jparams), "cpu"), prompt


def test_greedy_generate_matches_jax_on_screened_workload(greedy_model):
    cfg, jparams, params, prompt = greedy_model
    jsc = jsampler.SamplerConfig(greedy=True)
    want = np.asarray(jengine.generate(cfg, jparams, jnp.asarray(prompt), N_NEW,
                                       jax.random.PRNGKey(0), sampler=jsc))
    # the screen, on JAX's own per-step logits along its stream
    lg, cache = jdecode.prefill(cfg, jparams, jnp.asarray(prompt), S + N_NEW)
    for i in range(N_NEW):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        tol = 2.0 ** -6 * np.abs(lg).max(axis=-1)
        assert np.all(top2[:, 1] - top2[:, 0] > 10 * tol), i
        np.testing.assert_array_equal(lg.argmax(-1), want[:, i])
        if i < N_NEW - 1:
            lg, cache = jdecode.decode_step(cfg, jparams,
                                            jnp.asarray(want[:, i]),
                                            jnp.int32(S + i), cache)
    got = engine.generate(cfg, params, torch.from_numpy(prompt), N_NEW, None,
                          sampler=SamplerConfig(greedy=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_deterministic_and_spends_n_minus_1_steps(
        greedy_model, monkeypatch):
    cfg, _, params, prompt = greedy_model
    calls = []
    real = engine.decode_step

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(engine, "decode_step", counting)
    sc = SamplerConfig(backend="hopper", **CONFIGS[0])
    runs = []
    for n_new in (1, 4, 4):
        calls.clear()
        toks = engine.generate(cfg, params, torch.from_numpy(prompt), n_new,
                               torch.Generator().manual_seed(5), sampler=sc)
        assert toks.shape == (2, n_new)
        assert len(calls) == n_new - 1
        runs.append(toks)
    torch.testing.assert_close(runs[1], runs[2], rtol=0, atol=0)
    torch.testing.assert_close(runs[0], runs[1][:, :1], rtol=0, atol=0)


def test_serve_main_runs_end_to_end_on_cpu():
    ops.reset_launches()
    out = serve.main(["--arch", "qwen3-4b", "--reduced", "--batch", "2",
                      "--prompt-len", "8", "--new-tokens", "4", "--top-k", "40",
                      "--top-p", "0.9", "--target-entropy", "3.0",
                      "--device", "cpu", "--backend", "hopper"])
    vocab = testing.reduced_config("qwen3-4b").vocab
    assert out.tokens.shape == (2, 4)
    assert bool(((out.tokens >= 0) & (out.tokens < vocab)).all())
    # on the CPU the kernels' plain versions run: nothing is launched
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_serve_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.resolve_device("cuda")


def test_sampler_config_mirrors_jax_fields():
    port = {f.name for f in dataclasses.fields(SamplerConfig)}
    ref = {f.name for f in dataclasses.fields(jsampler.SamplerConfig)}
    assert port == ref


def test_serve_defaults_follow_the_device():
    """On the card the kernels carry the path by default (K2-K5 through
    the hopper backend, K6 through the hopper page impl); on the CPU the
    plain torch backend and the gather stay the defaults."""
    card = serve.parse_args(["--continuous", "--page-size", "16"])
    assert (card.device, card.backend, card.page_impl) == (
        "cuda", "hopper", "hopper")
    cpu = serve.parse_args(["--device", "cpu"])
    assert (cpu.backend, cpu.page_impl) == ("torch", "gather")
    chosen = serve.parse_args(["--backend", "torch", "--page-impl", "gather"])
    assert (chosen.backend, chosen.page_impl) == ("torch", "gather")
