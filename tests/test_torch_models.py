"""The port's dense model against the JAX package's, on the same weights.

Reduced qwen3-4b (GQA 4:1, qk-norm, SwiGLU), weights from the JAX
``init_params`` carried across by ``repro_torch.convert.params_from_jax``.
Tolerances on the logits (std ~0.2 at this size):
  * compute float32: atol=rtol=1e-5 (f32 sums in another order);
  * compute bfloat16: atol=8e-3, four bf16 ulps of a logit near 0.3 (the
    logits leave the bf16 unembed product rounded to bf16, and the two
    frameworks round bf16 intermediates at different places); the bf16
    K cache holds roped qk-normed values up to ~2, so it gets atol=2e-2,
    two bf16 ulps in [1, 2) (rope's cancellations leave small entries
    with their inputs' absolute error).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import decode, testing, transformer
import torch_one_thread  # noqa: F401 (one torch thread)

ARCH = "qwen3-4b"
S, CONTEXT, N_DECODE = 6, 12, 3
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=8e-3, rtol=0.0)}
CACHE_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(atol=2e-2, rtol=0.0)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def model():
    cfg = jtesting.reduced_config(ARCH)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, S + N_DECODE)).astype(np.int32)
    return testing.reduced_config(ARCH), jparams, params, tokens


def test_configs_match_jax_field_for_field():
    for arch in registry.ARCH_IDS:
        assert (dataclasses.asdict(registry.get_config(arch))
                == dataclasses.asdict(jregistry.get_config(arch))), arch
        assert (dataclasses.asdict(testing.reduced_config(arch))
                == dataclasses.asdict(jtesting.reduced_config(arch))), arch
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert (dataclasses.asdict(registry.get_config("paper-bisection"))
            == dataclasses.asdict(jregistry.get_config("paper-bisection")))


def test_params_cross_bit_for_bit_and_init_shapes_match(model):
    cfg, jparams, params, _ = model
    jbf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jnp.bfloat16), jax.device_get(jparams))
    leaves = jax.tree_util.tree_leaves(params_from_jax(jbf16, "cpu"))
    jleaves = jax.tree_util.tree_leaves(jbf16)
    assert len(jleaves) == len(leaves)
    for j, t in zip(jleaves, leaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))
    own = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), torch.float32)
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(model, dtype):
    cfg, jparams, params, tokens = model
    jdt, tdt = DTYPES[dtype]
    tol = TOL[dtype]
    jlogits, jcache = jdecode.prefill(cfg, jparams, jnp.asarray(tokens[:, :S]),
                                      CONTEXT, compute_dtype=jdt)
    logits, cache = decode.prefill(cfg, params, torch.from_numpy(tokens[:, :S]),
                                   CONTEXT, compute_dtype=tdt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    np.testing.assert_allclose(
        cache[0]["kv"].k.float().numpy(),
        np.asarray(jcache[0]["kv"].k.astype(jnp.float32)), **CACHE_TOL[dtype])
    for pos in range(S, S + N_DECODE):
        jlogits, jcache = jdecode.decode_step(
            cfg, jparams, jnp.asarray(tokens[:, pos]), jnp.int32(pos), jcache,
            compute_dtype=jdt)
        logits, cache = decode.decode_step(
            cfg, params, torch.from_numpy(tokens[:, pos]), pos, cache,
            compute_dtype=tdt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plus_decode_matches_own_forward(model, dtype):
    """A short prefill then decode steps reproduce the full-sequence
    forward at every decoded position (atol 1e-4 at bf16, as the JAX
    package's own test holds it)."""
    cfg, _, params, tokens = model
    tdt = DTYPES[dtype][1]
    atol = TOL["float32"]["atol"] if dtype == "float32" else 1e-4
    toks = torch.from_numpy(tokens)
    full, aux = transformer.forward(cfg, params, toks, compute_dtype=tdt)
    assert float(aux) == 0.0
    logits, cache = decode.prefill(cfg, params, toks[:, :S], CONTEXT,
                                   compute_dtype=tdt)
    np.testing.assert_allclose(logits.numpy(), full[:, S - 1].numpy(),
                               atol=atol, rtol=0)
    for pos in range(S, S + N_DECODE - 1):
        logits, cache = decode.decode_step(cfg, params, toks[:, pos], pos,
                                           cache, compute_dtype=tdt)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                                   atol=atol, rtol=0)


def test_ring_fill_wraps_like_jax():
    kv = np.random.default_rng(3).normal(size=(2, 7, 1, 4)).astype(np.float32)
    for cap in (7, 9, 4):
        np.testing.assert_array_equal(
            decode._ring_fill(torch.from_numpy(kv), cap).numpy(),
            np.asarray(jdecode._ring_fill(jnp.asarray(kv), cap)))


def test_unported_paths_raise():
    # every family is ported for serving (MoE: tests/test_torch_moe.py,
    # xlstm and hymba: tests/test_torch_recurrent.py, whisper:
    # tests/test_torch_whisper.py) and for training (hymba, xlstm and
    # whisper: tests/test_torch_train_families.py): a step builds, and
    # mesh-native serving runs (tests/test_torch_mesh_serving.py).  What
    # still raises is speculative decoding under a mesh, and an enc-dec
    # forward without its frames, as JAX's asserts
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.train.step import TrainConfig, make_train_step

    for arch in ("hymba-1.5b", "whisper-tiny"):
        assert callable(make_train_step(testing.reduced_config(arch),
                                        TrainConfig(), lambda step: step))
    cfg = testing.reduced_config("whisper-tiny")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.float32)
    with pytest.raises(ValueError, match="encoder_frames"):
        transformer.forward(cfg, params, torch.zeros((1, 4), dtype=torch.long))
    mesh = parse_mesh("1x1")
    assert ContinuousScheduler(cfg, params, n_slots=2, context=8,
                               mesh=mesh).n_local == 2
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousScheduler(cfg, params, n_slots=2, context=8, mesh=mesh,
                            draft_len=2)
