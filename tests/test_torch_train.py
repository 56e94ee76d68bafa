"""The port's training slice against the JAX package's: schedules, AdamW,
clipping, data, the train step, checkpoints, the watchdog, the elastic
mesh shape, and kill-and-resume of the launcher.

Inputs come from numpy seeds (or the JAX ``init_params`` carried across
by ``repro_torch.convert``) and go through both packages.  Tolerances:
  * schedules, AdamW and clipping: rtol 1e-6 (f32 elementwise math in
    the same order; pow, cos, sqrt and the norms' sums may round an ulp
    apart between XLA and PyTorch);
  * the quantile clip's bracket: bit for bit on equal norms (counts are
    exact on both backends);
  * the train step on tiny internlm2 at param_dtype float32: loss rtol
    1e-5; the forward computes in bf16 (JAX's ``forward`` default), and
    the two frameworks round bf16 intermediates at other places.  The
    params' change over the steps, per leaf, at l2 rtol 3e-2 (1.5e-1
    with int8 error feedback, where a gradient near a quantisation edge
    moves one level, a whole step); a zero or negated gradient gives 1
    or 2.  Params also atol 1e-4 (5e-4 with int8 error feedback) against
    the 6e-4 that the three steps' lr moves an element;
  * at seq 4096 (K7's path): the remat gradients per leaf at l2 rtol
    2e-2, then two steps at loss rtol 1e-5 and the change at l2 rtol
    3e-2;
  * microbatch equivalence: loss rtol 2e-5, params 2e-5 (JAX's own);
  * remat on and off, resumed and uninterrupted runs, checkpoint round
    trips and the JAX-written checkpoint: bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.core import applications as japplications
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedule as jschedule
from repro.runtime.elastic import derive_mesh_shape as jderive_mesh_shape
from repro.train import step as jstep
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_pytree,
    save_pytree,
)
from repro_torch.convert import adamw_state_from_jax, params_from_jax
from repro_torch.core import applications
from repro_torch.data.pipeline import SyntheticTokens, make_train_iterator
from repro_torch.models import testing
from repro_torch.optim import adamw, clip, schedule
from repro_torch.runtime.elastic import derive_mesh_shape
from repro_torch.runtime.watchdog import StragglerWatchdog
from repro_torch.train import step
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten
import torch_one_thread  # noqa: F401 (one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=128)


def _np_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(dtype),
            "runs": [{"a": rng.standard_normal((3, 5)).astype(dtype)},
                     {"a": (rng.standard_normal(6) * 1e-3).astype(dtype)}],
            "b": (rng.standard_normal(4) * 10).astype(dtype)}


def _torch(tree):
    return params_from_jax(tree, "cpu")


def _close(port_tree, jax_tree, **tol):
    jl = jax.tree.leaves(jax_tree)
    pl = leaves(port_tree)
    assert len(jl) == len(pl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# schedules, AdamW, clipping, data
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    for jfn, fn in [
            (jschedule.cosine_schedule(3e-4, 100),
             schedule.cosine_schedule(3e-4, 100)),
            (jschedule.linear_warmup_cosine(1e-3, 7, 120, min_frac=0.2),
             schedule.linear_warmup_cosine(1e-3, 7, 120, min_frac=0.2))]:
        want = np.array([float(jfn(jnp.int32(s))) for s in steps])
        got = np.array([float(fn(torch.tensor(s, dtype=torch.int32)))
                        for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_adamw_steps_match_jax(compress):
    params = _np_tree(0)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.adamw_init(jparams, compress=compress)
    pparams = _torch(params)
    pstate = adamw.adamw_init(pparams, compress=compress)
    for i in range(3):
        grads = _np_tree(10 + i)
        lr = np.float32(1e-2 * (i + 1))
        jparams, jstate = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jnp.asarray(lr),
            compress=compress, param_dtype=jnp.float32)
        pparams, pstate = adamw.adamw_update(
            _torch(grads), pstate, torch.tensor(lr), compress=compress,
            params=pparams)
        assert int(pstate.step) == int(jstate.step) == i + 1
        for p_tree, j_tree in [(pparams, jparams), (pstate.master,
                               jstate.master), (pstate.mu, jstate.mu),
                               (pstate.nu, jstate.nu)]:
            _close(p_tree, j_tree, rtol=1e-6, atol=1e-7)
        if compress:
            _close(pstate.error, jstate.error, rtol=1e-6, atol=1e-7)
        else:
            assert pstate.error is None


def test_adamw_updates_in_place_and_casts_the_compute_params():
    params = {k: v.to(torch.bfloat16) for k, v in
              _torch({"w": _np_tree(0)["w"], "b": _np_tree(0)["b"]}).items()}
    state = adamw.adamw_init(params)
    master, mu = state.master["w"], state.mu["w"]
    assert master.data_ptr() != params["w"].data_ptr()
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    out, new = adamw.adamw_update(grads, state, torch.tensor(0.1),
                                  params=params)
    assert out is params and new.master["w"] is master and new.mu["w"] is mu
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], master.to(torch.bfloat16))
    assert int(new.step) == 1 and int(state.step) == 0


def test_global_clip_matches_jax():
    grads = _np_tree(1)
    want, jnorm = jclip.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                            1.0)
    got, norm = clip.clip_by_global_norm(_torch(grads), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _close(got, want, rtol=1e-6, atol=0)


def test_quantile_clip_matches_jax():
    grads = _np_tree(2)
    want, jnorms = jclip.clip_by_quantile(jax.tree.map(jnp.asarray, grads),
                                          0.95)
    got, norms = clip.clip_by_quantile(_torch(grads), 0.95)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-6)
    _close(got, want, rtol=1e-6, atol=0)
    # the runahead bracket on equal norms, bit for bit (hopper on the CPU
    # runs K2's plain version; JAX's clip uses its jnp backend)
    n = np.asarray(jnorms)
    jcut = japplications.quantile(jnp.asarray(n), 0.95, spec_k=4, rounds=8)
    cut = applications.quantile(torch.from_numpy(n.copy()), 0.95, spec_k=4,
                                rounds=8, backend="hopper")
    assert np.float32(cut) == np.float32(jcut)


def test_synthetic_tokens_equal_jax_bit_for_bit():
    for kw in (dict(vocab=128, seq_len=32, global_batch=8),
               dict(vocab=92544, seq_len=80, global_batch=4, seed=3,
                    host_count=2, host_id=1)):
        jspec, spec = JSyntheticTokens(**kw), SyntheticTokens(**kw)
        for s in (0, 1, 17):
            a, b = jspec.batch_at(s), spec.batch_at(s)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    it = make_train_iterator(SyntheticTokens(vocab=50, seq_len=8,
                                             global_batch=2), start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  SyntheticTokens(50, 8, 2).batch_at(3)
                                  ["tokens"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_train_config_matches_jax_field_for_field():
    assert (dataclasses.asdict(step.TrainConfig())
            == dataclasses.asdict(jstep.TrainConfig()))


def _setup(**tc_kw):
    jcfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                               **TINY)
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=50, remat=False,
              param_dtype="float32")
    kw.update(tc_kw)
    jtc, tc = jstep.TrainConfig(**kw), step.TrainConfig(**kw)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jtc, jschedule.linear_warmup_cosine(1e-3, 5, 50)))
    fn = step.make_train_step(cfg, tc,
                              schedule.linear_warmup_cosine(1e-3, 5, 50))
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    jopt = jadamw.adamw_init(jparams, compress=tc.compress)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    opt = adamw_state_from_jax(jax.device_get(jopt), "cpu")
    data = JSyntheticTokens(vocab=cfg.vocab, seq_len=32, global_batch=8)
    return jfn, fn, jparams, jopt, params, opt, data


def _batch(data, i):
    return {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}


def _delta_rel(port_tree, port_0, jax_tree, jax_0):
    """Per leaf, |(p - p0) - (j - j0)| / |j - j0| in the l2 norm: how far
    the port's update strays from JAX's, relative to JAX's update.  A
    zero gradient gives about 1 and a negated one about 2."""
    out = []
    for p, p0, j, j0 in zip(leaves(port_tree), leaves(port_0),
                            jax.tree.leaves(jax_tree),
                            jax.tree.leaves(jax_0)):
        dp = p.float().numpy() - p0.float().numpy()
        dj = np.asarray(j, np.float32) - np.asarray(j0, np.float32)
        out.append(np.linalg.norm(dp - dj) / np.linalg.norm(dj))
    return max(out)


@pytest.mark.parametrize("tc_kw,params_atol,delta_rtol", [
    (dict(), 1e-4, 3e-2),
    (dict(clip_mode="quantile"), 1e-4, 3e-2),
    (dict(n_microbatches=4), 1e-4, 3e-2),
    (dict(compress="int8_ef"), 5e-4, 1.5e-1),
])
def test_train_steps_match_jax(tc_kw, params_atol, delta_rtol):
    """Three steps of the tiny internlm2 against JAX's jitted step on the
    same weights and batches: every step's loss, and the params' change
    over the three steps per leaf (step 0 runs at the warm-up's lr 0, so
    the change is steps 1 and 2).  The int8_ef limits are wider: a
    gradient near a quantisation edge moves one level, a whole step, so
    only the change's norm can be held well under a step's."""
    jfn, fn, jparams, jopt, params, opt, data = _setup(**tc_kw)
    jparams0, params0 = jparams, tree_map(torch.clone, params)
    for i in range(3):
        jparams, jopt, jm = jfn(jparams, jopt, jax.tree.map(
            jnp.asarray, data.batch_at(i)))
        params, opt, m = fn(params, opt, _batch(data, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]),
                                   rtol=1e-5)
        assert float(m["lr"]) == float(jm["lr"])
    assert _delta_rel(params, params0, jparams, jparams0) < delta_rtol
    _close(params, jparams, atol=params_atol, rtol=0)
    _close(opt.master, jopt.master, atol=params_atol, rtol=0)
    assert int(opt.step) == 3


def test_train_steps_at_flash_min_seq_match_jax():
    """The slice as a whole at seq 4096, where every layer's attention is
    K7 (its plain version here) with the chunked flash_attend's vjp for a
    backward, against JAX (whose attend runs flash_attend): the remat
    gradients of the loss per leaf at l2 rtol 2e-2 (the forward computes
    in bf16, which the two frameworks round at other places), then two
    train steps with loss rtol 1e-5 and the params' change at l2 rtol
    3e-2."""
    jfn, fn, jparams, jopt, params, opt, _ = _setup(remat=True)
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    jcfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                               **TINY)
    kw = dict(remat=True, param_dtype="float32")
    data = JSyntheticTokens(vocab=TINY["vocab"], seq_len=4096,
                            global_batch=1)
    jgrads = jax.jit(jax.grad(lambda p: jstep.loss_fn(
        jcfg, p, jax.tree.map(jnp.asarray, data.batch_at(0)),
        jstep.TrainConfig(**kw))[0]))(jparams)
    inputs = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = step.loss_fn(cfg, unflatten(params, inputs), _batch(data, 0),
                           step.TrainConfig(**kw))
    for g, jg in zip(torch.autograd.grad(loss, inputs),
                     jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        assert (np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
                < 2e-2)
    jparams0, params0 = jparams, tree_map(torch.clone, params)
    for i in range(2):
        jparams, jopt, jm = jfn(jparams, jopt, jax.tree.map(
            jnp.asarray, data.batch_at(i)))
        params, opt, m = fn(params, opt, _batch(data, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert _delta_rel(params, params0, jparams, jparams0) < 3e-2


def test_microbatch_equivalence_and_remat_is_bit_exact():
    _, _, _, _, params, _, data = _setup()
    cfg = dataclasses.replace(testing.reduced_config("internlm2-1.8b"),
                              **TINY)
    lr_fn = schedule.linear_warmup_cosine(1e-3, 5, 50)
    runs = {}
    for name, kw in [("one", dict()), ("micro", dict(n_microbatches=4)),
                     ("remat", dict(remat=True))]:
        tc = step.TrainConfig(lr=1e-3, warmup_steps=5, total_steps=50,
                              param_dtype="float32",
                              **{"remat": False, **kw})
        fn = step.make_train_step(cfg, tc, lr_fn)
        p = tree_map(torch.clone, params)
        o = adamw.adamw_init(p)
        for i in range(2):
            p, o, m = fn(p, o, _batch(data, i))
        runs[name] = (float(m["loss"]), p)
    np.testing.assert_allclose(runs["micro"][0], runs["one"][0], rtol=2e-5)
    for a, b in zip(leaves(runs["micro"][1]), leaves(runs["one"][1])):
        assert (a - b).abs().max() < 2e-5
    assert runs["remat"][0] == runs["one"][0]
    for a, b in zip(leaves(runs["remat"][1]), leaves(runs["one"][1])):
        assert torch.equal(a, b)


def test_launcher_refuses_bisect_capacity_mode():
    """The launcher takes JAX's two capacity modes ("bisect" since MoE
    training is ported) and refuses any other."""
    from repro_torch.launch import train as launch_train

    assert launch_train.parse_args([]).capacity_mode == "fifo"
    assert launch_train.parse_args(
        ["--capacity-mode", "bisect"]).capacity_mode == "bisect"
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--capacity-mode", "priority"])


def test_non_dense_family_raises():
    """Every family trains, as in JAX: make_train_step builds a step for
    every arch of the registry (full configs: nothing is allocated).
    What still raises is the launcher for an enc-dec arch, as JAX's
    launcher fails (its SyntheticTokens batches carry no frames), with a
    ValueError before any params are built; an xlstm run through the
    launcher's main gives finite losses."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch import train as launch_train

    for arch in ARCH_IDS:
        assert callable(step.make_train_step(get_config(arch),
                                             step.TrainConfig(), lambda s: s))
    with pytest.raises(ValueError, match="encoder-decoder"):
        launch_train.main(["--arch", "whisper-tiny", "--reduced", "--device",
                           "cpu", "--steps", "1", "--batch", "2", "--seq",
                           "8"])
    out = launch_train.main(["--arch", "xlstm-1.3b", "--reduced", "--device",
                             "cpu", "--steps", "2", "--batch", "2", "--seq",
                             "32", "--clip-mode", "quantile"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((8, 4)).astype(np.float32)),
                "h": torch.from_numpy(rng.standard_normal((3, 2)).astype(
                    np.float32)).to(torch.bfloat16),
                "runs": [{"b": torch.from_numpy(
                    rng.standard_normal(4).astype(np.float32))}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_equal(a, b):
    for (na, x), (nb, y) in zip(leaves_with_path(a), leaves_with_path(b)):
        assert na == nb and x.dtype == y.dtype and torch.equal(x, y), na


def test_checkpoint_roundtrip_bf16_and_paths(tmp_path):
    t = _ckpt_tree()
    path = save_pytree(str(tmp_path), 5, t)
    _assert_equal(restore_pytree(path, t), t)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest["leaves"]) == {"params/h", "params/runs/0/b",
                                       "params/w", "step"}
    assert manifest["leaves"]["params/h"]["dtype"] == "bfloat16"
    bits = np.load(os.path.join(path, manifest["leaves"]["params/h"]["file"]))
    assert bits.dtype == np.uint16


def test_checkpoint_corrupt_detected_and_skipped(tmp_path):
    t = _ckpt_tree()
    path = save_pytree(str(tmp_path / "a"), 5, t)
    with open(os.path.join(path, "manifest.json")) as f:
        victim = next(iter(json.load(f)["leaves"].values()))["file"]
    with open(os.path.join(path, victim), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(ValueError, match="corrupt"):
        restore_pytree(path, t)
    mgr = CheckpointManager(str(tmp_path / "b"), keep=5)
    t1, t2 = _ckpt_tree(1), _ckpt_tree(2)
    mgr.save(1, t1)
    p2 = mgr.save(2, t2)
    with open(os.path.join(p2, "manifest.json"), "w") as f:
        f.write("{not json")
    assert mgr.latest_valid() == 1
    got_step, out = mgr.restore_latest(t1)
    assert got_step == 1
    _assert_equal(out, t1)


def test_checkpoint_keep_n_and_async_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _ckpt_tree(s))
    assert mgr.steps() == [3, 4]
    t = _ckpt_tree(9)
    want = {"params": {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in t["params"].items()}, "step": t["step"]}
    mgr.save_async(9, t)
    t["params"]["w"].add_(1.0)      # an in-place update right after the save
    mgr.wait()
    got_step, out = mgr.restore_latest(t)
    assert got_step == 9 and mgr.steps() == [4, 9]
    assert torch.equal(out["params"]["w"], want["params"]["w"])


def test_checkpoint_dtype_cast_and_shape_mismatch(tmp_path):
    path = save_pytree(str(tmp_path), 1, {"w": torch.ones(4)})
    out = restore_pytree(path, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(path, {"w": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_pytree(path, {"v": torch.ones(4)})


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A {params, opt} checkpoint written by the JAX manager (bf16 params,
    f32 AdamW state) restores through the port's manager to exactly
    params_from_jax / adamw_state_from_jax of the same tree; the port's
    rewrite of it restores in JAX to the same arrays."""
    cfg = dataclasses.replace(jtesting.reduced_config("internlm2-1.8b"),
                              **TINY)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(1),
                                       jnp.bfloat16)
    jopt = jadamw.adamw_init(jparams, compress="int8_ef")
    jtree = {"params": jparams, "opt": jopt}
    jmanager.CheckpointManager(str(tmp_path / "jax")).save(4, jtree)
    host = jax.device_get(jtree)
    want = {"params": params_from_jax(host["params"], "cpu"),
            "opt": adamw_state_from_jax(host["opt"], "cpu")}
    template = {"params": jax.tree.map(torch.zeros_like, want["params"]),
                "opt": jax.tree.map(torch.zeros_like, want["opt"])}
    got_step, got = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        template)
    assert got_step == 4
    _assert_equal(got, want)
    assert isinstance(got["opt"], adamw.AdamWState)
    path = save_pytree(str(tmp_path / "port"), 4, got)
    back = jmanager.restore_pytree(path, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# watchdog, elastic mesh shape
# ---------------------------------------------------------------------------

def test_watchdog_flags_one_straggler_after_warmup():
    t = [0.0]
    wd = StragglerWatchdog(threshold=3.0, warmup_steps=2, clock=lambda: t[0])
    flagged = []
    for i, d in enumerate([100.0, 100.0] + [1.0] * 6 + [10.0] + [1.0] * 3):
        wd.step_start()
        t[0] += d
        flagged.append(wd.step_end(i))
    assert flagged[8] is True and sum(flagged) == 1
    assert wd.events[0]["step"] == 8


def test_derive_mesh_shape_matches_jax():
    for n in (1, 2, 7, 16, 128, 250, 256, 513):
        for mp in (1, 4, 16):
            assert (derive_mesh_shape(n, model_parallel=mp)
                    == jderive_mesh_shape(n, model_parallel=mp))
    assert derive_mesh_shape(256) == ({"data": 16, "model": 16}, 0)


# ---------------------------------------------------------------------------
# the launcher: kill and resume
# ---------------------------------------------------------------------------

def _start_train(ckpt_dir, extra) -> subprocess.Popen:
    """The launcher in a process of its own, on one torch thread (as the
    test modules run: ``tests/torch_one_thread.py``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "internlm2-1.8b", "--reduced", "--steps", "8",
           "--batch", "2", "--seq", "16", "--clip-mode", "quantile",
           "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3",
           "--log-every", "1"] + extra
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finished(proc: subprocess.Popen) -> subprocess.CompletedProcess:
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _manifest(ckpt_dir, step_n):
    with open(os.path.join(ckpt_dir, f"step_{step_n}",
                           "manifest.json")) as f:
        return {k: v["sha256"] for k, v in json.load(f)["leaves"].items()}


def _logged_losses(stderr):
    return [line.split(" loss ")[1].split()[0] for line in stderr.splitlines()
            if " loss " in line and " ce " in line]


def test_kill_and_resume_is_bit_exact(tmp_path):
    """Killed at step 4 (after the step-3 checkpoint), the rerun resumes
    from step 3, logs the same losses from there, and writes a final
    checkpoint equal, leaf for leaf, to an uninterrupted run's."""
    # the uninterrupted run and the killed one side by side
    procs = (_start_train(tmp_path / "a", []),
             _start_train(tmp_path / "b", ["--die-at-step", "4"]))
    straight, died = map(_finished, procs)
    assert straight.returncode == 0, straight.stderr[-2000:]
    assert died.returncode == 42, died.stderr[-2000:]
    assert "fault injection: dying at step 4" in died.stderr
    assert "step_3" in os.listdir(tmp_path / "b")
    resumed = _finished(_start_train(tmp_path / "b", []))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resumed from checkpoint step 3" in resumed.stderr
    assert "step_8" in os.listdir(tmp_path / "b")
    assert _logged_losses(resumed.stderr) == _logged_losses(
        straight.stderr)[3:]
    assert _manifest(tmp_path / "b", 8) == _manifest(tmp_path / "a", 8)
