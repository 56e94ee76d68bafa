"""The port's training step for the hybrid, SSM and enc-dec families
(hymba-1.5b, xlstm-1.3b, whisper-tiny) against the JAX package's, with
the forward in bf16, both packages' default compute dtype
(``tests/test_torch_train_families_f32.py`` runs the same steps with an
f32 forward).

At ``models/testing.py::reduced_config`` sizes, ``param_dtype
"float32"``, remat on, batch 2 x seq 160 of SyntheticTokens: past the
mLSTM chunk of 64 and the SSM chunk of 128, so both carry state across
chunks.  JAX's jitted ``make_train_step`` (one compile a family) and the
port's run two steps from the same weights (JAX's ``init_params``,
carried across by ``convert.params_from_jax``) on the same batches;
whisper's frames (2, encoder_len, d_model) are numpy N(0, 1) from a
seed.  Each family runs one variant of the step: hymba the global clip,
xlstm the quantile clip (K2's plain version here), whisper two
microbatches (the frames split with the tokens).

Tolerances:
  * every step's loss and ce within rtol 1e-4 (the two frameworks round
    bf16 intermediates at other places);
  * the learning rate equal;
  * the params' change over the two steps per leaf (step 0 runs at the
    warm-up's lr 0, so the change is step 1's AdamW update) at l2 rel
    < 6e-2 of JAX's change.  The gradients agree per leaf within 1.9e-2
    in bf16 (1.6e-6 in f32), but AdamW divides each element by its own
    RMS, so an element whose gradient is near 0 takes a rounding
    difference of the order of the leaf's gradients as a difference of
    the order of a whole update: the reading is 4.7e-2 (hymba's
    embedding), 3.8e-2 (whisper's encoder w_up) and 2.1e-2 (xlstm).
    The f32 file holds the same change within 1e-3;
  * remat on against off: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.convert import adamw_state_from_jax, params_from_jax
from repro_torch.models import testing
from repro_torch.optim import adamw, schedule
from repro_torch.train import step
from repro_torch.tree import leaves, tree_map
import torch_one_thread  # noqa: F401 (one torch thread)

B, SEQ, N_STEPS = 2, 160, 2
LR = dict(lr=1e-3, warmup_steps=5, total_steps=50)
VARIANTS = {"hymba-1.5b": dict(clip_mode="global"),
            "xlstm-1.3b": dict(clip_mode="quantile"),
            "whisper-tiny": dict(n_microbatches=2)}


def _lr_fn(pkg):
    return pkg.linear_warmup_cosine(LR["lr"], LR["warmup_steps"],
                                    LR["total_steps"])


def _tc(pkg, **kw):
    return pkg.TrainConfig(**{**LR, "param_dtype": "float32",
                              "remat": True, **kw})


@functools.cache
def _weights(arch):
    """(JAX config, port config, JAX f32 params, the batches as numpy)."""
    jcfg, cfg = jtesting.reduced_config(arch), testing.reduced_config(arch)
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    data = JSyntheticTokens(vocab=cfg.vocab, seq_len=SEQ, global_batch=B)
    rng = np.random.default_rng(7)
    batches = []
    for i in range(N_STEPS):
        b = dict(data.batch_at(i))
        if cfg.is_encdec:
            b["frames"] = rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        batches.append(b)
    return jcfg, cfg, jparams, batches


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_run(arch, **tc_kw):
    """N_STEPS port steps from JAX's weights: (each step's metrics as
    floats, the params after them)."""
    _, cfg, jparams, batches = _weights(arch)
    fn = step.make_train_step(cfg, _tc(step, **tc_kw), _lr_fn(schedule))
    params = params_from_jax(jax.device_get(jparams), "cpu")
    opt = adamw.adamw_init(params)
    out = []
    for b in batches:
        params, opt, m = fn(params, opt, _port_batch(b))
        out.append({k: float(v) for k, v in m.items()})
    return out, params


def _delta_rel(port_tree, port_0, jax_tree, jax_0):
    """Per leaf, |(p - p0) - (j - j0)| / |j - j0| in the l2 norm; the
    largest over the leaves."""
    out = []
    for p, p0, j, j0 in zip(leaves(port_tree), leaves(port_0),
                            jax.tree.leaves(jax_tree),
                            jax.tree.leaves(jax_0)):
        dp = p.float().numpy() - p0.float().numpy()
        dj = np.asarray(j, np.float32) - np.asarray(j0, np.float32)
        out.append(np.linalg.norm(dp - dj) / np.linalg.norm(dj))
    return max(out)


def check_train_steps_match_jax(arch, rtol, delta_rtol):
    """Two steps of the family's reduced model against JAX's jitted step
    (one compile a family), in the family's variant: every step's loss
    and ce within ``rtol``, lr equal, the params' change per leaf within
    ``delta_rtol``."""
    jcfg, cfg, jparams, batches = _weights(arch)
    kw = VARIANTS[arch]
    jfn = jax.jit(jstep.make_train_step(jcfg, _tc(jstep, **kw),
                                        _lr_fn(jschedule)))
    fn = step.make_train_step(cfg, _tc(step, **kw), _lr_fn(schedule))
    jopt = jadamw.adamw_init(jparams)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    opt = adamw_state_from_jax(jax.device_get(jopt), "cpu")
    jparams0, params0 = jparams, tree_map(torch.clone, params)
    for b in batches:
        jparams, jopt, jm = jfn(jparams, jopt,
                                jax.tree.map(jnp.asarray, b))
        params, opt, m = fn(params, opt, _port_batch(b))
        for key in ("loss", "ce"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=rtol)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(opt.step) == N_STEPS
    assert _delta_rel(params, params0, jparams, jparams0) < delta_rtol



@pytest.mark.parametrize("arch", list(VARIANTS))
def test_train_steps_match_jax(arch):
    check_train_steps_match_jax(arch, rtol=1e-4, delta_rtol=6e-2)

def test_remat_on_and_off_are_bit_exact():
    """hymba (attention || SSM, the SSM's chunk carry) with and without
    remat: the same losses and params, bit for bit."""
    runs = {remat: _port_run("hymba-1.5b", remat=remat)
            for remat in (True, False)}
    assert ([m["loss"] for m in runs[True][0]]
            == [m["loss"] for m in runs[False][0]])
    for a, b in zip(leaves(runs[True][1]), leaves(runs[False][1])):
        assert torch.equal(a, b)


def test_whisper_loss_reads_the_frames():
    """The port's loss_fn passes batch["frames"] to forward: other frames
    give another loss, and a batch without them raises, as JAX's."""
    _, cfg, jparams, batches = _weights("whisper-tiny")
    params = params_from_jax(jax.device_get(jparams), "cpu")
    tc = _tc(step)
    b = _port_batch(batches[0])
    loss, _ = step.loss_fn(cfg, params, b, tc)
    other, _ = step.loss_fn(cfg, params, {**b, "frames": -b["frames"]}, tc)
    assert torch.isfinite(loss) and float(loss) != float(other)
    with pytest.raises(ValueError, match="encoder_frames"):
        step.loss_fn(cfg, params, {k: b[k] for k in ("tokens", "targets")},
                     tc)

