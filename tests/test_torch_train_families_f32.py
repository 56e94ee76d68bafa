"""The training steps of ``tests/test_torch_train_families.py`` (hymba,
xlstm and whisper, each in its variant, two steps against JAX's jitted
step) with both packages' forward computing in f32: each module's
``forward`` wrapped to that compute dtype, as ``tests/test_torch_moe.py``
does.  Without bf16 rounding the comparison sees what the bf16 one
cannot: an update that differs by less than a rounding.

Tolerances:
  * every step's loss and ce within rtol 1e-5, the learning rate equal;
  * the params' change per leaf at l2 rel < 1e-3 of JAX's change (the
    reading is at most 7.5e-5: xlstm's layer norm scale);
  * whisper's two microbatches, each with its half of the frames,
    against one batch of both halves (the port alone): loss rtol 2e-5,
    params within 2e-5 (JAX's own microbatch contract).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch.models import transformer
from repro_torch.train import step
from repro_torch.tree import leaves
from test_torch_train_families import (
    VARIANTS,
    _port_run,
    check_train_steps_match_jax,
)
import torch_one_thread  # noqa: F401 (one torch thread)


@pytest.fixture(autouse=True)
def _f32_forward(monkeypatch):
    monkeypatch.setattr(jstep, "forward", functools.partial(
        jtransformer.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(step, "forward", functools.partial(
        transformer.forward, compute_dtype=torch.float32))


@pytest.mark.parametrize("arch", list(VARIANTS))
def test_train_steps_match_jax_f32(arch):
    check_train_steps_match_jax(arch, rtol=1e-5, delta_rtol=1e-3)


def test_whisper_microbatches_split_the_frames():
    """Frames left whole beside split tokens would not run; frames split
    apart from their rows would move the loss."""
    runs = {n: _port_run("whisper-tiny", n_microbatches=n) for n in (1, 2)}
    np.testing.assert_allclose(runs[2][0][-1]["loss"],
                               runs[1][0][-1]["loss"], rtol=2e-5)
    for a, b in zip(leaves(runs[2][1]), leaves(runs[1][1])):
        assert (a - b).abs().max() < 2e-5
