"""The one bridge from the JAX package's parameters to the port's.

``params_from_jax`` takes the JAX parameter pytree AFTER ``jax.device_get``
(nested dicts and lists of numpy arrays) and returns the same tree of torch
tensors, so both packages can run on identical weights;
``adamw_state_from_jax`` carries a JAX ``AdamWState`` across the same way.
They take numpy only: this module imports neither JAX nor anything of the
JAX package.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross bit for bit through a ``uint16``
view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


def _leaf(a, device, dtype) -> torch.Tensor:
    # a writable copy: jax.device_get hands out read-only buffers
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(np_tree, device, dtype: torch.dtype | None = None):
    """Numpy pytree -> the same tree of tensors on ``device``.

    ``dtype`` casts every floating leaf (None keeps each leaf's own type).
    """
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device, dtype) for v in np_tree)
    return _leaf(np_tree, device, dtype)


def adamw_state_from_jax(np_state, device) -> AdamWState:
    """A JAX ``AdamWState`` after ``jax.device_get`` (a NamedTuple of
    numpy trees, ``error`` None unless int8 error feedback is on) -> the
    port's ``AdamWState`` on ``device``, every leaf in its own dtype."""
    step, master, mu, nu, error = np_state
    return AdamWState(
        step=_leaf(step, device, None),
        master=params_from_jax(master, device),
        mu=params_from_jax(mu, device),
        nu=params_from_jax(nu, device),
        error=None if error is None else params_from_jax(error, device),
    )
