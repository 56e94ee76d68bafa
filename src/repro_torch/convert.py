"""The one bridge from the JAX package's parameters to the port's.

``params_from_jax`` takes the JAX parameter pytree AFTER ``jax.device_get``
(nested dicts and lists of numpy arrays) and returns the same tree of torch
tensors, so both packages can run on identical weights;
whisper's ``pos_embed`` and ``encoder`` ride along as any other entry.
``adamw_state_from_jax`` carries a JAX ``AdamWState`` across the same way,
and ``cache_from_jax`` a decode cache (``KVCache``, with its int8 codes
and f16 scales in int8 mode, ``SSMState``, ``MLSTMState``, ``SLSTMState``
NamedTuples, whisper's encoder K/V), each state mapped onto the port's
own NamedTuple by class and field name.  They take numpy only: this
module imports neither JAX nor anything of the JAX package.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross bit for bit through a ``uint16``
view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.optim.adamw import AdamWState

# the port's counterpart of each JAX NamedTuple a tree may hold
_NAMED = {cls.__name__: cls
          for cls in (KVCache, SSMState, MLSTMState, SLSTMState)}


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


def _named(np_tuple, device, dtype):
    """A JAX NamedTuple -> the port's class of the same name, field by
    field (None stays None: an unquantized cache's scales).  A JAX field
    the port's class lacks must be None."""
    name = type(np_tuple).__name__
    if name not in _NAMED:
        raise TypeError(f"no port counterpart of the NamedTuple {name}")
    cls = _NAMED[name]
    fields = np_tuple._asdict()
    extra = [f for f in fields if f not in cls._fields
             and fields[f] is not None]
    if extra:
        raise ValueError(f"{name} fields {extra} have no place in the "
                         f"port's {name}")
    return cls(**{f: params_from_jax(fields[f], device, dtype)
                  for f in cls._fields})


def params_from_jax(np_tree, device, dtype: torch.dtype | None = None):
    """Numpy pytree -> the same tree of tensors on ``device``; a NamedTuple
    becomes the port's NamedTuple of the same name.

    ``dtype`` casts every floating leaf (None keeps each leaf's own type).
    """
    if np_tree is None:
        return None
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in np_tree.items()}
    if isinstance(np_tree, tuple) and hasattr(np_tree, "_fields"):
        return _named(np_tree, device, dtype)
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device, dtype) for v in np_tree)
    return _leaf(np_tree, device, dtype)


def cache_from_jax(np_cache, device) -> list:
    """A JAX decode cache after ``jax.device_get`` (a list of per-run dicts
    of ``KVCache`` / ``SSMState`` / ``MLSTMState`` / ``SLSTMState`` and
    whisper's ``enc_k`` / ``enc_v``) -> the port's cache on ``device``,
    each state the port's NamedTuple, every leaf in its own dtype (int8
    codes and f16 scales included)."""
    return [params_from_jax(entry, device) for entry in np_cache]


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
