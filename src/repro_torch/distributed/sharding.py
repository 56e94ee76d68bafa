"""Logical-axis sharding rules, flax-style (port of
``repro.distributed.sharding``).

Model code names tensor dims by *logical* axes (``shard(x, "batch",
"seq", "embed")``); a rules context maps logical names to mesh axes.  The
rule sets are the JAX package's, entry for entry:

  batch    -> ("pod", "data")     data parallel over pods x pod-local DP
  embed    -> None                residual stream replicated
  seq      -> "model"             sequence parallelism between blocks
  heads    -> "model"             tensor parallelism (attention)
  ffn      -> "model"             tensor parallelism (MLP hidden)
  vocab    -> "model"             sharded embed/unembed + logits
  expert   -> "model"             expert parallelism (MoE)
  slot     -> ("pod", "data")     serving decode lanes, solver batch rows
  solver_vocab -> "model"         the solve's reduction dim

The port places tensors explicitly (SPMD over ``torch.distributed``: each
rank holds its local block, ``launch/shardings.py::local_block`` cuts
it), so where GSPMD took a sharding constraint, ``shard`` only checks that
the annotation names one logical axis a dim and returns ``x`` as it is;
the rules serve the callers that place state themselves (the serving
scheduler's slots and the solver engine's mesh policy, through
``resolve_axes``).  The tensor-parallel layout's weights, heads, vocab
and experts over ``model`` are placed by ``launch/shardings.py::
place_params``, and the joins GSPMD would insert between them are
written out in ``distributed/tp.py``; the model code reads ``seq_sp``
from the active rules to choose the sequence-parallel stream
(``TRAIN_RULES``) or the replicated one (``SERVE_RULES``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping

import torch

_state = threading.local()

# rule-sets: logical axis -> mesh axis (or tuple of mesh axes) or None
TRAIN_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",       # sequence-parallel residual stream
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": None,
    # the mesh-native solver engine (core/solver.py MeshPolicy):
    "slot": ("pod", "data"),   # serving decode lanes / engine batch rows
    "solver_vocab": "model",   # the solve's reduction dim (vocab / norms)
}

SERVE_RULES: dict[str, object] = dict(TRAIN_RULES)
SERVE_RULES.update({
    "batch": ("pod", "data"),
    # the ring cache's sequence dim over `model`, kv heads replicated
    "cache_seq": "model",
    "kv_heads": None,
    "seq_sp": None,          # decode residual is tiny; keep replicated
    # the paged KV pool's page dim over the data axes
    "page": ("pod", "data"),
})


def _mesh_axes(mesh, spec) -> object:
    """Drop rule entries whose mesh axis is absent (e.g. a single-pod mesh
    has no 'pod' axis) so one rule-set serves every mesh shape."""
    names = set(mesh.axis_names)
    if spec is None:
        return None
    if isinstance(spec, tuple):
        kept = tuple(s for s in spec if s in names)
        return kept if kept else None
    return spec if spec in names else None


def _axis_size(mesh, spec) -> int:
    if spec is None:
        return 1
    if isinstance(spec, tuple):
        n = 1
        for s in spec:
            n *= mesh.shape[s]
        return n
    return mesh.shape[spec]


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, object], mesh):
    """Activate a logical->mesh mapping for the enclosed code."""
    prev = getattr(_state, "rules", None)
    _state.rules = (dict(rules), mesh)
    try:
        yield
    finally:
        _state.rules = prev


def current_rules():
    return getattr(_state, "rules", None)


def logical_axis_size(logical: str) -> int:
    """Ranks behind the mesh axes a logical axis maps to under the
    active rules (1 when no rules are active)."""
    active = current_rules()
    if active is None:
        return 1
    rules, mesh = active
    return _axis_size(mesh, _mesh_axes(mesh, rules.get(logical)))


def logical_sharding(mesh, rules, *logical_axes) -> tuple:
    """The spec tuple (a mesh axis, a tuple of axes or None per dim) the
    rules give these logical axes on this mesh: JAX's ``PartitionSpec``
    entries."""
    return tuple(_mesh_axes(mesh, rules.get(a)) for a in logical_axes)


def resolve_axes(mesh, rules: Mapping[str, object], logical: str):
    """Mesh axis (name, tuple of names, or None) a logical axis maps to on
    THIS mesh, rule entries naming absent axes dropped.  The serving
    scheduler places slot state and builds the solver's MeshPolicy from
    the same SERVE_RULES."""
    return _mesh_axes(mesh, rules.get(logical))


def resolved_axis_size(mesh, axes) -> int:
    """Ranks behind a resolve_axes() result (1 for None)."""
    return _axis_size(mesh, axes)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Check an annotation and return ``x`` unchanged.

    This is where the JAX package puts GSPMD's sharding constraint; the
    port's tensors are already each rank's local block, placed by their
    owner, so nothing moves here.  Under active rules an annotation must
    name one logical axis a dim, as JAX's raises.
    """
    if current_rules() is not None and len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard(): {len(logical_axes)} axes for rank-{x.ndim} tensor")
    return x
