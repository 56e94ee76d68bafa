"""Parameter, optimizer-state, batch and cache specs, and the local block
of a tensor under a spec (port of ``repro.launch.shardings``).

Specs are derived from tree path names and shapes with a divisibility
guard: a dim that does not divide its mesh-axis product is left
unpartitioned.  Layer-stacked leaves get their spec left-padded with None
for the leading layer axis.  A spec is a tuple with one entry a dim: a
mesh axis, a tuple of mesh axes, or None (the entries of JAX's
``PartitionSpec``).

  TP (model axis): attention/MLP hidden, vocab, experts, SSM channels.
  DP (pod, data):  batch dims of inputs and caches.
  ZeRO-1 (data):   optimizer master/mu/nu additionally sharded over `data`
                   on the first divisible dim not already taken by TP.

A path is a leaf's keys from the root (dict keys, NamedTuple fields and
list indices), as a tuple or as the ``/``-joined string
``tree.leaves_with_path`` gives; list indices never name a leaf.  The
port places tensors itself: ``local_block(x, spec, mesh)`` is this rank's
block of a tensor every rank holds whole, the counterpart of what GSPMD
hands a device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves_with_path, unflatten

# name -> spec for the TRAILING dims of the (unstacked) leaf
_COL = (None, "model")    # output-dim sharded  (d, hidden)
_ROW = ("model", None)    # input-dim sharded   (hidden, d)
_PARAM_RULES: dict[str, tuple] = {
    # embeddings
    "embed": ("model", None),
    "unembed": (None, "model"),
    "pos_embed": (None, None),
    # attention
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # norms (replicated)
    "scale": (None,), "bias": (None,),
    # dense MLP
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    "b_up": ("model",), "b_down": (None,),
    # MoE (rank-3 expert-stacked leaves handled by rank below)
    "router": (None, None),
    # SSM
    "w_x": _COL, "w_z": _COL, "conv": (None, "model"),
    "w_b": _ROW, "w_c": _ROW, "w_dt": _ROW,
    "dt_bias": ("model",), "log_a": ("model", None), "d_skip": ("model",),
    "w_out": _ROW,
    # xLSTM
    "w_q": _COL, "w_k": _COL, "w_v": _COL,
    "w_i": _COL, "w_f": _COL, "w_o": _COL,
}
_MOE_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}


def _keys(path) -> tuple[str, ...]:
    if isinstance(path, str):
        return tuple(p for p in path.split("/") if p)
    return tuple(str(p) for p in path)


def _names(path) -> tuple[str, ...]:
    """The path's names: its keys but list indices."""
    return tuple(k for k in _keys(path) if not k.isdigit())


def _leaf_name(path) -> str:
    names = _names(path)
    return names[-1] if names else ""


def _path_has(path, *names) -> bool:
    keys = set(_names(path))
    return any(n in keys for n in names)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _guard(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop axes missing from this mesh or not dividing the dim size; a
    tuple of one axis becomes that axis, as ``PartitionSpec`` spells it."""
    names = set(mesh.axis_names)
    out = []
    for dim, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        if isinstance(s, tuple):
            s = tuple(a for a in s if a in names)
            if not s:
                out.append(None)
                continue
            size = 1
            for a in s:
                size *= mesh.shape[a]
            if len(s) == 1:
                s = s[0]
        elif s in names:
            size = mesh.shape[s]
        else:
            out.append(None)
            continue
        out.append(s if shape[dim] % size == 0 else None)
    return tuple(out)


def param_spec(path, leaf, mesh) -> tuple:
    name = _leaf_name(path)
    shape = _shape(leaf)
    rank = len(shape)
    base = _PARAM_RULES.get(name)
    if base is None:
        base = (None,) * rank
    # MoE expert-stacked leaves: (E_pad, d, f) -> experts over model (EP)
    if name in _MOE_EXPERT_LEAVES and rank - len(base) >= 1 \
            and _path_has(path, "moe") and not _path_has(path, "shared"):
        base = ("model",) + (None,) * (len(base))
    pad = rank - len(base)
    spec = (None,) * pad + base
    return _guard(spec, shape, mesh)


def zero1_spec(path, leaf, mesh) -> tuple:
    """Optimizer-state spec: param TP spec + `data` on the first free
    divisible dim (ZeRO-1)."""
    base = param_spec(path, leaf, mesh)
    shape = _shape(leaf)
    data = mesh.shape.get("data", 1)
    out = list(base) + [None] * (len(shape) - len(base))
    for dim, s in enumerate(out):
        if s is None and shape[dim] % data == 0 and shape[dim] >= data:
            out[dim] = "data"
            break
    return tuple(out)


def batch_spec(leaf, mesh) -> tuple:
    """A batch leaf's spec: its leading dim over the data axes."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shape = _shape(leaf)
    return _guard((dp,) + (None,) * (len(shape) - 1), shape, mesh)


def cache_spec(path, leaf, mesh) -> tuple:
    """A decode cache leaf's spec (after the layer-stack dim)."""
    name = _leaf_name(path)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shape = _shape(leaf)
    rank = len(shape)
    if name in ("k", "v"):            # (L, B, C, n_kv, hd) ring caches
        base = (None, dp, "model", None, None)
    elif name in ("k_scale", "v_scale"):   # (L, B, C, n_kv) int8 scales
        base = (None, dp, "model", None)
    elif name in ("enc_k", "enc_v"):  # (L, B, T_enc, n_kv, hd)
        base = (None, dp, None, None, None)
    elif name == "h":                 # ssm state (L, B, d_in, N)
        base = (None, dp, "model", None)
    elif name == "conv_buf":          # (L, B, W-1, d_in)
        base = (None, dp, None, "model")
    elif name == "c" and rank == 5:   # mlstm (L, B, H, dk, dv)
        base = (None, dp, None, "model", None)
    elif name == "n" and rank == 4:   # mlstm n (L, B, H, dk)
        base = (None, dp, None, "model")
    elif name == "m" and rank == 3:   # mlstm m (L, B, H)
        base = (None, dp, None)
    elif rank >= 2:                   # slstm c/n/m (L, B, D) and misc
        base = (None, dp) + ("model",) * (rank == 3) + (None,) * max(
            0, rank - 3)
    else:
        base = (None,) * rank
    base = tuple(base)[:rank] + (None,) * max(0, rank - len(base))
    return _guard(base, shape, mesh)


def _spec_tree(tree, fn) -> Any:
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in leaves_with_path(tree)])


def make_param_shardings(mesh, params_tree) -> Any:
    """The params tree with each leaf replaced by its spec."""
    return _spec_tree(params_tree,
                      lambda path, leaf: param_spec(path, leaf, mesh))


def make_opt_state_shardings(mesh, opt_state_tree, params_tree=None) -> Any:
    """AdamWState specs: step replicated; master/mu/nu/error ZeRO-1 (the
    first path key is the state's field)."""
    del params_tree

    def fn(path, leaf):
        keys = _keys(path)
        if keys[0] == "step":
            return (None,) * len(_shape(leaf))
        return zero1_spec(keys[1:], leaf, mesh)

    return _spec_tree(opt_state_tree, fn)


def batch_shardings(mesh, batch_tree) -> Any:
    return _spec_tree(batch_tree, lambda path, leaf: batch_spec(leaf, mesh))


def make_cache_shardings(mesh, cache_tree) -> Any:
    return _spec_tree(cache_tree,
                      lambda path, leaf: cache_spec(path, leaf, mesh))


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` (held whole by every rank) under
    ``spec``: each dim cut into ``mesh.axis_size(axes)`` equal blocks and
    block ``mesh.axis_index(axes)`` kept, as GSPMD tiles ``P(*spec)``.  A
    view; raises where an axis does not divide its dim."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more dims than shape "
                         f"{tuple(x.shape)}")
    for dim, axes in enumerate(spec):
        ways = mesh.axis_size(axes)
        if ways == 1:
            continue
        n = x.shape[dim]
        if n % ways:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split {ways} ways over {axes}")
        size = n // ways
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x
