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


# ---------------------------------------------------------------------------
# ZeRO-1 shards as the port places them
# ---------------------------------------------------------------------------

def zero1_local_spec(path, leaf, mesh) -> tuple:
    """The spec of a ZeRO-1 optimizer-state leaf as the port places it:
    ``zero1_spec``'s, ``model`` entries kept.  ``leaf`` is the tensor a
    rank holds: the whole leaf where weights are replicated, or its
    tensor-parallel block (``place_params``) under the layout.  The
    ``data`` entry cuts that tensor (``zero1_dim``); the ``model`` entries
    say where the block came from and are not cut again, and on a mesh
    whose weights are replicated the ``model`` ranks (and ``pod``) hold
    replicas.  A leaf with no dim that ``data`` divides stays whole on
    every rank, as JAX's ``zero1_spec`` leaves it replicated."""
    return zero1_spec(path, leaf, mesh)


def _data_only(spec: tuple) -> tuple:
    return tuple("data" if s == "data" else None for s in spec)


def zero1_dim(path, leaf, mesh) -> int | None:
    """The dim of ``leaf`` that ``zero1_local_spec`` cuts over ``data``
    (None where it stays whole, or on a mesh of one data rank)."""
    if mesh.shape.get("data", 1) == 1:
        return None
    spec = zero1_local_spec(path, leaf, mesh)
    return spec.index("data") if "data" in spec else None


def data_block(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's block of ``x`` cut over ``data`` on ``dim`` (a view)."""
    size = x.shape[dim] // mesh.shape["data"]
    return x.narrow(dim, mesh.axis_index("data") * size, size)


def zero1_block(x: torch.Tensor, path, mesh) -> torch.Tensor:
    """This rank's ZeRO-1 block of ``x`` (a view; ``x`` itself where the
    leaf stays whole)."""
    dim = zero1_dim(path, x, mesh)
    return x if dim is None else data_block(x, dim, mesh)


def zero1_sharding_fn(mesh, device, prefix: str = "opt"):
    """A checkpoint ``sharding_fn`` (``checkpoint/manager.py``) that
    restores a whole optimizer state as this rank's ZeRO-1 shards: a
    leaf named ``<prefix>/<master|mu|nu|error>/<param path>`` is cut by
    ``zero1_local_spec`` of its param path, every other leaf (``step``,
    the params) lands whole on ``device``."""
    from repro_torch.checkpoint.manager import Placement

    fields = {"master", "mu", "nu", "error"}

    def fn(name: str, arr):
        keys = _keys(name)
        head = keys[:len(_keys(prefix))] if prefix else ()
        rest = keys[len(head):]
        if head == _keys(prefix) and rest and rest[0] in fields:
            return Placement(device, _data_only(zero1_local_spec(
                rest[1:], arr.shape, mesh)), mesh)
        return device

    return fn


class Zero1Grads:
    """The ZeRO-1 gradient constraint (JAX's ``dryrun.py`` ``--zero-grads``
    ``grad_constraint``: every gradient constrained to its optimizer
    state's ``zero1_spec``), as ``train/step.py::make_train_step``'s
    ``grad_constraint=``: the step joins the gradients by one
    reduce-scatter onto the shards (``Mesh.reduce_scatter``) instead of
    an all-reduce of which each rank keeps its shard."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __repr__(self) -> str:
        return f"Zero1Grads({self.mesh.shape})"


def zero1_grad_constraint(mesh) -> Zero1Grads:
    """The ZeRO-1 gradient constraint on ``mesh`` (mirrors
    ``repro/launch/dryrun.py``'s ``grad_constraint`` under
    ``--zero-grads``)."""
    return Zero1Grads(mesh)


# ---------------------------------------------------------------------------
# the tensor-parallel layout: whole heads, padded, over `model`
# ---------------------------------------------------------------------------

_Q_LEAVES = {"wq", "bq"}
_KV_LEAVES = {"wk", "wv", "bk", "bv"}


def _tp_dim(path, shape: tuple) -> int | None:
    """The dim ``param_spec``'s rules put ``model`` on, before its
    divisibility guard (None: the leaf is replicated)."""
    name = _leaf_name(path)
    rank = len(shape)
    base = _PARAM_RULES.get(name) or (None,) * rank
    if name in _MOE_EXPERT_LEAVES and rank - len(base) >= 1 \
            and _path_has(path, "moe") and not _path_has(path, "shared"):
        base = ("model",) + (None,) * len(base)
    spec = (None,) * (rank - len(base)) + tuple(base)
    return spec.index("model") if "model" in spec else None


def tp_leaf_rule(path, leaf) -> tuple[str, int | None]:
    """The head-aligned local spec of a parameter leaf under the
    tensor-parallel layout, beside ``param_spec``: ``("q", dim)``
    (query-head columns of ``wq``/``bq``), ``("o", dim)`` (query-head
    rows of ``wo``), ``("kv", dim)`` (``wk``/``wv``/``bk``/``bv``),
    ``("split", dim)`` (``param_spec``'s ``model`` dim, before its
    divisibility guard: a dim that does not split raises in
    ``place_leaf``) or ``("whole", None)``.  Where ``param_spec``'s
    guard divides a flattened ``n_heads * head_dim`` dim through a head
    (qwen1.5's 20 heads over 16 ranks), the layout places whole heads,
    padded to a multiple of the ranks, instead."""
    name = _leaf_name(path)
    shape = _shape(leaf)
    if name in _Q_LEAVES:
        return "q", len(shape) - 1
    if name == "wo":
        return "o", len(shape) - 2
    if name in _KV_LEAVES:
        return "kv", len(shape) - 1
    dim = _tp_dim(path, shape)
    return ("whole", None) if dim is None else ("split", dim)


def _heads_view(t: torch.Tensor, dim: int, hd: int) -> torch.Tensor:
    return t.unflatten(dim, (t.shape[dim] // hd, hd))


def place_leaf(path, x: torch.Tensor, lay) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under the layout ``lay``
    (``distributed/tp.py::TPLayout``): a new tensor."""
    kind, dim = tp_leaf_rule(path, x)
    hd = lay.cfg.head_dim
    if kind == "whole":
        return x.clone()
    if kind == "split":
        if x.shape[dim] % lay.tp:
            raise ValueError(f"{path}: dim {dim} of {tuple(x.shape)} does "
                             f"not split {lay.tp} ways over model")
        return _tp_block(x, dim, lay).clone()
    h = _heads_view(x, dim, hd)
    if kind in ("q", "o"):
        pad = [0, 0] * (h.ndim - dim - 1) + [0, lay.hp - h.shape[dim]]
        h = torch.nn.functional.pad(h, pad)
        h = _tp_block(h, dim, lay)
    else:
        rows = lay.kv_rows[lay.rank]
        idx = torch.tensor([max(r, 0) for r in rows], device=x.device)
        h = h.index_select(dim, idx)
        real = torch.tensor([r >= 0 for r in rows], device=x.device)
        h = torch.where(real.reshape((-1,) + (1,) * (h.ndim - dim - 1)),
                        h, 0)
    return h.flatten(dim, dim + 1).contiguous()


def _tp_block(x: torch.Tensor, dim: int, lay) -> torch.Tensor:
    size = x.shape[dim] // lay.tp
    return x.narrow(dim, lay.rank * size, size)


def gather_leaf(path, t: torch.Tensor, lay) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` of it (a collective
    over ``model``; the padding dropped)."""
    from repro_torch.distributed import tp as tp_lib

    kind, dim = tp_leaf_rule(path, t)
    if kind == "whole":
        return t
    whole = tp_lib.gather_heads(lay.mesh, t.contiguous(), dim)
    if kind == "split":
        return whole
    h = _heads_view(whole, dim, lay.cfg.head_dim)
    if kind in ("q", "o"):
        h = h.narrow(dim, 0, lay.cfg.n_heads)
    else:
        h = h.index_select(dim, torch.tensor(lay.kv_pick, device=t.device))
    return h.flatten(dim, dim + 1).contiguous()


def _tp_layout(mesh, cfg):
    from repro_torch.distributed.tp import TPLayout

    return TPLayout.of(mesh, cfg)


def place_params(params, mesh, cfg) -> Any:
    """This rank's blocks of a whole parameter tree (``convert.py::
    params_from_jax``'s, ``init_params``', a checkpoint's) under the
    tensor-parallel layout of ``cfg`` on ``mesh``: new tensors.  The
    caller runs the model on them inside ``distributed/tp.py::
    tensor_parallel(mesh)``."""
    lay = _tp_layout(mesh, cfg)
    return unflatten(params, [place_leaf(path, x, lay)
                              for path, x in leaves_with_path(params)])


def gather_params(params, mesh, cfg) -> Any:
    """The whole logical tree from every rank's blocks (a collective:
    every rank of the mesh calls it), padding dropped: what checkpoints
    store and tests compare."""
    lay = _tp_layout(mesh, cfg)
    return unflatten(params, [gather_leaf(path, t, lay)
                              for path, t in leaves_with_path(params)])


def tp_cache_spec(path, leaf, mesh) -> tuple:
    """A decode cache leaf's ``cache_spec`` on the ``model`` axis alone
    (the ring's slots; K/V heads replicated, ``SERVE_RULES``): the cut
    the layout's cache takes, the batch placed by its caller."""
    return tuple(s if s == "model" else None
                 for s in cache_spec(path, leaf, mesh))


def place_cache(cache, mesh) -> Any:
    """This rank's ring block of a whole decode cache: ``tp_cache_spec``
    cut by ``local_block`` (new tensors)."""
    return unflatten(cache, [
        local_block(x, tp_cache_spec(path, x, mesh), mesh).clone()
        for path, x in leaves_with_path(cache)])


def tp_sharding_fn(mesh, cfg, device, *, params: str = "params",
                   opt: str | None = "opt"):
    """A checkpoint ``sharding_fn`` (``checkpoint/manager.py``) that
    restores a whole checkpoint onto any (data, model) placement: a leaf
    under ``<params>/`` as this rank's tensor-parallel block, one under
    ``<opt>/<master|mu|nu|error>/`` as that block's ZeRO-1 block over
    ``data`` (``zero1_local_spec`` of the block), every other leaf whole
    on ``device``.  On a mesh of one ``model`` rank the blocks are the
    whole leaves."""
    from repro_torch.checkpoint.manager import Placement

    tp = mesh.shape.get("model", 1) > 1
    lay = _tp_layout(mesh, cfg) if tp else None
    fields = {"master", "mu", "nu", "error"}
    pk, ok = _keys(params), _keys(opt) if opt else None

    def fn(name: str, arr):
        keys = _keys(name)
        if keys[:len(pk)] == pk:
            path, zero1 = keys[len(pk):], False
        elif ok and keys[:len(ok)] == ok and len(keys) > len(ok) \
                and keys[len(ok)] in fields:
            path, zero1 = keys[len(ok) + 1:], True
        else:
            return device

        def block(t):
            if lay is not None:
                t = place_leaf(path, t, lay)
            return zero1_block(t, path, mesh) if zero1 else t

        return Placement(device, mesh=mesh, block=block)

    return fn
