"""Cost counting of a rank's program on the meta device (the port's
counterpart of ``repro.launch.hlo_cost``).

JAX's dry run compiles a cell and parses the post-SPMD HLO; the port has
no compiler between the program and the card, so it counts what eager
PyTorch dispatches.  ``count(fn, *args)`` runs ``fn`` under
``CostMode``, a ``TorchDispatchMode``, on meta tensors (shapes and
dtypes, no data: ``launch/specs.py``), and counts per run:

  * flops: 2 * M * N * K for every ``mm``, ``addmm``, ``bmm``,
    ``baddbmm`` (``matmul``, ``linear`` and ``einsum`` reach these) and
    2 * out * (C_in / groups) * prod(kernel) for every convolution, as
    ``hlo_cost._dot_flops`` counts a dot: 2 * prod(out) * prod(contract);
  * bytes: each dispatched op's tensor operands and outputs, once each,
    at op granularity.  This is NOT XLA's fusion boundary: an eager
    elementwise chain that XLA would fuse is charged at every link, so
    the port's bytes exceed the HLO's for the same function.  View ops
    move nothing and are free; an op that reads a slice or gathers rows
    is charged twice its output, an in-place scatter twice its update
    (``hlo_cost``'s slice and scatter rules);
  * peak: the most meta bytes live at once, the arguments included
    (``register``): each storage is counted while a tensor of it is
    alive (autograd's saved tensors keep theirs alive);
  * the collectives of ``RecordingMesh``, the stand-in for
    ``launch/mesh.py::Mesh`` that the program runs under: each call's op
    and payload, in ``repro/launch/dryrun.py::collective_bytes_from_hlo``'s
    convention (the output's bytes per participating device, counted
    once).  No process group is made: the stand-in answers as rank 0 of
    its mesh and returns meta tensors of the shapes the collective
    would.

Eager PyTorch runs every layer of a model one after the other, so what
is counted is the whole program: there is no loop body counted once,
and no trip count to recover.  On meta tensors every kernel wrapper in
``kernels/ops.py`` takes its plain version: K7's cells are counted as
its plain chunked version computes them (every query chunk against every
key chunk, the masked ones included), and the sampler's solves as the
plain count, mass and entropy evaluators.
"""
from __future__ import annotations

import math
import pickle
import weakref
from typing import Any, Mapping, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_VIEWS = {
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.permute,
    aten.transpose, aten.t, aten.unsqueeze, aten.squeeze, aten.select,
    aten.slice, aten.narrow, aten.as_strided, aten.alias, aten.detach,
    aten.split, aten.split_with_sizes, aten.chunk, aten.unbind,
    aten.diagonal, aten.view_as_real, aten.view_as_complex, aten.unfold,
    aten.lift_fresh, aten._reshape_alias, aten.movedim,
}
# ops that read only the rows or slice they return
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding,
            aten.slice_copy, aten.select_copy, aten.narrow_copy}
# in-place writes of an update into a larger buffer: (update arg index)
_SCATTERS = {aten.index_put_: 2, aten.index_put: 2, aten.scatter_: 3,
             aten.scatter: 3, aten.index_copy_: 3, aten.index_copy: 3,
             aten.slice_scatter: 1, aten.select_scatter: 1}


def _numel(t) -> int:
    return math.prod(t.shape)


def _mm_flops(args, out) -> float:
    """2 * prod(out) * K: the contracted dim is the last of the left
    operand (``mm``, ``bmm``; ``addmm`` / ``baddbmm`` lead with the
    addend)."""
    return 2.0 * _numel(out) * args[-2].shape[-1]


def _conv_flops(args, out) -> float:
    """2 * prod(out) * (C_in / groups) * prod(kernel): the weight is
    (C_out, C_in / groups, *kernel)."""
    w = args[1]
    return 2.0 * _numel(out) * w.shape[1] * math.prod(w.shape[2:])


_FLOPS = {aten.mm: _mm_flops, aten.addmm: _mm_flops, aten.bmm: _mm_flops,
          aten.baddbmm: _mm_flops, aten.convolution: _conv_flops,
          aten._convolution: _conv_flops}


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


_STATIC = (int, float, bool, str, type(None), torch.dtype, torch.device,
           torch.memory_format, torch.layout)


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """An op that returns fresh tensors: no output aliases an input and
    nothing is written in place."""
    hit = _FUNCTIONAL.get(func)
    if hit is None:
        schema = func._schema
        hit = _FUNCTIONAL[func] = not schema.is_mutable and not any(
            r.alias_info is not None for r in schema.returns)
    return hit


def _key_parts(x, key: list) -> bool:
    """Append ``x``'s metadata to ``key``; False where it has none."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return False
        key.append((tuple(x.shape), x.stride(), x.dtype))
    elif isinstance(x, (list, tuple)):
        key.append(len(x))
        return all(_key_parts(y, key) for y in x)
    elif isinstance(x, dict):
        for k in sorted(x):
            key.append(k)
            if not _key_parts(x[k], key):
                return False
    elif isinstance(x, _STATIC):
        key.append((type(x), x))
    else:
        return False
    return True


def _memo_key(func, args, kwargs):
    """The op and its operands' metadata (shape, stride, dtype of each
    meta tensor, the other arguments' values): what fixes its outputs'
    metadata; None where an argument has no such key."""
    key = [func]
    if _key_parts(args, key) and _key_parts(kwargs, key):
        return tuple(key)
    return None


def _meta_of(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _fresh(meta: tuple) -> torch.Tensor:
    shape, stride, dtype = meta
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class CostMode(TorchDispatchMode):
    """Counts flops, bytes and the live peak of what it dispatches (see
    the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.ops: dict[str, int] = {}
        self._refs: dict[int, list] = {}     # storage -> [count, bytes]
        # a functional op's output metadata by its operands' (the meta
        # kernels' shape inference is most of a trace's time; a model
        # repeats the same op on the same shapes)
        self._memo: dict[tuple, tuple] = {}

    def register(self, tree) -> int:
        """Count the tensors of ``tree`` (the arguments) live for the
        whole run; returns their bytes."""
        added = 0
        for t in _tensors(tree):
            key = t.untyped_storage()._cdata
            if key in self._refs:
                continue
            n = t.untyped_storage().nbytes()
            self._refs[key] = [math.inf, n]
            added += n
        self.argument_bytes += added
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, st.nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def _run(self, func, args, kwargs):
        """``func``'s result: a functional op seen before on operands of
        the same metadata gets fresh meta outputs of the metadata it gave
        then, without running its meta kernel again."""
        key = _memo_key(func, args, kwargs) if _functional(func) else None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            kind, metas = hit
            if kind is None:
                return _fresh(metas)
            return kind(_fresh(m) for m in metas)
        out = func(*args, **kwargs)
        if key is not None:
            if isinstance(out, torch.Tensor) and out.device.type == "meta":
                self._memo[key] = (None, _meta_of(out))
            elif isinstance(out, (tuple, list)) and all(
                    isinstance(x, torch.Tensor) and x.device.type == "meta"
                    for x in out):
                self._memo[key] = (type(out), [_meta_of(x) for x in out])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        packet = func.overloadpacket
        name = str(packet).split(".")[-1]
        self.ops[name] = self.ops.get(name, 0) + 1
        outs = _tensors(out)
        if packet in _FLOPS:
            self.flops += _FLOPS[packet](args, outs[0])
        if packet in _GATHERS:
            self.bytes += 2 * sum(map(nbytes, outs))
        elif packet in _SCATTERS:
            i = _SCATTERS[packet]
            upd = args[i] if len(args) > i else None
            upd = [upd] if isinstance(upd, torch.Tensor) else _tensors(upd)
            self.bytes += 2 * sum(map(nbytes, upd))
        elif packet not in _VIEWS:
            self.bytes += (sum(map(nbytes, _tensors(args)))
                           + sum(map(nbytes, _tensors(kwargs)))
                           + sum(map(nbytes, outs)))
        for t in outs:
            if t.device.type == "meta":
                self._track(t)
        return out


class RecordingMesh:
    """A stand-in for ``launch/mesh.py::Mesh`` of any shape: the same
    axis queries and collectives, answered as rank 0 of the mesh with
    meta tensors, each collective recorded as (op, payload bytes per
    device) in ``calls`` and its mesh axes, in the same order, in
    ``call_axes``."""

    def __init__(self, shape: Mapping[str, int] | Sequence[int],
                 axis_names: Sequence[str] | None = None):
        if axis_names is None:
            axis_names, dims = tuple(shape), tuple(shape.values())
        else:
            axis_names, dims = tuple(axis_names), tuple(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, dims))
        self.size = math.prod(dims)
        self.rank = 0
        self.coords = {a: 0 for a in axis_names}
        self.device = torch.device("meta")
        self.agreed: dict = {}
        self.calls: list[tuple[str, int]] = []
        self.call_axes: list[tuple[str, ...]] = []
        self.reduce_scatter_form = "reduce_scatter_tensor"

        from repro_torch.launch.mesh import JoinStats
        self.stats = JoinStats()

    def __repr__(self) -> str:
        return f"RecordingMesh({self.shape})"

    def _axes(self, axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.shape}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        self._axes(axes)
        return 0

    def group_ranks(self, axes) -> tuple[int, ...]:
        return tuple(range(self.axis_size(axes)))

    def _record(self, op: str, axes, payload: int) -> None:
        if self.axis_size(axes) > 1:
            self.calls.append((op, int(payload)))
            self.call_axes.append(self._axes(axes))
            self.stats.count += 1

    def all_reduce(self, t, axes, op: str = "sum"):
        self._record("all-reduce", axes, nbytes(t))
        return t.clone()

    def all_gather(self, t, axes):
        ways = self.axis_size(axes)
        out = t.new_empty((t.shape[0] * ways,) + tuple(t.shape[1:]))
        self._record("all-gather", axes, nbytes(out))
        return out

    def reduce_scatter(self, t, axes):
        ways = self.axis_size(axes)
        out = t.new_empty((t.shape[0] // ways,) + tuple(t.shape[1:]))
        self._record("reduce-scatter", axes, nbytes(out))
        return out

    def broadcast(self, t, axes, src_index: int):
        self._record("broadcast", axes, nbytes(t))
        return t

    def broadcast_object(self, obj: Any, axes, src_index: int) -> Any:
        self._record("broadcast", axes, len(pickle.dumps(obj)))
        return obj

    def barrier(self) -> None:
        return None

    def collectives(self) -> tuple[float, dict[str, int], dict]:
        """(payload bytes, {op: count}, {op: {"count", "bytes"}})."""
        histo: dict[str, int] = {}
        detail: dict[str, dict[str, float]] = {}
        for op, b in self.calls:
            histo[op] = histo.get(op, 0) + 1
            d = detail.setdefault(op, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += b
        return float(sum(b for _, b in self.calls)), histo, detail


def count(fn, *args, arguments=None, **kwargs) -> tuple[Any, CostMode]:
    """``fn(*args, **kwargs)`` under a ``CostMode``: (its result, the
    mode's counts).  ``arguments`` (a tree of tensors, by default
    ``args``) is what the peak counts as live from the start."""
    mode = CostMode()
    with mode:
        mode.register(args if arguments is None else arguments)
        out = fn(*args, **kwargs)
    return out, mode
