"""Tensor parallelism over the mesh's ``model`` axis: the collectives that
JAX's GSPMD inserts for the ``param_spec`` / ``TRAIN_RULES`` /
``SERVE_RULES`` layout, written out as Megatron's operator pairs.

The JAX package shards weights, heads, vocab and experts over ``model``
and lets GSPMD place the joins.  The port runs one SPMD program a rank,
each holding its blocks (``launch/shardings.py::place_params``), and
joins them here, each join an ``autograd.Function`` whose backward is
its forward's transpose:

  copy_in / reduce_out     column-parallel input (identity; backward
                           all-reduce) and row-parallel output
                           (all-reduce; backward identity): the
                           replicated residual stream of ``SERVE_RULES``
  gather_seq / scatter_seq the sequence-parallel stream of
                           ``TRAIN_RULES``' ``seq_sp``: all-gather along
                           the sequence before a column-parallel layer
                           (backward reduce-scatter), reduce-scatter
                           after a row-parallel one (backward all-gather)
  vocab_max / vocab_sum    the vocab-parallel joins of the loss and the
                           sampler (a MAX without gradient; a SUM whose
                           backward is the identity, every rank holding
                           the same loss)

Every join goes through ``launch/mesh.py::Mesh`` (``all_reduce``,
``all_gather``, ``reduce_scatter``), so it is counted in ``mesh.stats``;
over CUDA tensors on gloo (ranks sharing a card) the reduce-scatter is an
all-reduce plus a slice (``Mesh.reduce_scatter_form``).

Switching it on: the layout is on only inside ``tensor_parallel(mesh)``,
which a caller enters around calls on params that ``place_params`` cut.
A mesh whose ``model`` axis has several ranks does not switch it on by
itself: the serving scheduler's ``--mesh 1x4`` keeps whole weights.
``layout(cfg)`` reads the context once at an entry point (``forward``,
``prefill``, ``decode_step``, the train step), and the model code takes
the resulting ``TPRun`` as an argument from there: on the card autograd
recomputes a checkpointed layer on its own thread, where a thread-local
context is not set.

Heads (``TPLayout``): ranks hold whole heads.  The query heads are padded
to ``hp = ceil(n_heads / tp) * tp`` as JAX's flash branch pads them
(``repro/models/attention.py:264-275``), rank r holding padded heads
``[r * hl, (r + 1) * hl)``; a padded head's ``wq`` columns, ``bq`` and
``wo`` rows are zero, so its Q is zero, and its K and V are zero too:
it outputs 0 and its weights get exactly zero gradient.  A rank holds the
K/V heads its query heads read: a plain split where heads align
(``n_kv % tp == 0`` and ``n_heads % tp == 0``), else one K/V head per
local query head, a K/V head repeated on the ranks (and heads) that
share it, as JAX repeats K/V to the query head count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

AXIS = "model"
# the block kinds the layout covers (the dense and MoE families); the
# SSM, xLSTM and enc-dec rules are not ported
TP_KINDS = ("dense", "moe")

_state = threading.local()


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Within it, the model code runs the tensor-parallel rank program on
    ``mesh``'s ``model`` axis: the caller holds ``place_params``' blocks.
    ``tensor_parallel(None)`` turns it off for the enclosed code."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active_mesh():
    """The mesh of the enclosing ``tensor_parallel``, or None."""
    return getattr(_state, "mesh", None)


def layout(cfg: ModelConfig) -> "TPLayout | None":
    """The layout of ``cfg`` on the active mesh; None outside
    ``tensor_parallel`` or where its ``model`` axis has one rank."""
    mesh = active_mesh()
    if mesh is None or mesh.shape.get(AXIS, 1) == 1:
        return None
    return TPLayout.of(mesh, cfg)


def refuse(cfg: ModelConfig, what: str) -> None:
    """Raise where a path the layout does not cover is called under it."""
    if layout(cfg) is not None:
        raise NotImplementedError(
            f"{what} has no tensor-parallel form; the layout covers "
            "forward, prefill and the dense-ring decode step")


# ---------------------------------------------------------------------------
# the layout of one config on one mesh
# ---------------------------------------------------------------------------

def head_plan(n_heads: int, n_kv: int, tp: int
              ) -> tuple[int, tuple[tuple[int, ...], ...], int]:
    """(hp, kv_rows, n_rep_local) of ``n_heads`` query and ``n_kv`` K/V
    heads over ``tp`` ranks.  ``kv_rows[r]`` is the global K/V head of
    each local K/V slot of rank r (-1: a padded head, zero weights);
    rank r's local query head j reads local K/V slot ``j //
    n_rep_local``."""
    hp = -(-n_heads // tp) * tp
    hl = hp // tp
    n_rep = n_heads // n_kv
    reads = [[(g // n_rep if g < n_heads else -1)
              for g in range(r * hl, (r + 1) * hl)] for r in range(tp)]
    # without padding, aligned blocks of gcd(hl, n_rep) local heads read
    # one K/V head: the local grouped-query layout
    rep = math.gcd(hl, n_rep) if hp == n_heads else 1
    return hp, tuple(tuple(row[::rep]) for row in reads), rep


@dataclasses.dataclass(frozen=True, eq=False)
class TPLayout:
    """Where ``cfg``'s heads, vocab and experts lie on ``mesh``'s
    ``model`` axis, and this rank's share (``rank``: its model index)."""

    mesh: Any
    cfg: ModelConfig

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _cached(mesh, cfg):
        return TPLayout(mesh, cfg)

    @classmethod
    def of(cls, mesh, cfg: ModelConfig) -> "TPLayout":
        lay = cls._cached(mesh, cfg)
        lay.check()
        return lay

    def check(self) -> None:
        from repro_torch.models.transformer import layer_plan

        kinds = {k for k, _ in layer_plan(self.cfg)}
        if not kinds <= set(TP_KINDS) or self.cfg.act != "swiglu":
            raise NotImplementedError(
                f"{self.cfg.name}: the tensor-parallel layout covers the "
                f"dense and MoE families (SwiGLU MLPs), not "
                f"{sorted(kinds - set(TP_KINDS)) or self.cfg.act}")

    # -- sizes -------------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.mesh.shape[AXIS]

    @property
    def rank(self) -> int:
        return self.mesh.axis_index(AXIS)

    @functools.cached_property
    def _heads(self):
        return head_plan(self.cfg.n_heads, self.cfg.n_kv_heads, self.tp)

    @property
    def hp(self) -> int:
        """Query heads, padded to a multiple of ``tp``."""
        return self._heads[0]

    @property
    def hl(self) -> int:
        """Query heads a rank (padded ones included)."""
        return self.hp // self.tp

    @property
    def kv_rows(self) -> tuple[tuple[int, ...], ...]:
        return self._heads[1]

    @property
    def kv_l(self) -> int:
        """K/V heads a rank."""
        return len(self.kv_rows[0])

    @property
    def kv_shared(self) -> bool:
        """Whether a K/V head lies on more than one rank or slot (its
        copies' gradients are summed, and its norm counted once)."""
        flat = [h for row in self.kv_rows for h in row if h >= 0]
        return len(flat) != len(set(flat)) or len(flat) != self.cfg.n_kv_heads

    @functools.cached_property
    def kv_pick(self) -> tuple[int, ...]:
        """For each global K/V head, its first slot in the (tp * kv_l)
        slots a gather over ``model`` lines up."""
        flat = [h for row in self.kv_rows for h in row]
        return tuple(flat.index(h) for h in range(self.cfg.n_kv_heads))

    @functools.cached_property
    def kv_owner(self) -> tuple[tuple[bool, ...], ...]:
        """Per rank and local K/V slot: whether it holds its head's first
        copy (the one a norm counts)."""
        first = set(self.kv_pick)
        return tuple(tuple(r * self.kv_l + j in first
                           for j in range(self.kv_l))
                     for r in range(self.tp))

    @functools.cached_property
    def local_cfg(self) -> ModelConfig:
        """The config of one rank's attention: its local heads (padded)."""
        return dataclasses.replace(
            self.cfg, n_heads=self.hl, n_kv_heads=self.kv_l,
            d_head=self.cfg.head_dim)

    @property
    def vocab_local(self) -> int:
        return self.cfg.vocab_padded // self.tp

    @property
    def vocab_offset(self) -> int:
        return self.rank * self.vocab_local

    @property
    def e_pad(self) -> int:
        from repro_torch.models.moe import padded_experts

        return padded_experts(self.cfg.n_experts)

    @property
    def e_local(self) -> int:
        return self.e_pad // self.tp

    @property
    def e_offset(self) -> int:
        return self.rank * self.e_local

    def run(self, seq_sp: bool) -> "TPRun":
        return TPRun(self, seq_sp)


# ---------------------------------------------------------------------------
# the joins
# ---------------------------------------------------------------------------

def _gather_dim(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block of ``t`` along ``dim``, concatenated in rank
    order over ``model``."""
    return mesh.all_gather(t.movedim(dim, 0), AXIS).movedim(0, dim)


def _scatter_dim(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``model``."""
    return mesh.reduce_scatter(t.movedim(dim, 0), AXIS).movedim(0, dim)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, AXIS), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather_dim(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(ctx.mesh, g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _scatter_dim(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(ctx.mesh, g, ctx.dim), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


@dataclasses.dataclass(frozen=True)
class TPRun:
    """A layout in one mode: ``seq_sp`` (``TRAIN_RULES``: the residual
    stream between blocks split over ``model`` along the sequence) or
    not (``SERVE_RULES``: replicated)."""

    layout: TPLayout
    seq_sp: bool

    @property
    def mesh(self):
        return self.layout.mesh

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The stream as a column-parallel layer reads it: every row."""
        if self.seq_sp:
            return _GatherSeq.apply(h, self.mesh, 1)
        return _CopyIn.apply(h, self.mesh)

    def join(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial sums, joined back into the
        stream's layout."""
        if self.seq_sp:
            return _ScatterSeq.apply(partial, self.mesh, 1)
        return _ReduceOut.apply(partial, self.mesh)

    def shared_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, computed alike on every rank of ``model``, with 1/tp of
        its gradient: the gradient joins sum a replicated leaf's
        gradients over ``model``."""
        return _ScaleGrad.apply(t, 1.0 / self.layout.tp)


def vocab_max(mesh, t: torch.Tensor) -> torch.Tensor:
    """The MAX of ``t`` over ``model``, without gradient."""
    return mesh.all_reduce(t.detach(), AXIS, "max")


def vocab_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The SUM of ``t`` over ``model``; its backward is the identity
    (every rank goes on with the same joined value)."""
    return _ReduceOut.apply(t, mesh)


def gather_heads(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's heads (dim ``dim`` of ``t``) in rank order, without
    gradient (the decode path's small gathers)."""
    return _gather_dim(mesh, t, dim)
