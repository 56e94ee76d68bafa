"""Training step: CE loss, microbatch gradient accumulation, clipping,
AdamW (port of ``repro.train.step``).

One device, eager: the gradients come from ``torch.autograd.grad`` over
the compute params, accumulate over microbatches in f32, are clipped by
the global norm or by the quantile clip (whose solve runs K2 on the
card), and AdamW updates the master weights, moments and compute params
in place (``optim/adamw.py``).  Remat is one checkpoint per layer
(``models/transformer.py::forward``); at ``S >= 4096`` each layer's
causal self-attention forward is K7 (``kernels/ops.py::flash_fwd``),
banded on hymba's sliding-window layers.

Every family trains, as in JAX.  A MoE model routes with
``capacity_mode`` (``"bisect"``: each layer's capacity cut is one K3
launch on the card, twice a step under remat) in ``moe_groups`` GShard
groups, and its load-balance loss enters the loss as JAX's ``aux_weight
* aux / n_layers``.  The recurrent mixers (hymba's SSM, xlstm's mLSTM and
sLSTM) get their gradients from autograd through their full-sequence
forwards.  An enc-dec model (whisper) takes its encoder's input frames
as ``batch["frames"]`` (B, T_enc, D), which the microbatch split divides
along the batch as it does the tokens.

Data-parallel training across ranks (``make_train_step(..., mesh=)``),
the function JAX's launcher computes under ``axis_rules(TRAIN_RULES,
mesh)`` with GSPMD: params and optimizer state replicated, the batch
split over the data axes.  Every rank is handed the global batch and
keeps its rows (``rank_rows``), computes its local loss and gradients
under the rules (a MoE layer routes over the whole batch, ``models/
moe.py::moe_apply``), then one all-reduce of the gradients over the data
axes, in buckets of the gradient dtype, divided by the data ranks (JAX's
GSPMD reduces in the gradient dtype too; gloo reduces bf16).  The clip
(K2 through the quantile clip on every rank) and AdamW then run on the
replicated gradient as on one device, so every rank's params and state
stay bit-identical, and one small all-reduce of the scalar metrics gives
every rank JAX's global loss, ce, z_loss and aux.

ZeRO-1 (an optimizer state from ``adamw_init(params, mesh=)``, whose
master, mu, nu and residual are this rank's ``zero1_block`` of each
leaf): a step does four things in order.  It joins the gradients: by
default the same bucketed all-reduce, of which each rank keeps its
blocks; with ``grad_constraint=launch/shardings.py::
zero1_grad_constraint(mesh)`` (JAX's ``--zero-grads`` constraint of
``launch/dryrun.py``) one reduce-scatter onto the blocks a bucket
(``Mesh.reduce_scatter``; the leaves that stay whole are all-reduced).
It clips over the blocks: the ranks' per-leaf sums of squares are
joined by one all-reduce over ``data`` (the global norm; the quantile
clip's per-leaf norms), and the quantile clip's bisection runs under a
``MeshPolicy`` whose vocab axis is ``data``, so that where the leaf
count divides the data ranks each rank's K2 counts its share of the
norms and the counts are summed (the counts are exact, so the bracket
is the single-rank step's bit for bit).  It updates AdamW on the
blocks, writing the new params into each rank's block of them, and
all-gathers the params over ``data`` in buckets of their dtype.

Tensor parallelism (``distributed/tp.py``; the dense and MoE families):
inside ``tensor_parallel(mesh)``, on ``launch/shardings.py::
place_params``' blocks (optimizer state from ``adamw_init`` of the
blocks, ZeRO-1 blocks of them with ``mesh=``), the step is the rank
program of JAX's GSPMD layout under ``TRAIN_RULES``: the forward carries
the residual stream split along the sequence (``seq_sp``), the loss is
vocab-parallel (``logz`` from a MAX and a SUM join over ``model``, the
target logit summed from the block that holds it; z-loss and the aux
term as they are), and the gradients join in two steps: a leaf split
over ``model`` is joined over the data axes only, while a leaf
replicated over ``model`` (norms, the router, q/k norms), whose rank saw
only its positions or heads, is first summed over ``model``; a K/V leaf
whose heads repeat on several ranks sums its copies' gradients into
each.  The clip takes each leaf's whole norm: split leaves' sums of
squares joined over ``model`` (a repeated K/V head counted once), a
replicated leaf's counted once, so ``clip_by_quantile`` solves on the
same per-leaf norms as one rank.  AdamW then runs on the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.solver import MeshPolicy, true_div
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.sharding import TRAIN_RULES, axis_rules
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.shardings import (
    Zero1Grads,
    data_block,
    tp_leaf_rule,
    zero1_dim,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, clip_by_quantile
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0
    clip_mode: str = "global"        # "global" | "quantile" (paper technique)
    aux_weight: float = 0.01         # MoE load-balance loss weight
    z_weight: float = 1e-4           # z-loss (logit drift control)
    n_microbatches: int = 1
    capacity_mode: str = "fifo"      # "fifo" | "bisect" (paper technique)
    moe_groups: int = 1              # GShard groups (= DP shards at scale)
    compress: str | None = None      # None | "int8_ef"
    param_dtype: str = "bfloat16"
    remat: bool = True


def loss_fn(cfg: ModelConfig, params, batch: dict, tc: TrainConfig
            ) -> tuple[torch.Tensor, dict]:
    """CE + z-loss + the MoE aux term (0 for dense) over f32 logits; an
    enc-dec model reads its encoder's frames from ``batch["frames"]``.

    The target logit is a gather: the JAX function's masked sum
    (``step.py:69-76``) adds only zeros beside it, so the value is the
    same, without a second (B, S, V) buffer.
    """
    logits, aux = forward(cfg, params, batch["tokens"],
                          encoder_frames=batch.get("frames"),
                          capacity_mode=tc.capacity_mode,
                          moe_groups=tc.moe_groups, remat=tc.remat)
    targets = batch["targets"].long()
    lay = tp_lib.layout(cfg)
    if lay is None:
        logz = torch.logsumexp(logits, dim=-1)              # (B, S)
        tgt_logit = logits.gather(-1, targets[..., None])[..., 0]
    else:
        # vocab-parallel: logits are this rank's (B, S, V_pad / tp) block
        m = tp_lib.vocab_max(lay.mesh, logits.amax(dim=-1))
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = m + torch.log(tp_lib.vocab_sum(lay.mesh, se))
        local = targets - lay.vocab_offset
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                               [..., None])[..., 0]
        tgt_logit = tp_lib.vocab_sum(lay.mesh,
                                     torch.where(inside, picked, 0.0))
    ce = torch.mean(logz - tgt_logit)
    z_loss = torch.mean(torch.square(logz))
    aux_term = true_div(tc.aux_weight * aux, max(cfg.n_layers, 1))
    loss = ce + tc.z_weight * z_loss + aux_term
    return loss, {"ce": ce, "z_loss": z_loss, "aux": aux}


# gradients are all-reduced in buckets of at most this many bytes (a
# larger leaf is a bucket of its own): a bounded staging copy
GRAD_BUCKET_BYTES = 1 << 28

METRIC_KEYS = ("loss", "ce", "z_loss", "aux")


def rank_rows(batch: dict, n_microbatches: int, mesh) -> dict:
    """This rank's rows of the global batch under ``mesh``'s data split.

    JAX's step splits the global batch into ``n`` contiguous microbatches
    and GSPMD splits each over the D data ranks; so rank r keeps, from
    each microbatch i, rows ``i*B/n + r*B/(n*D)`` to ``+ B/(n*D)``, in
    microbatch order: the rank's own microbatch split then takes its
    share of each, and the ranks' shares of microbatch i, in rank order,
    are JAX's microbatch i.  Raises unless ``n * D`` divides B."""
    axes = data_axes(mesh)
    d, r, n = mesh.axis_size(axes), mesh.axis_index(axes), n_microbatches
    out = {}
    for key, v in batch.items():
        b = v.shape[0]
        if b % (n * d):
            raise ValueError(f"a batch of {b} rows does not split into {n} "
                             f"microbatches over {d} data ranks")
        blocks = v.reshape(n, d, b // (n * d), *v.shape[1:])
        out[key] = blocks[:, r].reshape(b // d, *v.shape[1:])
    return out


def _buckets(tensors: list) -> list[list[int]]:
    """Consecutive tensors of one dtype, at most ``GRAD_BUCKET_BYTES`` a
    bucket (a larger tensor is a bucket of its own): their indices."""
    buckets, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != tensors[cur[0]].dtype
                    or size + nbytes > GRAD_BUCKET_BYTES):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def all_reduce_mean_(tensors: list, mesh, axes, mean: bool = True) -> list:
    """Each tensor replaced IN PLACE by its mean (``mean=False``: its
    sum) over the ranks of ``axes``: one sum all-reduce per bucket
    (consecutive tensors of one dtype, at most ``GRAD_BUCKET_BYTES``),
    each counted in ``mesh.stats``, then a true division by the rank
    count.  Every rank ends with the same bits.  Returns ``tensors``."""
    ways = mesh.axis_size(axes)
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = mesh.all_reduce(flat, axes)
        if mean:
            flat = true_div(flat, ways)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            tensors[i].copy_(part.view(tensors[i].shape))
    return tensors


def _rows_by_rank(t: torch.Tensor, dim: int, ways: int) -> torch.Tensor:
    """``t`` as (ways, n): row r the flattened block r of ``dim``."""
    return t.movedim(dim, 0).reshape(ways, -1)


def _from_rows(rows: torch.Tensor, like_shape, dim: int) -> torch.Tensor:
    """``rows`` (flattened blocks of ``dim``, in order) back in the layout
    of a leaf of ``like_shape`` whose ``dim`` they cut: one block, or
    every rank's (``_rows_by_rank``'s inverse)."""
    moved = list(like_shape)
    moved.insert(0, moved.pop(dim))
    moved[0] = -1
    return rows.reshape(moved).movedim(0, dim)


def reduce_scatter_mean(tensors: list, dims: list, mesh, axes) -> list:
    """Each rank's ``data`` block (on ``dims``) of each tensor's mean over
    the ranks of the data ``axes``: per bucket one reduce-scatter over
    ``data`` (``Mesh.reduce_scatter``; before it an all-reduce over the
    other data axes, ``pod``), then a true division by the rank count.
    Returns the blocks, new tensors."""
    ways, total = mesh.shape["data"], mesh.axis_size(axes)
    others = tuple(a for a in axes if a != "data")
    out = [None] * len(tensors)
    for idx in _buckets(tensors):
        rows = torch.cat([_rows_by_rank(tensors[i], dims[i], ways)
                          for i in idx], dim=1)
        if others:
            rows = mesh.all_reduce(rows, others)
        mine = true_div(mesh.reduce_scatter(rows, "data"), total)[0]
        sizes = [tensors[i].numel() // ways for i in idx]
        for i, part in zip(idx, mine.split(sizes)):
            out[i] = _from_rows(part, tensors[i].shape, dims[i])
    return out


def all_gather_blocks_(tensors: list, dims: list, mesh) -> None:
    """Each tensor rewritten IN PLACE from every ``data`` rank's block of
    it (this rank's block is already in place): per bucket of one dtype
    one all-gather over ``data`` of the flattened blocks."""
    ways = mesh.shape["data"]
    for idx in _buckets(tensors):
        mine = torch.cat([data_block(tensors[i], dims[i], mesh)
                          .movedim(dims[i], 0).reshape(-1) for i in idx])
        rows = mesh.all_gather(mine[None], "data")          # (ways, S)
        sizes = [tensors[i].numel() // ways for i in idx]
        for i, part in zip(idx, rows.split(sizes, dim=1)):
            tensors[i].copy_(_from_rows(part, tensors[i].shape, dims[i]))


def tp_join_grads_(grads, lay) -> None:
    """The model-axis half of the gradient join under the
    tensor-parallel layout, IN PLACE: a leaf replicated over ``model``
    summed over it (one all-reduce a bucket); a K/V leaf whose heads
    repeat over ranks or slots gets, in each copy, the sum of every
    copy's gradient (its logical head's gradient)."""
    flat = leaves_with_path(grads)
    whole = [g for path, g in flat if tp_leaf_rule(path, g)[0] == "whole"]
    all_reduce_mean_(whole, lay.mesh, tp_lib.AXIS, mean=False)
    if not lay.kv_shared:
        return
    rows = lay.kv_rows[lay.rank]
    idx = torch.tensor([max(r, 0) for r in rows])
    real = torch.tensor([r >= 0 for r in rows])
    for path, g in flat:
        kind, dim = tp_leaf_rule(path, g)
        if kind != "kv":
            continue
        h = g.unflatten(dim, (lay.kv_l, lay.cfg.head_dim))
        i, keep = idx.to(g.device), real.to(g.device)
        keep = keep.reshape((-1,) + (1,) * (h.ndim - dim - 1))
        shape = list(h.shape)
        shape[dim] = lay.cfg.n_kv_heads
        logical = h.new_zeros(shape).index_add_(dim, i,
                                                torch.where(keep, h, 0))
        logical = lay.mesh.all_reduce(logical, tp_lib.AXIS)
        h.copy_(torch.where(keep, logical.index_select(dim, i), 0))


def tp_split_mask(params, device) -> torch.Tensor:
    """(n_leaves,) bool: the leaves the layout splits over ``model``."""
    return torch.tensor([tp_leaf_rule(path, p)[0] != "whole"
                         for path, p in leaves_with_path(params)],
                        device=device)


def tp_sq_sums(grads, lay) -> torch.Tensor:
    """Per leaf, this rank's sum of squares of its gradient block, a K/V
    head counted on the rank that holds its first copy only."""
    owner = lay.kv_owner[lay.rank]
    out = []
    for path, g in leaves_with_path(grads):
        kind, dim = tp_leaf_rule(path, g)
        sq = torch.square(g.float())
        if kind == "kv" and lay.kv_shared:
            keep = torch.tensor(owner, device=g.device)
            sq = torch.where(keep.reshape((-1,) + (1,) * (g.ndim - dim)),
                             sq.unflatten(dim, (lay.kv_l, -1)), 0)
        out.append(torch.sum(sq))
    return torch.stack(out)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor],
                    mesh=None, grad_constraint=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).  ``params`` and the state are updated in place and returned;
    ``batch`` is {"tokens", "targets"}: (B, S) integer tensors on the
    params' device, and for an enc-dec model "frames" (B, T_enc, D).
    Metrics are 0-d tensors (no host read).

    Under a ``mesh`` whose data axes hold D > 1 ranks, ``batch`` is the
    global batch on every rank, and the step is the data-parallel one of
    the module's docstring (ZeRO-1 where ``opt_state`` holds blocks); a
    mesh of one data rank is the one-device step.  ``grad_constraint``
    (``launch/shardings.py::zero1_grad_constraint``, JAX's argument of
    the same name) joins the gradients by reduce-scatter; it needs a
    ZeRO-1 state."""
    axes = data_axes(mesh) if mesh is not None else ()
    tp_mesh = mesh             # the layout's mesh, where the caller enters it
    if mesh is not None and mesh.axis_size(axes) == 1:
        mesh = None
    if grad_constraint is not None and not isinstance(grad_constraint,
                                                      Zero1Grads):
        raise TypeError(f"unknown grad_constraint {grad_constraint!r}: "
                        "the port has the ZeRO-1 constraint "
                        "(launch/shardings.py::zero1_grad_constraint)")
    layout = []                      # each leaf's ZeRO-1 dim, or None

    def grads_of(params, batch):
        inputs = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(cfg, unflatten(params, inputs), batch, tc)
        grads = torch.autograd.grad(loss, inputs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(params, grads)

    def local_grads(params, batch):
        if tc.n_microbatches > 1:
            n = tc.n_microbatches
            mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            per_mb = []
            for mb in mbs:
                loss, metrics, g = grads_of(params, mb)
                for a, b in zip(leaves(g_sum), leaves(g)):
                    a.add_(b.float())
                loss_sum = loss_sum + loss
                per_mb.append(metrics)
            grads = tree_map(lambda g: true_div(g, n), g_sum)
            loss = true_div(loss_sum, n)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
            return loss, metrics, grads
        return grads_of(params, batch)

    def tp_layout():
        lay = tp_lib.layout(cfg)
        if lay is not None and lay.mesh is not tp_mesh:
            raise ValueError("the tensor-parallel layout is on over another "
                             "mesh than the train step's")
        return lay

    def zero1_layout(params, opt_state) -> list:
        """Each leaf's ZeRO-1 dim where ``opt_state`` holds its block,
        else None (read once: the state's layout is fixed)."""
        if not layout:
            for (path, p), m in zip(leaves_with_path(params),
                                    leaves(opt_state.master)):
                dim = (zero1_dim(path, p, mesh) if mesh is not None
                       else None)
                sharded = tuple(m.shape) != tuple(p.shape)
                if sharded and (dim is None or m.shape[dim] * mesh.shape[
                        "data"] != p.shape[dim]):
                    raise ValueError(f"optimizer state leaf {path} "
                                     f"{tuple(m.shape)} is not the ZeRO-1 "
                                     f"block of {tuple(p.shape)}")
                layout.append(dim if sharded else None)
        return layout

    def join(grads, dims: list):
        """The gradients joined over the data axes: whole leaves, and
        under ZeRO-1 (``dims``) this rank's blocks of the sharded ones."""
        flat = leaves(grads)
        if grad_constraint is None or all(d is None for d in dims):
            all_reduce_mean_(flat, mesh, axes)
            return unflatten(grads, [
                g if d is None else data_block(g, d, mesh)
                for g, d in zip(flat, dims)])
        whole = [i for i, d in enumerate(dims) if d is None]
        all_reduce_mean_([flat[i] for i in whole], mesh, axes)
        cut = [i for i, d in enumerate(dims) if d is not None]
        blocks = reduce_scatter_mean([flat[i] for i in cut],
                                     [dims[i] for i in cut], mesh, axes)
        out = list(flat)
        for i, b in zip(cut, blocks):
            out[i] = b
        return unflatten(grads, out)

    def meshed_grads(params, batch, dims, lay=None):
        rules_mesh = mesh if mesh is not None else lay.mesh
        if mesh is not None:
            batch = rank_rows(batch, tc.n_microbatches, mesh)
        with axis_rules(TRAIN_RULES, rules_mesh):
            loss, metrics, grads = local_grads(params, batch)
        if lay is not None:
            tp_join_grads_(grads, lay)
        if mesh is None:
            return loss, metrics, grads
        grads = join(grads, dims)
        means = all_reduce_mean_(
            [torch.stack([loss.float()] + [metrics[k].float()
                                           for k in METRIC_KEYS[1:]])],
            mesh, axes)[0]
        metrics = dict(zip(METRIC_KEYS[1:], means[1:]))
        return means[0], metrics, grads

    def joined_sq_sums(grads, dims, lay=None) -> torch.Tensor:
        """Per leaf, the sum of squares of the whole gradient: the
        blocks' joined over ``data`` (one all-reduce of the (n_leaves,)
        sums) and, under the layout, a split leaf's over ``model``; a
        whole leaf's its own."""
        if lay is None:
            local = torch.stack([torch.sum(torch.square(g.float()))
                                 for g in leaves(grads)])
        else:
            local = tp_sq_sums(grads, lay)
            split = tp_split_mask(grads, local.device)
            local = torch.where(split, lay.mesh.all_reduce(
                torch.where(split, local, 0.0), tp_lib.AXIS), local)
        if all(d is None for d in dims):
            return local
        cut = torch.tensor([d is not None for d in dims],
                           device=local.device)
        joined = mesh.all_reduce(torch.where(cut, local, 0.0), "data")
        return torch.where(cut, joined, local)

    def joined_norms(grads, dims, lay=None) -> torch.Tensor:
        """Per leaf, the norm of the whole gradient: a whole leaf's as
        ``clip_by_quantile`` takes it, a sharded one's from the joined
        sums of squares."""
        whole = torch.stack([torch.linalg.vector_norm(g.float().reshape(-1))
                             for g in leaves(grads)])
        cut = torch.tensor([d is not None for d in dims],
                           device=whole.device)
        if lay is not None:
            cut = cut | tp_split_mask(grads, whole.device)
        return torch.where(cut, torch.sqrt(joined_sq_sums(grads, dims, lay)),
                           whole)

    def train_step(params, opt_state: AdamWState, batch):
        lay = tp_layout()
        dims = zero1_layout(params, opt_state)
        zero1 = any(d is not None for d in dims)
        if mesh is not None or lay is not None:
            loss, metrics, grads = meshed_grads(params, batch, dims, lay)
        else:
            loss, metrics, grads = local_grads(params, batch)

        if tc.clip_mode == "quantile":
            norms = policy = None
            if zero1 or lay is not None:
                norms = joined_norms(grads, dims, lay)
            if zero1:
                policy = MeshPolicy(mesh, vocab_axis="data", data_axes=())
            grads, _ = clip_by_quantile(grads, 0.95, norms=norms,
                                        policy=policy)
        else:
            norm = (torch.sqrt(joined_sq_sums(grads, dims, lay).sum())
                    if zero1 or lay is not None else None)
            grads, gnorm = clip_by_global_norm(grads, tc.clip_norm,
                                               norm=norm)
            metrics = {**metrics, "grad_norm": gnorm}

        lr = lr_fn(opt_state.step)
        targets = (unflatten(params, [
            p if d is None else data_block(p, d, mesh)
            for p, d in zip(leaves(params), dims)]) if zero1 else params)
        _, opt_state = adamw_update(
            grads, opt_state, lr,
            b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
            compress=tc.compress, params=targets,
        )
        if zero1:
            cut = [i for i, d in enumerate(dims) if d is not None]
            flat = leaves(params)
            all_gather_blocks_([flat[i] for i in cut],
                               [dims[i] for i in cut], mesh)
        metrics = {**metrics, "loss": loss, "lr": lr}
        return params, opt_state, metrics

    return train_step
