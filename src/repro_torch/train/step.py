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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.solver import true_div
from repro_torch.distributed.sharding import TRAIN_RULES, axis_rules
from repro_torch.launch.mesh import data_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, clip_by_quantile
from repro_torch.tree import leaves, tree_map, unflatten


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
    logz = torch.logsumexp(logits, dim=-1)                  # (B, S)
    tgt_logit = logits.gather(-1, targets[..., None])[..., 0]
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


def all_reduce_mean_(tensors: list, mesh, axes) -> list:
    """Each tensor replaced IN PLACE by its mean over the ranks of
    ``axes``: one sum all-reduce per bucket (consecutive tensors of one
    dtype, at most ``GRAD_BUCKET_BYTES``), each counted in
    ``mesh.stats``, then a true division by the rank count.  Every rank
    ends with the same bits.  Returns ``tensors``."""
    ways = mesh.axis_size(axes)
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
    for idx in buckets:
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = true_div(mesh.all_reduce(flat, axes), ways)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            tensors[i].copy_(part.view(tensors[i].shape))
    return tensors


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor],
                    mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).  ``params`` and the state are updated in place and returned;
    ``batch`` is {"tokens", "targets"}: (B, S) integer tensors on the
    params' device, and for an enc-dec model "frames" (B, T_enc, D).
    Metrics are 0-d tensors (no host read).

    Under a ``mesh`` whose data axes hold D > 1 ranks, ``batch`` is the
    global batch on every rank, and the step is the data-parallel one of
    the module's docstring; a mesh of one data rank is the one-device
    step."""
    axes = data_axes(mesh) if mesh is not None else ()
    if mesh is not None and mesh.axis_size(axes) == 1:
        mesh = None

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

    def meshed_grads(params, batch):
        with axis_rules(TRAIN_RULES, mesh):
            loss, metrics, grads = local_grads(
                params, rank_rows(batch, tc.n_microbatches, mesh))
        all_reduce_mean_(leaves(grads), mesh, axes)
        means = all_reduce_mean_(
            [torch.stack([loss.float()] + [metrics[k].float()
                                           for k in METRIC_KEYS[1:]])],
            mesh, axes)[0]
        metrics = dict(zip(METRIC_KEYS[1:], means[1:]))
        return means[0], metrics, grads

    def train_step(params, opt_state: AdamWState, batch):
        if mesh is not None:
            loss, metrics, grads = meshed_grads(params, batch)
        else:
            loss, metrics, grads = local_grads(params, batch)

        if tc.clip_mode == "quantile":
            grads, _ = clip_by_quantile(grads, 0.95)
        else:
            grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
            metrics = {**metrics, "grad_norm": gnorm}

        lr = lr_fn(opt_state.step)
        params, opt_state = adamw_update(
            grads, opt_state, lr,
            b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
            compress=tc.compress, params=params,
        )
        metrics = {**metrics, "loss": loss, "lr": lr}
        return params, opt_state, metrics

    return train_step
