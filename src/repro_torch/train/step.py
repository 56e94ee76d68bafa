"""Training step: CE loss, microbatch gradient accumulation, clipping,
AdamW (port of ``repro.train.step``).

One device, eager: the gradients come from ``torch.autograd.grad`` over
the compute params, accumulate over microbatches in f32, are clipped by
the global norm or by the quantile clip (whose solve runs K2 on the
card), and AdamW updates the master weights, moments and compute params
in place (``optim/adamw.py``).  Remat is one checkpoint per layer
(``models/transformer.py::forward``); at ``S >= 4096`` each layer's
attention forward is K7 (``kernels/ops.py::flash_fwd``).

The dense family only: ``capacity_mode`` and ``moe_groups`` are kept so
that the config equals JAX's field for field, but a non-dense family
raises until the MoE and mixer layers are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.solver import true_div
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, clip_by_quantile
from repro_torch.tree import leaves, tree_map, unflatten

DENSE_FAMILIES = ("dense", "vlm")


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
    """CE + z-loss (+ the aux term, 0 for dense) over f32 logits.

    The target logit is a gather: the JAX function's masked sum
    (``step.py:69-76``) adds only zeros beside it, so the value is the
    same, without a second (B, S, V) buffer.
    """
    logits, aux = forward(cfg, params, batch["tokens"], remat=tc.remat)
    targets = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)                  # (B, S)
    tgt_logit = logits.gather(-1, targets[..., None])[..., 0]
    ce = torch.mean(logz - tgt_logit)
    z_loss = torch.mean(torch.square(logz))
    aux_term = true_div(tc.aux_weight * aux, max(cfg.n_layers, 1))
    loss = ce + tc.z_weight * z_loss + aux_term
    return loss, {"ce": ce, "z_loss": z_loss, "aux": aux}


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).  ``params`` and the state are updated in place and returned;
    ``batch`` is {"tokens", "targets"}: (B, S) integer tensors on the
    params' device.  Metrics are 0-d tensors (no host read)."""
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"training family {cfg.family!r} is not ported yet (dense only)")

    def grads_of(params, batch):
        inputs = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(cfg, unflatten(params, inputs), batch, tc)
        grads = torch.autograd.grad(loss, inputs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(params, grads)

    def train_step(params, opt_state: AdamWState, batch):
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
        else:
            loss, metrics, grads = grads_of(params, batch)

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
