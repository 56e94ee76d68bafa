"""Mixture-of-Experts layer (qwen2-moe, granite-moe), sort-free dispatch
(port of ``repro.models.moe``).

Routing: an f32 softmax router over the real experts (padded experts
masked to -inf), top-k selection with the gates renormalised, and the
expert products as einsums over the stacked, padded expert weights with
``cap`` slots an expert.

Capacity, two modes:

  * ``"fifo"``: GShard's drop.  An assignment's position in its expert is
    its arrival order (an exclusive cumsum over the token-major
    assignments ``a = t * k + j``); past ``cap`` it drops.
  * ``"bisect"``: the paper's technique.  Each expert's gate threshold
    tau_e with count(score > tau_e) < cap is a runahead-bisection solve
    on the (e_pad, A) masked score matrix, the experts riding the
    engine's batch axis (``core/applications.py::capacity_threshold``);
    the highest-scoring assignments are kept.  On the ``"hopper"``
    backend the solve is one launch of K3 (``kernels/ops.py::
    runahead_topk_threshold``) on CUDA tensors, its plain version on CPU
    ones; the bracket is the ``"torch"`` backend's bit for bit.

Dropped assignments go to the dump slot ``e_pad * cap``.  Nothing here
reads the device back to the host, so a decode step holding this layer
can be captured in a CUDA graph.  Where the JAX package scatter-adds a
token's k expert outputs (``.at[a_token].add``), the port sums the
(T, k, D) view in assignment order, deterministic on every device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.applications import capacity_threshold
from repro_torch.core.solver import true_div
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = dict


def padded_experts(n_experts: int, shard_multiple: int = 16) -> int:
    """Experts padded to the mesh-axis multiple (60 -> 64, 40 -> 48)."""
    return -(-n_experts // shard_multiple) * shard_multiple


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             lead: tuple = ()) -> Params:
    """The JAX package's shapes and scales (``lead`` prepends a run's layer
    axis): router (d, e_pad), stacked experts (e_pad, d, f) / (e_pad, f,
    d), and a fused shared SwiGLU of n_shared_experts * f units."""
    d, f = cfg.d_model, cfg.d_ff
    e_pad = padded_experts(cfg.n_experts)

    def experts(*shape):
        # drawn one layer at a time: a run's f32 draw at full width would
        # take twice the bf16 weights' memory again
        w = torch.empty(lead + shape, dtype=dtype, device=gen.device)
        for w_l in w.view((-1,) + shape):
            w_l.copy_(torch.randn(shape, generator=gen, device=gen.device,
                                  dtype=torch.float32).mul_(0.02))
        return w

    p = {
        "router": dense_init(gen, d, e_pad, dtype, scale=0.02, lead=lead),
        "w_gate": experts(e_pad, d, f),
        "w_up": experts(e_pad, d, f),
        "w_down": experts(e_pad, f, d),
    }
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * f
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, dtype, lead=lead),
            "w_up": dense_init(gen, d, fs, dtype, lead=lead),
            "w_down": dense_init(gen, fs, d, dtype, lead=lead),
        }
    return p


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor        # switch-style load-balance loss
    dropped_frac: torch.Tensor    # fraction of assignments dropped


def _capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    return max(4, int(math.ceil(tokens * top_k * factor / n_experts)))


def _bisect_keep(scores: torch.Tensor, expert_id: torch.Tensor, e_pad: int,
                 cap: int, backend: str = "hopper") -> torch.Tensor:
    """Per-expert gate threshold by runahead bisection.

    scores: (A,) assignment gates in (0, 1]; expert_id: (A,) integer.
    Returns keep (A,) bool: the top-scoring assignments of each expert,
    fewer than ``cap`` of them where its demand exceeds ``cap``, all of
    them where it does not.
    """
    experts = torch.arange(e_pad, device=scores.device)
    mine = expert_id[None, :] == experts[:, None]                # (E, A)
    masked = torch.where(mine, scores[None, :], -1.0)
    taus = capacity_threshold(masked, cap, rounds=6, spec_k=5,
                              backend=backend)                   # (E,)
    # an expert under capacity may have no count == cap crossing inside
    # the score range: keep everything by thresholding below all gates
    demand = mine.sum(dim=-1)
    taus = torch.where(demand <= cap, -1.0, taus)
    return scores > taus[expert_id]


def _dispatch_group(p: Params, cfg: ModelConfig, xt: torch.Tensor, cap: int,
                    capacity_mode: str, solver_backend: str = "hopper"):
    """Route one token group (T, D) into expert slots.

    Returns (expert_in (e_pad, cap, D), slot, keep, a_gate, aux, dropped).
    """
    T, D = xt.shape
    E = cfg.n_experts
    e_pad = padded_experts(E)
    k = cfg.moe_top_k
    dev = xt.device

    # -- router (f32) --------------------------------------------------------
    logits = (xt @ p["router"].to(xt.dtype)).float()
    pad_mask = torch.arange(e_pad, device=dev) >= E
    logits = torch.where(pad_mask[None, :], float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)                        # (T, e_pad)

    # lax.top_k order: descending, the lower index first among equals
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[:, :k], order.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # -- assignments, token-major (A = T * k) --------------------------------
    a_expert = gate_idx.reshape(-1)                              # (A,)
    a_gate = gate_vals.reshape(-1).float()

    if capacity_mode == "bisect":
        keep = _bisect_keep(a_gate, a_expert, e_pad, cap, solver_backend)
    elif capacity_mode == "fifo":
        keep = torch.ones_like(a_gate, dtype=torch.bool)
    else:
        raise ValueError(f"unknown capacity_mode {capacity_mode!r}")

    # the one-hot laid out (e_pad, A): the arrival-order cumsum runs along
    # each expert's row, where the card scans in parallel (along the long
    # A axis of an (A, e_pad) layout it scans 48-64 columns serially)
    experts = torch.arange(e_pad, device=dev)[:, None]
    onehot = ((a_expert[None, :] == experts) & keep[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # exclusive
    a_pos = pos.gather(0, a_expert[None, :])[0]
    keep = keep & (a_pos < cap)

    slot = torch.where(keep, a_expert * cap + a_pos, e_pad * cap)

    xa = xt.repeat_interleave(k, dim=0)                          # (A, D)
    buf = xt.new_zeros((e_pad * cap + 1, D))
    buf = buf.index_put((slot,), torch.where(keep[:, None], xa, 0))
    expert_in = buf[:-1].reshape(e_pad, cap, D)

    chosen = torch.zeros((T, e_pad), dtype=torch.float32, device=dev)
    chosen = chosen.scatter(1, gate_idx, 1.0)
    token_frac = torch.mean((chosen > 0).float(), dim=0)
    prob_frac = torch.mean(probs, dim=0)
    aux = float(E) * torch.sum(token_frac * prob_frac)
    dropped = 1.0 - torch.mean(keep.float())
    return expert_in, slot, keep, a_gate, aux, dropped


def _combine_group(expert_out: torch.Tensor, slot: torch.Tensor,
                   keep: torch.Tensor, a_gate: torch.Tensor, T: int,
                   k: int) -> torch.Tensor:
    """Expert outputs back to token order for one group: each token's k
    gated outputs summed in assignment order."""
    e_cap = expert_out.shape[0] * expert_out.shape[1]
    flat = expert_out.reshape(e_cap, expert_out.shape[2])
    # index_select, not advanced indexing: every dropped assignment reads
    # the clamped last slot, and advanced indexing's backward sums those
    # duplicates one after another (an index_select's backward adds them
    # at once; they are zeros, the gate of a dropped assignment being 0)
    a_out = flat.index_select(0, slot.clamp(0, e_cap - 1))
    a_out = a_out * (a_gate * keep)[:, None].to(expert_out.dtype)
    a_out = a_out.reshape(T, k, -1)
    out = a_out[:, 0]
    for j in range(1, k):
        out = out + a_out[:, j]
    return out


def moe_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                # (B, S, D)
    *,
    capacity_mode: str = "fifo",    # "fifo" | "bisect"
    n_groups: int = 1,              # GShard groups (data-parallel shards)
    solver_backend: str = "hopper",  # engine backend of the bisect solve
) -> tuple[torch.Tensor, MoEStats]:
    B, S, D = x.shape
    T = B * S
    E = cfg.n_experts
    k = cfg.moe_top_k
    if T % n_groups:
        n_groups = 1
    tg = T // n_groups
    cap = _capacity(tg, E, k, cfg.capacity_factor)
    groups = [_dispatch_group(p, cfg, xt, cap, capacity_mode, solver_backend)
              for xt in x.reshape(n_groups, tg, D)]
    expert_in = torch.stack([g[0] for g in groups])         # (G, E, cap, D)

    g = torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))

    out = torch.stack([
        _combine_group(eo, slot, keep, a_gate, tg, k)
        for eo, (_, slot, keep, a_gate, _, _) in zip(expert_out, groups)])
    out = out.reshape(B, S, D)

    # -- shared experts (one fused SwiGLU) -----------------------------------
    if cfg.n_shared_experts > 0:
        sp = p["shared"]
        xt = x.reshape(T, D)
        sg = xt @ sp["w_gate"].to(x.dtype)
        su = xt @ sp["w_up"].to(x.dtype)
        out = out + ((F.silu(sg) * su) @ sp["w_down"].to(x.dtype)
                     ).reshape(B, S, D)

    aux = true_div(torch.stack([g[4] for g in groups]).sum(), n_groups)
    dropped = true_div(torch.stack([g[5] for g in groups]).sum(), n_groups)
    return out, MoEStats(aux_loss=aux, dropped_frac=dropped)
