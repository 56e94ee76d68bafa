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

Dropped assignments go to a dump slot past the experts'.  On one device
nothing here reads the device back to the host, so a decode step holding
this layer can be captured in a CUDA graph.  Under a data split of the
batch over ranks (``batch_split``) each rank cuts capacity over the whole
batch and runs the experts on its own kept tokens (``_dispatch``).  Where the JAX package scatter-adds a
token's k expert outputs (``.at[a_token].add``), the port sums the
(T, k, D) view in assignment order, deterministic on every device.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.applications import capacity_threshold
from repro_torch.core.solver import true_div
from repro_torch.distributed.sharding import (
    current_rules,
    resolve_axes,
    resolved_axis_size,
)
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


def _route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """The f32 router over tokens (T, D): (probs (T, e_pad), gate_idx and
    the renormalised gate_vals (T, k)) in ``lax.top_k``'s order."""
    e_pad = padded_experts(cfg.n_experts)
    logits = (xt @ p["router"].to(xt.dtype)).float()
    pad_mask = torch.arange(e_pad, device=xt.device) >= cfg.n_experts
    logits = torch.where(pad_mask[None, :], float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)                        # (T, e_pad)

    # lax.top_k order: descending, the lower index first among equals
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gate_vals, gate_idx = order.values[:, :k], order.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_idx, gate_vals


def _cut(a_expert: torch.Tensor, a_gate: torch.Tensor, e_pad: int, cap: int,
         capacity_mode: str, solver_backend: str):
    """The capacity cut of one group's token-major assignments: (keep
    (A,) bool, a_pos (A,) the arrival position in its expert)."""
    if capacity_mode == "bisect":
        keep = _bisect_keep(a_gate, a_expert, e_pad, cap, solver_backend)
    elif capacity_mode == "fifo":
        keep = torch.ones_like(a_gate, dtype=torch.bool)
    else:
        raise ValueError(f"unknown capacity_mode {capacity_mode!r}")

    # the one-hot laid out (e_pad, A): the arrival-order cumsum runs along
    # each expert's row, where the card scans in parallel (along the long
    # A axis of an (A, e_pad) layout it scans 48-64 columns serially)
    experts = torch.arange(e_pad, device=a_expert.device)[:, None]
    onehot = ((a_expert[None, :] == experts) & keep[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # exclusive
    a_pos = pos.gather(0, a_expert[None, :])[0]
    return keep & (a_pos < cap), a_pos


def _combine(expert_out: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, a_gate: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """Expert outputs (slots, cap, D) back to token order: each token's k
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


class BatchSplit(NamedTuple):
    """The data split of a step's batch: each of ``ways`` ranks of the
    mesh's ``axes`` holds an equal block of rows, rank ``index``'s block
    ``index``-th in the global row order."""

    mesh: Any
    axes: tuple[str, ...]
    ways: int
    index: int


NO_SPLIT = BatchSplit(None, (), 1, 0)     # the whole batch on this device


def batch_split() -> BatchSplit:
    """The split the active ``axis_rules`` give the logical "batch" axis
    (``distributed/sharding.py``); ``NO_SPLIT`` where no rules are active
    or the batch is not split."""
    active = current_rules()
    if active is None:
        return NO_SPLIT
    rules, mesh = active
    axes = resolve_axes(mesh, rules, "batch")
    ways = resolved_axis_size(mesh, axes)
    if ways == 1:
        return NO_SPLIT
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return BatchSplit(mesh, axes, ways, mesh.axis_index(axes))


class Dispatch(NamedTuple):
    """A routing call's dispatch of this rank's tokens (``_dispatch``)."""

    expert_in: torch.Tensor     # (n_lg, e_pad, cap_l, D) expert slots
    slot: torch.Tensor          # (A_l,) each assignment's slot, or the dump
    keep: torch.Tensor          # (A_l,) bool
    a_gate: torch.Tensor        # (A_l,) f32, differentiable
    probs: torch.Tensor         # (T_l, e_pad) f32 router probabilities
    g_expert: torch.Tensor      # (G, A_g) the whole batch's expert ids
    keep_all: torch.Tensor      # (G, A_g) the whole batch's keep mask


def _dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity_mode: str, n_groups: int, solver_backend: str,
              split: BatchSplit) -> Dispatch:
    """Route this rank's tokens ``x`` (B, S, D) and cut capacity over the
    whole batch's GShard groups.

    Capacity couples every token of a group, and under a ``split`` a
    group spans ranks (one group, JAX's default, spans them all).  So
    each rank gathers every rank's assignments (expert id and f32 gate:
    A * 8 bytes; rank-major order is the global token-major order) and
    runs the capacity cut (K3 under ``"bisect"``) and the FIFO positions
    on the global assignments: every rank computes the single-device keep
    mask bit for bit, and keeps its own slice of it.  The expert SwiGLUs
    act row by row, so a rank packs only its own kept assignments, each
    at its position among them in its (group, expert), into ``cap_l``
    slots per (group, expert) of the groups it holds rows of.  Without a
    split ``cap_l`` is the capacity and the layout JAX's (group-major
    ``g * e_pad * cap + e * cap + pos``), with no read of the device, so
    a decode step holding the layer can be captured in a CUDA graph;
    under one, ``cap_l`` is the largest count this rank keeps in one
    (group, expert), read back to size its buffer.
    """
    B, S, D = x.shape
    T_l = B * S
    T = T_l * split.ways
    E = cfg.n_experts
    e_pad = padded_experts(E)
    k = cfg.moe_top_k
    if T % n_groups:
        n_groups = 1
    tg = T // n_groups
    cap = _capacity(tg, E, k, cfg.capacity_factor)
    dev = x.device

    xt = x.reshape(T_l, D)
    probs, gate_idx, gate_vals = _route(p, cfg, xt)
    # -- assignments, token-major (A = T * k) --------------------------------
    a_expert = gate_idx.reshape(-1)                              # (A_l,)
    a_gate = gate_vals.reshape(-1).float()
    g_expert, g_gate = a_expert, a_gate.detach()
    if split.ways > 1:
        both = torch.stack([a_expert.float(), g_gate], dim=1)
        both = split.mesh.all_gather(both, split.axes)           # (A, 2)
        g_expert, g_gate = both[:, 0].long(), both[:, 1]
    cuts = [_cut(e, g, e_pad, cap, capacity_mode, solver_backend)
            for e, g in zip(g_expert.reshape(n_groups, tg * k),
                            g_gate.reshape(n_groups, tg * k))]
    keep_all = torch.stack([c[0] for c in cuts])                 # (G, A_g)
    pos_all = torch.cat([c[1] for c in cuts])                    # (A,)

    # this rank's rows: tokens [t0, t0 + T_l), in the groups g0, g0 + 1, ..
    t0 = split.index * T_l
    g0 = t0 // tg
    n_lg = (t0 + T_l - 1) // tg - g0 + 1
    lo, hi = t0 * k, (t0 + T_l) * k
    keep = keep_all.reshape(-1)[lo:hi]
    a_pos = pos_all[lo:hi]
    a_group = (torch.arange(t0, t0 + T_l, device=dev) // tg - g0
               ).repeat_interleave(k)
    first = g0 * tg * k
    if first < lo:
        # a kept assignment's global position counts its group's kept
        # assignments of its expert on earlier ranks too
        earlier = torch.zeros(e_pad, dtype=a_pos.dtype, device=dev)
        earlier = earlier.scatter_add(
            0, g_expert[first:lo], keep_all.reshape(-1)[first:lo].to(
                a_pos.dtype))
        a_pos = a_pos - torch.where(a_group == 0, earlier[a_expert], 0)
    key = a_group * e_pad + a_expert
    cap_l = cap
    if split.ways > 1:
        counts = torch.zeros(n_lg * e_pad, dtype=torch.int32, device=dev)
        counts = counts.scatter_add(0, key, keep.to(torch.int32))
        cap_l = max(1, int(counts.max()))
    n_slots = n_lg * e_pad * cap_l
    slot = torch.where(keep, key * cap_l + a_pos, n_slots)

    xa = xt.repeat_interleave(k, dim=0)                          # (A_l, D)
    buf = xt.new_zeros((n_slots + 1, D))
    buf = buf.index_put((slot,), torch.where(keep[:, None], xa, 0))
    return Dispatch(buf[:-1].reshape(n_lg, e_pad, cap_l, D), slot, keep,
                    a_gate, probs, g_expert.reshape(n_groups, tg * k),
                    keep_all)


def moe_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                # (B, S, D)
    *,
    capacity_mode: str = "fifo",    # "fifo" | "bisect"
    n_groups: int = 1,              # GShard groups (data-parallel shards)
    solver_backend: str = "hopper",  # engine backend of the bisect solve
    split: BatchSplit = NO_SPLIT,
) -> tuple[torch.Tensor, MoEStats]:
    """The MoE layer on ``x``: the whole batch, or under a ``split``
    (``batch_split()``) this rank's block of the batch's rows, the layer
    computing the whole batch's function (``_dispatch``).

    The keep mask carries no gradient; the gates stay local and
    differentiable.  The load-balance term: each rank takes ``ways / G *
    E * sum_g sum_e tf_g[e] * pf_g,local[e]`` with the token fractions
    ``tf_g`` from the whole batch's expert ids and ``pf_g,local`` this
    rank's share of the group's mean router probability; the mean over
    ranks (the train step averages the gradients over them) is JAX's ``E
    * sum tf * pf``, averaged over groups, in value and gradient.
    ``dropped_frac`` comes from the whole batch's mask, the same on every
    rank.
    """
    B, S, D = x.shape
    T_l = B * S
    k = cfg.moe_top_k
    d = _dispatch(p, cfg, x, capacity_mode, n_groups, solver_backend, split)
    n_groups, a_g = d.keep_all.shape
    tg = a_g // k
    g = torch.einsum("gecd,edf->gecf", d.expert_in, p["w_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", d.expert_in, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))
    out = _combine(expert_out.flatten(0, 1), d.slot, d.keep, d.a_gate,
                   T_l, k).reshape(B, S, D)

    # -- shared experts (one fused SwiGLU) -----------------------------------
    if cfg.n_shared_experts > 0:
        sp = p["shared"]
        xt = x.reshape(T_l, D)
        sg = xt @ sp["w_gate"].to(x.dtype)
        su = xt @ sp["w_up"].to(x.dtype)
        out = out + ((F.silu(sg) * su) @ sp["w_down"].to(x.dtype)
                     ).reshape(B, S, D)

    # load balance: the whole batch's token fractions, this rank's
    # probability mass
    e_pad = d.probs.shape[1]
    chosen = torch.zeros((n_groups * tg, e_pad), dtype=torch.float32,
                         device=x.device)
    chosen = chosen.scatter(1, d.g_expert.reshape(-1, k), 1.0)
    token_frac = torch.mean((chosen > 0).float().reshape(n_groups, tg, e_pad),
                            dim=1)                               # (G, e_pad)
    t0 = split.index * T_l
    terms = []
    for g in range(t0 // tg, (t0 + T_l - 1) // tg + 1):
        lo, hi = max(g * tg, t0) - t0, min((g + 1) * tg, t0 + T_l) - t0
        part = true_div(d.probs[lo:hi].sum(dim=0), tg)
        terms.append(torch.sum(token_frac[g] * part))
    aux = true_div(float(cfg.n_experts) * split.ways
                   * torch.stack(terms).sum(), n_groups)
    dropped = true_div((1.0 - d.keep_all.float().mean(dim=1)).sum(),
                       n_groups)
    return out, MoEStats(aux_loss=aux, dropped_frac=dropped)
