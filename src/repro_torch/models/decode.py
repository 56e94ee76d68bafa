"""Decode path: cache init, prefill, single-token decode step, the
slotted cache of continuous batching and the paged KV cache (port of
``repro.models.decode``).

A MoE block is a dense block whose MLP is ``models/moe.py::moe_apply``
(``capacity_mode`` ``"fifo"`` or ``"bisect"``, as the JAX functions carry
it).  Its capacity couples a step's batch rows, free slots included.  The
paged cache and the speculative verify stay dense-only, as in JAX
(``paged_supported``, ``verify_supported``): recurrent state has no page
structure and no per-position checkpoints to roll back.

Cache layout mirrors the layer plan: a list with one entry per run, each
a dict of NamedTuples whose tensors carry the run's leading layer axis,
then the batch:
  dense / moe      {"kv": KVCache}, (L, B, C, n_kv, head_dim) each
  hymba_global     {"kv", "ssm": SSMState}, C = the context
  hymba_swa        {"kv", "ssm"}, a ring of C = min(window, context)
  mlstm / slstm    {"state": MLSTMState | SLSTMState}, O(1) in the context
  whisper_dec      {"kv", "enc_k", "enc_v"}: the self-attention ring and
                   the encoder's K/V (L, B, T_enc, n_kv, head_dim), which
                   the prefill writes and the steps only read
int8 K/V (``dtype=torch.int8``; dense ring only, as in JAX): a
``KVCache`` of int8 codes with f16 scales; the encoder K/V and the SSM's
conv tail stay in the compute dtype, as JAX's one-shot prefill keeps
them.  A page pool replaces ``(B, C)`` by ``(n_pages, page_size)``.  A Python
loop over the layer axis replaces ``lax.scan``.  Every function here
writes caches and pools IN PLACE (the JAX functions return new ones); the
returned cache is the same object, its tensors the same storage, which
is what a CUDA graph of a decode step needs (it holds them by address).
That is why the dense continuous step freezes inactive lanes without a
copy of the pre-step cache: a ring row is stashed and restored
(``cache_lanes`` / ``freeze_cache_lanes``), and a recurrent state, which
a step rewrites whole, is written as ``where(active, new, old)`` in place
(``decode_step(active=...)``).  The speculative verify
(``decode_verify`` / ``decode_verify_paged``: L rows per slot in one
forward) returns a stash of the rows it overwrote, which
``rollback_cache_runs`` / ``rollback_paged_runs`` put back for rejected
drafts.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, embed, unembed
from repro_torch.models.transformer import (
    HYMBA_KINDS,
    XLSTM_KINDS,
    apply_ffn,
    embed_tokens,
    encoder_output,
    hymba_mix,
    hymba_window,
    layer_plan,
    layer_unbind,
    ported_plan,
    unembed_table,
)
from repro_torch.tree import leaves_with_path, tree_map

Params = dict
Cache = list


def _kv_capacity(kind: str, cfg: ModelConfig, context: int) -> int:
    if kind == "hymba_swa":
        return min(cfg.sliding_window, context)
    return context


def init_cache(cfg: ModelConfig, batch: int, context: int,
               dtype=torch.bfloat16, *, device="cuda",
               encoder_len: int | None = None,
               compute_dtype=torch.bfloat16) -> Cache:
    """Zero cache sized for `context` tokens: K/V, the SSM's conv tail
    and whisper's encoder K/V (``encoder_len`` rows, by default the
    config's) in ``dtype``, recurrent states in f32.  With ``dtype``
    int8 the K/V rings hold codes and scales, and the conv tail and the
    encoder K/V are in ``compute_dtype``."""
    other = compute_dtype if dtype == torch.int8 else dtype
    cache: Cache = []
    for kind, count in ported_plan(cfg):
        lead = (count,)
        if kind in XLSTM_KINDS:
            cache.append({"state": xlstm_lib.MIXERS[kind].init_state(
                cfg, batch, device, lead)})
            continue
        entry = {"kv": attn_lib.init_kv_cache(
            cfg, batch, _kv_capacity(kind, cfg, context), dtype, device,
            lead=lead)}
        if kind in HYMBA_KINDS:
            entry["ssm"] = ssm_lib.init_ssm_state(
                cfg, batch, cfg.n_heads * cfg.head_dim, other, device, lead)
        if kind == "whisper_dec":
            shape = lead + (batch, encoder_len or cfg.encoder_len,
                            cfg.n_kv_heads, cfg.head_dim)
            entry["enc_k"] = torch.zeros(shape, dtype=other, device=device)
            entry["enc_v"] = torch.zeros(shape, dtype=other, device=device)
        cache.append(entry)
    return cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ring_fill(kv_full: torch.Tensor, cap: int) -> torch.Tensor:
    """Place the last min(S, cap) positions at ring slots pos % cap.

    kv_full: (B, S, n_kv, hd) -> (B, cap, n_kv, hd).
    """
    B, S, n_kv, hd = kv_full.shape
    if S <= cap:
        out = kv_full.new_zeros((B, cap, n_kv, hd))
        out[:, :S] = kv_full
        return out
    # tail row j holds position S - cap + j, which lives at slot
    # (S - cap + j) % cap: a rotation of the tail by (S - cap) % cap
    return torch.roll(kv_full[:, S - cap:], shifts=(S - cap) % cap, dims=1)


def _make_kv_entry(k: torch.Tensor, v: torch.Tensor, cap: int, kv_dtype
                   ) -> KVCache:
    """The ring-filled K/V of a prefill, quantized in int8 mode."""
    k, v = _ring_fill(k, cap), _ring_fill(v, cap)
    if kv_dtype != torch.int8:
        return KVCache(k=k, v=v)
    (kq, ks), (vq, vs) = attn_lib._quantize_kv(k), attn_lib._quantize_kv(v)
    return KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)


def _prefill_block(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, cap: int, capacity_mode: str,
                   moe_groups: int, encoder_out: torch.Tensor | None,
                   kv_dtype):
    """One block forward that also emits its cache entry: the ring-filled
    K/V (at the kind's capacity ``cap``; int8 codes and scales when
    ``kv_dtype`` is int8), the recurrent state after the prompt's last
    step, and whisper's encoder K/V in the compute dtype.  Returns (x,
    entry)."""
    eps = cfg.norm_eps
    if kind in XLSTM_KINDS:
        h = apply_norm(cfg.norm, p["ln"], x, eps)
        out, state = xlstm_lib.MIXERS[kind].apply(p[kind], cfg, h,
                                                  return_state=True)
        return x + out, {"state": state}
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    window = hymba_window(kind, cfg) if kind in HYMBA_KINDS else 0
    a, (k, v) = attn_lib.attend(p["attn"], cfg, h, positions, window=window,
                                return_kv=True)
    entry = {"kv": _make_kv_entry(k, v, cap, kv_dtype)}
    if kind in HYMBA_KINDS:
        s, entry["ssm"] = ssm_lib.ssm_apply(p["ssm"], cfg, h,
                                            return_state=True)
        return hymba_mix(cfg, p, x, a, s), entry
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    if kind == "whisper_dec":
        xa, (entry["enc_k"], entry["enc_v"]) = attn_lib.attend(
            p["xattn"], cfg, h, positions, causal=False, kv_src=encoder_out,
            return_kv=True)
        x = x + xa
        h = apply_norm(cfg.norm, p["ln3"], x, eps)
    out, _ = apply_ffn(cfg, p, h, capacity_mode=capacity_mode,
                       moe_groups=moe_groups)
    return x + out, entry


def _stack_layers(entries: list) -> dict:
    """Per-layer cache entries -> one entry with the layer axis in front."""
    return tree_map(lambda *xs: torch.stack(xs), entries[0], *entries[1:])


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (B, S)
    context: int,
    *,
    encoder_frames: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
    capacity_mode: str = "fifo",
    moe_groups: int = 1,
    kv_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Process the prompt; returns (last-position logits (B, V) f32, cache).

    Only the final position's logits are computed.  The cache holds K/V,
    the SSM's conv tail and whisper's encoder K/V in ``compute_dtype``,
    recurrent states in f32, as the JAX prefill does; with ``kv_dtype``
    int8 the K/V rings are quantized (codes and f16 scales).  A
    ``hymba_swa`` ring is filled at its own capacity, the prompt's last
    ``min(window, context)`` positions.  A MoE layer routes all B * S
    prompt tokens as one batch (``moe_groups`` GShard groups), so its
    capacity depends on B and S.  An enc-dec arch (whisper) takes its
    encoder's input frames (B, T_enc, D) as ``encoder_frames``.
    """
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    encoder_out = encoder_output(cfg, params, encoder_frames, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    cache: Cache = []
    for run_params, (kind, count) in zip(params["runs"], ported_plan(cfg)):
        cap = _kv_capacity(kind, cfg, context)
        entries = []
        for p_l in layer_unbind(run_params, count):
            x, entry = _prefill_block(kind, cfg, p_l, x, positions, cap,
                                      capacity_mode, moe_groups,
                                      encoder_out, kv_dtype)
            entries.append(entry)
        cache.append(_stack_layers(entries))
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, -1], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def write_state(old: tuple, new: tuple, active: torch.Tensor | None
                ) -> None:
    """A step's new recurrent state into ``old``'s tensors, in place:
    every lane, or with ``active`` (B,) bool only the active ones
    (``where(active, new, old)``), leaving an inactive lane's state bit
    for bit as it was."""
    for o, n in zip(old, new):
        if active is None:
            o.copy_(n)
        else:
            keep = active.reshape((-1,) + (1,) * (o.ndim - 1))
            torch.where(keep, n.to(o.dtype), o, out=o)


def _step_block(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
                pos, entry: dict, capacity_mode: str,
                active: torch.Tensor | None) -> torch.Tensor:
    """One block for one token.  x: (B, 1, D); entry: one layer's views of
    the run's cache entry, written in place (K/V at ``pos``, states
    through ``write_state``).  A MoE layer routes the B tokens as one
    group."""
    eps = cfg.norm_eps
    if kind in XLSTM_KINDS:
        h = apply_norm(cfg.norm, p["ln"], x, eps)
        out, state = xlstm_lib.MIXERS[kind].step(p[kind], cfg, h,
                                                 entry["state"])
        write_state(entry["state"], state, active)
        return x + out
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    window = hymba_window(kind, cfg) if kind in HYMBA_KINDS else 0
    a, _ = attn_lib.decode_attend(p["attn"], cfg, h, pos, entry["kv"],
                                  window=window)
    if kind in HYMBA_KINDS:
        s, state = ssm_lib.ssm_step(p["ssm"], cfg, h, entry["ssm"])
        write_state(entry["ssm"], state, active)
        return hymba_mix(cfg, p, x, a, s)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    if kind == "whisper_dec":
        x = x + attn_lib.decode_cross_attend(p["xattn"], cfg, h,
                                             entry["enc_k"], entry["enc_v"])
        h = apply_norm(cfg.norm, p["ln3"], x, eps)
    out, _ = apply_ffn(cfg, p, h, capacity_mode=capacity_mode)
    return x + out


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,               # (B,) current token
    pos,                               # int shared, or (B,) per-slot tensor
    cache: Cache,
    *,
    compute_dtype=torch.bfloat16,
    capacity_mode: str = "fifo",
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Cache]:
    """One decode step: returns (logits (B, V) f32, cache updated in place).

    ``pos`` is a Python int (every row at the same depth: one-shot
    ``generate``) or a (B,) device tensor (continuous batching: one
    position per slot, never read back to the host).  ``active`` (B,)
    bool, where given, keeps the recurrent state of every inactive lane
    bit for bit (the K/V row a lane writes is put back by
    ``freeze_cache_lanes``).  A learned position (whisper) is added as
    ``pos_embed[pos]``, a device index for a (B,) ``pos``.
    """
    x = embed(params["embed"], token[:, None], compute_dtype)  # (B, 1, D)
    if cfg.learned_pos:
        pe = params["pos_embed"][pos].to(compute_dtype)    # (B, D) or (D,)
        x = x + (pe[:, None] if isinstance(pos, torch.Tensor) else pe)
    for run_params, entry, (kind, count) in zip(params["runs"], cache,
                                                ported_plan(cfg)):
        for p_l, e_l in zip(layer_unbind(run_params, count),
                            layer_unbind(entry, count)):
            x = _step_block(kind, cfg, p_l, x, pos, e_l, capacity_mode,
                            active)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, 0], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# speculative verify (draft-and-verify decode)
# ---------------------------------------------------------------------------

def verify_supported(cfg: ModelConfig) -> bool:
    """Whether ``decode_verify`` can serve this arch: dense attention
    stacks only (recurrent layers would need per-position state to roll
    back, and MoE capacity cuts couple the grid's rows)."""
    return all(kind == "dense" for kind, _ in layer_plan(cfg))


def _verify_forward(cfg, params, tokens, state, attend, compute_dtype):
    """The shared layer loop of the verify forwards: ``attend(p_attn, h,
    kv_l)`` -> (out, stash of one layer).  Returns (logits (B, L, V) f32,
    per-run stashes with the run's layer axis in front)."""
    if not verify_supported(cfg):
        raise ValueError(
            "decode_verify supports dense layer stacks only (see "
            "verify_supported)")
    x = embed(params["embed"], tokens, compute_dtype)        # (B, L, D)
    stashes = []
    for run_params, entry, (_, count) in zip(params["runs"], state,
                                             layer_plan(cfg)):
        kept = []
        for p_l, kv_l in zip(layer_unbind(run_params, count),
                             layer_unbind(entry["kv"], count)):
            h = apply_norm(cfg.norm, p_l["ln1"], x, cfg.norm_eps)
            a, st = attend(p_l["attn"], h, kv_l)
            kept.append({"kv": st})
            x = x + a
            h = apply_norm(cfg.norm, p_l["ln2"], x, cfg.norm_eps)
            x = x + apply_mlp(cfg.act, p_l["mlp"], h)
        stashes.append(_stack_layers(kept))
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x, cfg.vocab)
    return logits, stashes


def decode_verify(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (B, L) current token + drafted run
    pos: torch.Tensor,                 # (B,) position of tokens[:, 0]
    cache: Cache,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache, list]:
    """Score a (B, L) token grid in one forward against the slotted cache.

    Row b feeds [t_0, d_1, .., d_{L-1}] at positions pos_b .. pos_b+L-1;
    ``logits[:, l]`` predicts the token at position pos+l+1 given that
    prefix: L serial decode steps answered by one forward.  All L K/V
    rows are written into the ring in place (the state L serial steps
    would leave); ``stash`` holds the overwritten rows, (layers, B, L,
    n_kv, hd) per run, for ``rollback_cache_runs``.  Returns (logits
    (B, L, V) f32, cache, stash).
    """
    def attend(p_attn, h, kv_l):
        a, _, st = attn_lib.decode_attend_multi(p_attn, cfg, h, pos, kv_l)
        return a, st

    logits, stash = _verify_forward(cfg, params, tokens, cache, attend,
                                    compute_dtype)
    return logits, cache, stash


def _restore_rows(leaf, old, index, keep):
    """leaf[:, *index] = where(keep, leaf[:, *index], old), in place;
    ``index`` selects (B, L) rows, ``keep`` is (B, L) bool."""
    cur = leaf[(slice(None),) + index]                       # (lyr,B,L,...)
    sel = keep.reshape((1,) + keep.shape + (1,) * (cur.ndim - 3))
    leaf[(slice(None),) + index] = torch.where(sel, cur, old)


def _keep_mask(n_keep: torch.Tensor, L: int) -> torch.Tensor:
    return (torch.arange(L, device=n_keep.device)[None, :]
            < n_keep[:, None])                               # (B, L)


def rollback_cache_runs(cache: Cache, stash: list, pos: torch.Tensor,
                        n_keep: torch.Tensor) -> Cache:
    """Put back the ring rows ``decode_verify`` wrote for rejected
    positions, in place.  ``n_keep`` (B,) commits each row's leading
    writes: 1 + accepted drafts for a live slot, 0 for an inactive one
    (which leaves it bit-identical to its pre-step state).  In int8 mode
    the scales go back with the codes."""
    for entry, st in zip(cache, stash):
        kv, old = entry["kv"], st["kv"]
        B, L = old.k.shape[1:3]
        slots = (pos[:, None] + torch.arange(L, device=pos.device)[None, :]
                 ) % kv.capacity                             # (B, L)
        rows = torch.arange(B, device=pos.device)[:, None]
        keep = _keep_mask(n_keep, L)
        for leaf, old_rows in zip(kv, old):
            if leaf is not None:
                _restore_rows(leaf, old_rows, (rows, slots), keep)
    return cache


# ---------------------------------------------------------------------------
# slotted cache (continuous batching)
# ---------------------------------------------------------------------------

def write_cache_slot(cache: Cache, sub: Cache, slot: int) -> Cache:
    """Overwrite batch row ``slot`` of ``cache`` with the B=1 cache ``sub``,
    in place: the admission path of the continuous scheduler.  Every leaf
    (K/V rings and their int8 scales, SSM and xLSTM states, whisper's
    encoder K/V) is laid out (layers, batch, ...), so one walk writes
    them all, each cast to the slotted cache's dtype.  An int8 ring takes
    int8 codes only (prefill with the slotted cache's ``kv_dtype``): a
    float leaf cast into it would be truncated to integers, as the JAX
    scheduler truncates it."""
    big_leaves, small_leaves = leaves_with_path(cache), leaves_with_path(sub)
    if [p for p, _ in big_leaves] != [p for p, _ in small_leaves] or any(
            (b.dtype == torch.int8) != (s.dtype == torch.int8)
            for (_, b), (_, s) in zip(big_leaves, small_leaves)):
        raise ValueError("the admitted cache's K/V mode differs from the "
                         "slotted cache's (prefill with its kv_dtype)")
    for (_, big), (_, small) in zip(big_leaves, small_leaves):
        big[:, slot] = small[:, 0]
    return cache


def prefill_into_slot(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (1, S) one request's prompt
    context: int,
    cache: Cache,
    slot: int,
    *,
    encoder_frames: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
    capacity_mode: str = "fifo",
    kv_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Prefill ONE request and land its state in batch row ``slot``.

    The prefill math is the ordinary ``prefill`` at B=1, so a request's
    state is the same whether it was admitted into a slot or served
    one-shot; ``context`` (and whisper's frame count) must match the
    slotted cache's capacity, ``kv_dtype`` its K/V dtype.  Returns
    (last-position logits (1, V) f32, cache).
    """
    logits, sub = prefill(cfg, params, tokens, context,
                          encoder_frames=encoder_frames,
                          compute_dtype=compute_dtype,
                          capacity_mode=capacity_mode, kv_dtype=kv_dtype)
    return logits, write_cache_slot(cache, sub, slot)


def _lane_index(kv: KVCache, pos: torch.Tensor) -> tuple:
    """The (layers, B) index of ring slot ``pos % C`` of every batch row."""
    rows = torch.arange(kv.k.shape[1], device=pos.device)
    return slice(None), rows, pos % kv.capacity


def cache_lanes(cache: Cache, pos: torch.Tensor) -> list:
    """The ring rows a per-slot ``decode_step`` at ``pos`` will overwrite:
    for each run, a ``KVCache`` of the rows at ring slot ``pos % C`` of
    every batch row, (layers, B, n_kv, hd) each (and the (layers, B,
    n_kv) scales in int8 mode); None for a run without K/V.  Recurrent
    states are not stashed: ``decode_step(active=...)`` writes only the
    active lanes', and whisper's encoder K/V is never written by a
    step."""
    out = []
    for entry in cache:
        kv = entry.get("kv")
        out.append(None if kv is None else
                   attn_lib._stash_rows(kv, _lane_index(kv, pos)))
    return out


def freeze_cache_lanes(cache: Cache, stash: list, pos: torch.Tensor,
                       active: torch.Tensor) -> Cache:
    """Bit-freeze inactive batch lanes after a per-slot step: restore the
    rows ``cache_lanes`` saved where ``~active``, in place.

    The JAX function selects the whole pre-step cache back in; a step
    writes exactly one ring slot per lane, so restoring that slot (and
    passing ``active`` to ``decode_step`` for the recurrent states) leaves
    an inactive lane bit-identical to its pre-step state.
    """
    for entry, rows_old in zip(cache, stash):
        if rows_old is None:
            continue
        kv = entry["kv"]
        index = _lane_index(kv, pos)
        for leaf, old in zip(kv, rows_old):
            if leaf is None:
                continue
            keep = active.reshape((1, -1) + (1,) * (old.ndim - 2))
            leaf[index] = torch.where(keep, leaf[index], old)
    return cache


# ---------------------------------------------------------------------------
# paged KV cache (page-table layout)
# ---------------------------------------------------------------------------

def paged_supported(cfg: ModelConfig) -> bool:
    """Whether the paged cache can serve this arch: dense attention stacks
    only (recurrent state has no page structure and SWA rings have their
    own capacity)."""
    return all(kind == "dense" for kind, _ in layer_plan(cfg))


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                    dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """Zero page pool, the paged dual of ``init_cache``: leaves are
    (layers, n_pages, page_size, n_kv, head_dim).  Page id 0 is the
    reserved null page."""
    if not paged_supported(cfg):
        raise ValueError(
            "paged KV cache supports dense layer stacks only (see "
            "paged_supported)")
    if dtype == torch.int8:
        raise ValueError("paged cache does not support int8 K/V")
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return [{"kv": KVCache(
        k=torch.zeros((count,) + shape, dtype=dtype, device=device),
        v=torch.zeros((count,) + shape, dtype=dtype, device=device))}
        for _, count in layer_plan(cfg)]


def mask_table_rows(table: torch.Tensor, active: torch.Tensor
                    ) -> torch.Tensor:
    """Point inactive slots' page-table rows at the null page (id 0)."""
    return torch.where(active[:, None], table, 0)


def paged_prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (1, S) one request's prompt
    context: int,
    pool: Cache,
    chain: torch.Tensor,               # (chain_len,) page ids
    *,
    page_size: int,
    skip: int = 0,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Prefill ONE request into its page chain, in place.

    ``skip`` pages (``skip * page_size`` leading positions) are already
    resident (a copy-on-write prefix fork found them), so only the suffix
    runs a forward: suffix queries attend over [cached prefix K/V ; suffix
    K/V] (``attend_with_prefix``), the key sequence a cold prefill reduces
    over for the same rows.  ``skip == 0`` is the cold path: the ordinary
    B=1 ``prefill``, its ring rows scattered into the chain's pages.
    Returns (last-position logits (1, V) f32, pool).
    """
    B, S = tokens.shape
    if B != 1:
        raise ValueError(f"paged_prefill admits one request, got B={B}")
    if not paged_supported(cfg):
        raise ValueError(
            "paged KV cache supports dense layer stacks only (see "
            "paged_supported)")
    P = page_size
    chain = chain.long()
    chain_len = chain.shape[0]
    start = skip * P
    if not 0 <= start < S:
        raise ValueError(
            f"prefix skip {skip} pages covers {start} positions; prompt has "
            f"{S} (the suffix must recompute at least the last position)")

    if skip == 0:
        logits, sub = prefill(cfg, params, tokens, context,
                              compute_dtype=compute_dtype)
        rows = chain_len * P
        for pe, se in zip(pool, sub):
            for pool_leaf, ring_leaf in ((pe["kv"].k, se["kv"].k),
                                         (pe["kv"].v, se["kv"].v)):
                big = ring_leaf[:, 0]                # (layers, C, nkv, hd)
                C = big.shape[1]
                if rows <= C:
                    big = big[:, :rows]
                else:
                    big = torch.cat([big, big.new_zeros(
                        (big.shape[0], rows - C) + big.shape[2:])], dim=1)
                pool_leaf[:, chain] = big.reshape(
                    (big.shape[0], chain_len, P) + big.shape[2:]).to(
                        pool_leaf.dtype)
        return logits, pool

    # -- suffix path: skip pages of prefix K/V are already in the pool ------
    dev = tokens.device
    x = embed(params["embed"], tokens[:, start:], compute_dtype)
    positions = torch.arange(start, S, device=dev)[None, :]  # (1, S_suf)
    suf_slots = torch.arange(start, S, device=dev)           # no wrap: S<=C
    pages_w = chain[suf_slots // P]                          # (S_suf,)
    offs_w = suf_slots % P
    pre = chain[:skip]
    for run_params, entry, (_, count) in zip(params["runs"], pool,
                                             layer_plan(cfg)):
        kv = entry["kv"]
        for p_l, k_l, v_l in zip(layer_unbind(run_params, count), kv.k,
                                 kv.v):
            k_pre = k_l[pre].reshape((1, start) + k_l.shape[2:])
            v_pre = v_l[pre].reshape((1, start) + v_l.shape[2:])
            h = apply_norm(cfg.norm, p_l["ln1"], x, cfg.norm_eps)
            a, (k_suf, v_suf) = attn_lib.attend_with_prefix(
                p_l["attn"], cfg, h, positions, k_pre, v_pre)
            x = x + a
            h = apply_norm(cfg.norm, p_l["ln2"], x, cfg.norm_eps)
            x = x + apply_mlp(cfg.act, p_l["mlp"], h)
            k_l[pages_w, offs_w] = k_suf[0].to(k_l.dtype)
            v_l[pages_w, offs_w] = v_suf[0].to(v_l.dtype)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, -1], cfg.vocab)
    return logits, pool


def decode_step_paged(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,               # (B,) current token
    pos: torch.Tensor,                 # (B,) per-slot position
    pool: Cache,
    table: torch.Tensor,               # (B, max_chain) int32 page ids
    *,
    context: int,
    compute_dtype=torch.bfloat16,
    impl: str = "gather",
) -> tuple[torch.Tensor, Cache]:
    """One decode step over the page-table cache, the paged dual of
    ``decode_step`` (per-slot positions, dense stacks only).  ``impl`` is
    the attention's: ``"gather"`` or ``"hopper"`` (the kernel K6, one
    launch per layer).  Returns (logits (B, V) f32, pool updated in
    place)."""
    x = embed(params["embed"], token[:, None], compute_dtype)  # (B, 1, D)
    for run_params, entry, (_, count) in zip(params["runs"], pool,
                                             layer_plan(cfg)):
        for p_l, kv_l in zip(layer_unbind(run_params, count),
                             layer_unbind(entry["kv"], count)):
            h = apply_norm(cfg.norm, p_l["ln1"], x, cfg.norm_eps)
            a, _, _ = attn_lib.paged_decode_attend_multi(
                p_l["attn"], cfg, h, pos, kv_l, table,
                context=context, impl=impl, stash=False)
            x = x + a
            h = apply_norm(cfg.norm, p_l["ln2"], x, cfg.norm_eps)
            x = x + apply_mlp(cfg.act, p_l["mlp"], h)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, 0], cfg.vocab)
    return logits, pool


def decode_verify_paged(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (B, L) current token + drafted run
    pos: torch.Tensor,                 # (B,) position of tokens[:, 0]
    pool: Cache,
    table: torch.Tensor,               # (B, max_chain) int32 page ids
    *,
    context: int,
    compute_dtype=torch.bfloat16,
    impl: str = "gather",
) -> tuple[torch.Tensor, Cache, list]:
    """``decode_verify`` over the page-table cache: the L K/V rows go
    through each slot's page chain in place (a draft run crossing a page
    boundary lands in two pages).  Returns (logits (B, L, V) f32, pool,
    stash); ``rollback_paged_runs`` puts back the rejected rows."""
    def attend(p_attn, h, kv_l):
        a, _, st = attn_lib.paged_decode_attend_multi(
            p_attn, cfg, h, pos, kv_l, table, context=context, impl=impl)
        return a, st

    logits, stash = _verify_forward(cfg, params, tokens, pool, attend,
                                    compute_dtype)
    return logits, pool, stash


def rollback_paged_runs(pool: Cache, stash: list, table: torch.Tensor,
                        pos: torch.Tensor, n_keep: torch.Tensor, *,
                        context: int) -> Cache:
    """``rollback_cache_runs`` through the page table, in place: the rows
    past each slot's ``n_keep`` go back to their stashed values at the
    (page, offset) targets ``decode_verify_paged`` wrote."""
    for entry, st in zip(pool, stash):
        kv, old = entry["kv"], st["kv"]
        B, L = old.k.shape[1:3]
        P = kv.k.shape[2]
        slots = (pos[:, None] + torch.arange(L, device=pos.device)[None, :]
                 ) % context                                 # (B, L)
        rows = torch.arange(B, device=pos.device)[:, None]
        pages = table[rows, slots // P].long()
        keep = _keep_mask(n_keep, L)
        _restore_rows(kv.k, old.k, (pages, slots % P), keep)
        _restore_rows(kv.v, old.v, (pages, slots % P), keep)
    return pool
