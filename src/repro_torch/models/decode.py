"""Decode path, dense family: cache init, prefill, single-token decode
step, the slotted cache of continuous batching and the paged KV cache
(port of ``repro.models.decode``).

Cache layout mirrors the layer plan: a list with one entry per run, each a
``{"kv": KVCache}`` whose tensors carry the run's leading layer axis,
``(L, B, C, n_kv, head_dim)``; a page pool replaces ``(B, C)`` by
``(n_pages, page_size)``.  A Python loop over the layer axis replaces
``lax.scan``.  Every function here writes caches and pools IN PLACE (the
JAX functions return new ones); the returned cache is the same object.
That is why the dense continuous step freezes inactive lanes by restoring
the rows it touched (``cache_lanes`` / ``freeze_cache_lanes``) instead of
selecting a copied pre-step cache back in.

Not ported yet: the speculative verify half (``decode_verify[_paged]``,
``rollback_*``), int8 KV and the non-dense block kinds.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, embed, unembed
from repro_torch.models.transformer import (
    dense_plan,
    layer_plan,
    layer_unbind,
    unembed_table,
)

Params = dict
Cache = list


def init_cache(cfg: ModelConfig, batch: int, context: int,
               dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """Zero cache sized for `context` tokens."""
    return [{"kv": attn_lib.init_kv_cache(cfg, batch, context, dtype, device,
                                          lead=(count,))}
            for _, count in dense_plan(cfg)]


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


def _prefill_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, cap: int):
    """One dense block forward that also emits its ring-filled K/V."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    a, (k, v) = attn_lib.attend(p["attn"], cfg, h, positions, return_kv=True)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    x = x + apply_mlp(cfg.act, p["mlp"], h)
    return x, _ring_fill(k, cap), _ring_fill(v, cap)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (B, S)
    context: int,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Process the prompt; returns (last-position logits (B, V) f32, cache).

    Only the final position's logits are computed.  The cache holds K/V in
    ``compute_dtype``, as the JAX prefill does.
    """
    B, S = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    cache: Cache = []
    for run_params, (_, count) in zip(params["runs"], dense_plan(cfg)):
        ks, vs = [], []
        for p_l in layer_unbind(run_params, count):
            x, k, v = _prefill_block(cfg, p_l, x, positions, context)
            ks.append(k)
            vs.append(v)
        cache.append({"kv": KVCache(k=torch.stack(ks), v=torch.stack(vs))})
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, -1], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _step_block(cfg: ModelConfig, p: Params, x: torch.Tensor, pos,
                kv: KVCache) -> torch.Tensor:
    """One dense block for one token.  x: (B, 1, D); kv: one layer's view."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    a, _ = attn_lib.decode_attend(p["attn"], cfg, h, pos, kv)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    return x + apply_mlp(cfg.act, p["mlp"], h)


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,               # (B,) current token
    pos,                               # int shared, or (B,) per-slot tensor
    cache: Cache,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """One decode step: returns (logits (B, V) f32, cache updated in place).

    ``pos`` is a Python int (every row at the same depth: one-shot
    ``generate``) or a (B,) device tensor (continuous batching: one
    position per slot, never read back to the host).
    """
    x = embed(params["embed"], token[:, None], compute_dtype)  # (B, 1, D)
    for run_params, entry, (_, count) in zip(params["runs"], cache,
                                             dense_plan(cfg)):
        for p_l, kv_l in zip(layer_unbind(run_params, count),
                             layer_unbind(entry["kv"], count)):
            x = _step_block(cfg, p_l, x, pos, kv_l)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, 0], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# slotted cache (continuous batching)
# ---------------------------------------------------------------------------

def write_cache_slot(cache: Cache, sub: Cache, slot: int) -> Cache:
    """Overwrite batch row ``slot`` of ``cache`` with the B=1 cache ``sub``,
    in place: the admission path of the continuous scheduler."""
    for big, small in zip(cache, sub):
        big["kv"].k[:, slot] = small["kv"].k[:, 0]
        big["kv"].v[:, slot] = small["kv"].v[:, 0]
    return cache


def prefill_into_slot(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (1, S) one request's prompt
    context: int,
    cache: Cache,
    slot: int,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Prefill ONE request and land its state in batch row ``slot``.

    The prefill math is the ordinary ``prefill`` at B=1, so a request's
    state is the same whether it was admitted into a slot or served
    one-shot; ``context`` must match the slotted cache's capacity.
    Returns (last-position logits (1, V) f32, cache).
    """
    logits, sub = prefill(cfg, params, tokens, context,
                          compute_dtype=compute_dtype)
    return logits, write_cache_slot(cache, sub, slot)


def cache_lanes(cache: Cache, pos: torch.Tensor) -> list:
    """The rows a per-slot ``decode_step`` at ``pos`` will overwrite: for
    each run, ``(k, v)`` at ring slot ``pos % C`` of every batch row,
    (layers, B, n_kv, hd) each."""
    out = []
    for entry in cache:
        kv = entry["kv"]
        rows = torch.arange(kv.k.shape[1], device=pos.device)
        slot = pos % kv.capacity
        out.append((kv.k[:, rows, slot], kv.v[:, rows, slot]))
    return out


def freeze_cache_lanes(cache: Cache, stash: list, pos: torch.Tensor,
                       active: torch.Tensor) -> Cache:
    """Bit-freeze inactive batch lanes after a per-slot step: restore the
    rows ``cache_lanes`` saved where ``~active``, in place.

    The JAX function selects the whole pre-step cache back in; a step
    writes exactly one ring slot per lane, so restoring that slot leaves
    an inactive lane bit-identical to its pre-step state.
    """
    for entry, (k_old, v_old) in zip(cache, stash):
        kv = entry["kv"]
        rows = torch.arange(kv.k.shape[1], device=pos.device)
        slot = pos % kv.capacity
        keep = active[None, :, None, None]
        kv.k[:, rows, slot] = torch.where(keep, kv.k[:, rows, slot], k_old)
        kv.v[:, rows, slot] = torch.where(keep, kv.v[:, rows, slot], v_old)
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
                                             dense_plan(cfg)):
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
                                             dense_plan(cfg)):
        for p_l, kv_l in zip(layer_unbind(run_params, count),
                             layer_unbind(entry["kv"], count)):
            h = apply_norm(cfg.norm, p_l["ln1"], x, cfg.norm_eps)
            a, _ = attn_lib.paged_decode_attend_multi(
                p_l["attn"], cfg, h, pos, kv_l, table,
                context=context, impl=impl)
            x = x + a
            h = apply_norm(cfg.norm, p_l["ln2"], x, cfg.norm_eps)
            x = x + apply_mlp(cfg.act, p_l["mlp"], h)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, 0], cfg.vocab)
    return logits, pool
