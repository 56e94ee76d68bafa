"""Grouped-query attention, dense half (port of ``repro.models.attention``).

Covers MHA/GQA/MQA (n_kv_heads), qk-norm (qwen3), QKV bias (qwen1.5), RoPE,
full-causal and sliding-window masks, and the ring-buffer KV cache for
decode.  Softmax in f32.  Layouts are the JAX package's: activations
``(B, S, heads, head_dim)``, caches ``(B, C, n_kv, head_dim)``.

Not ported yet: the chunked ``flash_attend`` (``attend`` raises for
``S >= FLASH_MIN_SEQ``), int8 KV, cross attention, the per-slot ``(B,)``
positions and the speculative / paged variants.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, apply_rope, dense_init, rmsnorm

Params = dict
FLASH_MIN_SEQ = 4096     # the JAX package switches to chunked attention here


def init_attention(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    device = gen.device
    p = {
        "wq": dense_init(gen, d, nq * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, nkv * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, nkv * hd, dtype, lead=lead),
        "wo": dense_init(gen, nq * hd, d, dtype, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (nq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (nkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (nkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones(lead + (hd,), dtype=dtype,
                                           device=device)}
        p["k_norm"] = {"scale": torch.ones(lead + (hd,), dtype=dtype,
                                           device=device)}
    return p


def _project_q(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def _sdpa(q, k, v, mask, n_rep: int):
    """q: (B,Sq,nq,hd) k/v: (B,Sk,nkv,hd) mask: broadcastable (B,1,Sq,Sk).

    K/V are repeated up to the query head count, as the JAX package does.
    """
    hd = q.shape[-1]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    return_kv: bool = False,
):
    """Full-sequence self-attention (train / prefill)."""
    B, S, _ = x.shape
    if causal and S >= FLASH_MIN_SEQ:
        raise NotImplementedError(
            f"sequence length {S} >= {FLASH_MIN_SEQ} needs the chunked "
            "flash_attend path, which is not ported yet")
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if not cfg.learned_pos:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if causal:
        qp = positions[:, :, None]
        kp = positions[:, None, :]
        mask = kp <= qp
        if window > 0:
            mask &= kp > qp - window
        mask = mask[:, None]
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = out @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)   # k already roped: the decode cache layout
    return out


def _decode_sdpa(q, k, v, mask, n_rep: int):
    """Decode-time GQA over the ring cache: queries group as (nkv, n_rep),
    K/V are not repeated."""
    B, Sq, nq, hd = q.shape                    # Sq == 1
    nkv = k.shape[2]
    qg = q[:, 0].reshape(B, nkv, n_rep, hd)
    scores = torch.einsum("bhrd,bkhd->bhrk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v)
    return out.reshape(B, Sq, nq, hd)


# ---------------------------------------------------------------------------
# decode path (ring-buffer KV cache)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffer cache: capacity = full sequence (dense) or window (SWA).

    k, v: ``lead + (B, C, n_kv, head_dim)``; a run's cache carries the
    run's leading layer axis.
    """
    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device,
                  lead: tuple = ()) -> KVCache:
    shape = lead + (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attend(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D) current token
    pos: int,                 # shared position of the whole batch
    cache: KVCache,           # one layer's (B, C, n_kv, hd) view
    *,
    window: int = 0,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step: append K/V at pos (mod capacity), attend over cache.

    ``pos`` is a Python int (the lock-step batch of one-shot ``generate``),
    so nothing is read back from the device.  Unlike the JAX function, the
    new K/V are written into ``cache`` in place; the same cache is returned.
    """
    B = x.shape[0]
    q = _project_q(p, cfg, x)                                # (B,1,nq,hd)
    k_new, v_new = _project_kv(p, cfg, x)                    # (B,1,nkv,hd)
    if not cfg.learned_pos:
        pvec = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k_new = apply_rope(k_new, pvec, cfg.rope_theta)

    C = cache.capacity
    slot = pos % C
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]

    # validity: ring slot s holds absolute position p_s; it is attendable iff
    # p_s <= pos and p_s > pos - C (ring eviction) and (SWA) p_s > pos - w.
    slots = torch.arange(C, device=x.device)
    wraps = pos // C
    p_s = torch.where(slots <= slot, wraps * C + slots, (wraps - 1) * C + slots)
    valid = (p_s >= 0) & (p_s <= pos)
    if window > 0:
        valid &= p_s > pos - window
    mask = valid[None, None, None, :]                        # (1,1,1,C)

    out = _decode_sdpa(q, cache.k, cache.v, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache
