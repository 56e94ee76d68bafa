"""Grouped-query attention, dense half (port of ``repro.models.attention``).

Covers MHA/GQA/MQA (n_kv_heads), qk-norm (qwen3), QKV bias (qwen1.5), RoPE,
full-causal and sliding-window masks, and the ring-buffer KV cache for
decode.  Softmax in f32.  Layouts are the JAX package's: activations
``(B, S, heads, head_dim)``, caches ``(B, C, n_kv, head_dim)``.

Paged half: ``paged_view``, ``_paged_slot_mask``,
``paged_decode_attend_multi`` (impl ``"gather"``, the dense reduction over
the gathered chain, or ``"hopper"``, the hand-written kernel K6 through
``kernels/ops.py``) and ``attend_with_prefix`` (prefill skip).  The port
writes caches and page pools in place, where the JAX functions return
new ones.

Long sequences: at ``S >= FLASH_MIN_SEQ`` causal self-attention goes
through ``kernels/ops.py::flash_fwd`` (the hand-written kernel K7 on the
card, its plain version on the CPU), whose backward is the vjp of the
chunked ``flash_attend`` below, as in the JAX package's ``custom_vjp``.

Speculative verify: ``decode_attend_multi`` (L queries per row over the
dense ring) and ``paged_decode_attend_multi`` write all L K/V rows in
place and return a stash of the rows they overwrote, which
``models/decode.py``'s ``rollback_*`` put back for rejected drafts.

Encoder-decoder (whisper): ``attend(kv_src=...)`` is cross attention,
K/V projected from ``kv_src`` with no RoPE, no mask and never the flash
branch; ``decode_cross_attend`` attends one query over the encoder K/V a
prefill left in the cache.

int8 K/V (the dense ring only): ``KVCache`` then holds int8 codes and an
f16 scale per (batch, slot, kv head); ``_quantize_kv`` writes a row's
codes, ``_dequantize_kv`` reads the ring back in the compute dtype before
the attention (plain PyTorch, as the JAX package's plain XLA does).  The
paged pool refuses int8, as JAX's does.

``REPRO_DISABLE_FLASH=1`` (read at import into ``FLASH_ENABLED``, as
JAX's switch for A/B dry runs) turns the flash branch off: every length
takes the full-materialisation ``_sdpa``.  It acts off the card only (the
CPU, and the dry run's meta trace): on CUDA operands, where the branch is
K7, ``attend`` raises rather than move K7's work to plain PyTorch.

Tensor parallelism (``distributed/tp.py``): a rank runs ``attend`` on
its local heads by calling it with the layout's ``local_cfg`` (its
``hl`` query heads, padded as JAX's flash branch pads them, and the K/V
heads they read); K7 then runs on the local head count, and the output
projection on the rank's ``wo`` rows is its partial sum, which the block
joins over ``model``.  A padded head has zero Q, K and V, so it outputs
0 and its weights get exactly zero gradient.  ``decode_attend_tp`` is
the decode step on the sequence-split ring of ``SERVE_RULES``
(``cache_seq -> model``, K/V heads replicated): flash-decoding across
ranks.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.solver import true_div
from repro_torch.kernels import ops
from repro_torch.kernels.blocks import KV_CHUNK, Q_CHUNK
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, apply_rope, dense_init, rmsnorm

Params = dict
FLASH_MIN_SEQ = 4096     # full-materialisation attention below this
# REPRO_DISABLE_FLASH=1 restores the full-materialisation attention at
# every length off the card (JAX's A/B switch; ``_flash_branch``)
FLASH_ENABLED = os.environ.get("REPRO_DISABLE_FLASH") != "1"


def init_attention(gen, cfg: ModelConfig, dtype, lead: tuple = (),
                   cross: bool = False) -> Params:
    """Self-attention weights; ``cross`` (whisper's decoder) has the same
    shapes: callers pass the encoder output as ``attend``'s ``kv_src``."""
    del cross
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


def flash_attend(q, k, v, *, causal: bool = True, window: int = 0,
                 q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                 n_rep: int = 1):
    """Chunked online-softmax attention (flash-style, plain PyTorch).

    Replaces the (B, h, S, S) score materialisation with a loop over query
    chunks; each chunk runs an online softmax over KV chunks and is
    wrapped in ``torch.utils.checkpoint`` (where JAX uses
    ``jax.checkpoint``), so backward recomputes the chunk instead of
    storing its probabilities: memory O(S * chunk) instead of O(S**2).

    Sliding window: when ``0 < window < S`` each query chunk reads only
    its [start - window, end) KV band (length window + q_chunk).  GQA: q
    has n_kv * n_rep heads while k, v keep n_kv; the grouped einsums
    never repeat K/V.  P.V runs in V's dtype, as in the JAX function.

    q: (B, S, Hq, hd); k, v: (B, S, Hq // n_rep, hd).  Positions are
    implicit (0..S-1).
    """
    B, S, Hq, D = q.shape
    H, R = Hq // n_rep, n_rep
    scale = 1.0 / math.sqrt(D)
    q = F.pad(q, (0, 0, 0, 0, 0, (-S) % q_chunk))
    n_q = q.shape[1] // q_chunk
    banded = bool(causal) and 0 < window < S
    if banded:
        band = window + q_chunk                  # KV slice length
        # left pad: the band before position 0; right pad: the last
        # chunk's band past S (keys above every real query).  JAX pads
        # left only, and its dynamic_slice then clamps the last band's
        # start when S is not a multiple of q_chunk, which shifts its
        # keys against kpos; the port keeps every slice in bounds.
        pad = (0, 0, 0, 0, window, n_q * q_chunk - S)
        k_p, v_p = F.pad(k, pad), F.pad(v, pad)
    else:
        pad_kv = (-S) % kv_chunk
        k_p = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v_p = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        n_kv = k_p.shape[1] // kv_chunk
    dev = q.device

    def inner(m, l, o, qf, qpos, k_c, v_c, kpos):
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k_c.float()) * scale
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
        mask &= (kpos[None, :] >= 0) & (qpos[:, None] < S)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhrqk,bkhd->bhrqd", p.to(v_c.dtype), v_c).float()
        return m_new, l, o

    def one_q_chunk(qi: int, q_c):
        """q_c: (B, q_chunk, Hq, D) -> (B, q_chunk, Hq, D)."""
        q_start = qi * q_chunk
        qpos = q_start + torch.arange(q_chunk, device=dev)
        qf = q_c.float().reshape(B, q_chunk, H, R, D)
        m = torch.full((B, H, R, q_chunk), -math.inf, device=dev)
        l = torch.zeros((B, H, R, q_chunk), device=dev)
        o = torch.zeros((B, H, R, q_chunk, D), device=dev)
        if banded:
            # [q_start, q_start + band) of the left-padded K/V is
            # [q_start - window, q_end) of the unpadded sequence
            kpos = q_start - window + torch.arange(band, device=dev)
            m, l, o = inner(m, l, o, qf, qpos, k_p[:, q_start:q_start + band],
                            v_p[:, q_start:q_start + band], kpos)
        else:
            for ki in range(n_kv):
                sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                m, l, o = inner(m, l, o, qf, qpos, k_p[:, sl], v_p[:, sl],
                                kpos)
        out = o / torch.clamp_min(l[..., None], 1e-30)
        # (B, H, R, qc, D) -> (B, qc, H * R, D)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, D)
        return out.to(q.dtype)

    chunks = []
    for qi in range(n_q):
        q_c = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        if torch.is_grad_enabled():
            chunks.append(checkpoint(one_q_chunk, qi, q_c,
                                     use_reentrant=False))
        else:
            chunks.append(one_q_chunk(qi, q_c))
    return torch.cat(chunks, dim=1)[:, :S]


def attend(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    kv_src: torch.Tensor | None = None,
    return_kv: bool = False,
):
    """Full-sequence attention (train / prefill / encoder / cross).

    At ``S >= FLASH_MIN_SEQ`` (``_flash_branch``) causal
    self-attention runs K7 through
    ``ops.flash_fwd`` with implicit positions 0..S-1, grouped GQA and K/V
    never repeated (the JAX function's single-device branch); below it,
    and for cross attention (K/V projected from ``kv_src``, no RoPE, no
    mask), the full-materialisation ``_sdpa``.
    """
    B, S, _ = x.shape
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x if kv_src is None else kv_src)
    if not cfg.learned_pos and kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if causal and kv_src is None and _flash_branch(S, q.device):
        out = ops.flash_fwd(q, k, v, window=window, n_rep=n_rep)
    else:
        mask = None
        if causal and kv_src is None:
            qp = positions[:, :, None]
            kp = positions[:, None, :]
            mask = kp <= qp
            if window > 0:
                mask &= kp > qp - window
            mask = mask[:, None]
        out = _sdpa(q, k, v, mask, n_rep)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = out @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)   # k already roped: the decode cache layout
    return out


def _flash_branch(S: int, device: torch.device) -> bool:
    """Whether causal self-attention over ``S`` positions on ``device``
    takes the flash branch: at ``S >= FLASH_MIN_SEQ`` unless
    ``REPRO_DISABLE_FLASH=1`` turned it off, which it may only off the
    card: on CUDA the branch is K7, and the switch raises there."""
    if S < FLASH_MIN_SEQ:
        return False
    if FLASH_ENABLED:
        return True
    if device.type == "cuda":
        raise ValueError(
            "REPRO_DISABLE_FLASH=1 would run K7's work in plain PyTorch on "
            "the card; it switches the flash branch off only on the CPU "
            "and the dry run's meta trace")
    return False


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
    run's leading layer axis.  int8 mode: k, v hold int8 codes and
    k_scale, v_scale one f16 scale per ``lead + (B, C, n_kv)`` row; both
    None otherwise.
    """
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device,
                  lead: tuple = ()) -> KVCache:
    shape = lead + (batch, capacity, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if dtype == torch.int8:
        return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype),
                       k_scale=zeros(shape[:-1], torch.float16),
                       v_scale=zeros(shape[:-1], torch.float16))
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., n_kv, hd) -> int8 codes and one f16 scale a (..., n_kv)
    row: scale = max(amax, 1e-6) / 127 in f32, codes round(x / scale)
    (half to even) clipped to +-127, both divisions IEEE as in JAX."""
    xf = x.float()
    scale = true_div(torch.clamp_min(xf.abs().amax(dim=-1), 1e-6), 127.0)
    codes = torch.clamp(torch.round(xf / scale[..., None].expand_as(xf)),
                        -127, 127).to(torch.int8)
    return codes, scale.to(torch.float16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                   ) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _write_kv(cache: KVCache, index, k_new: torch.Tensor,
              v_new: torch.Tensor, x_dtype) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Write one or more new K/V rows at ``index`` of the ring in place,
    quantized first in int8 mode, and return the ring's K and V as the
    attention reads them (dequantized to ``x_dtype`` in int8 mode)."""
    if not cache.quantized:
        cache.k[index] = k_new.to(cache.k.dtype)
        cache.v[index] = v_new.to(cache.v.dtype)
        return cache.k, cache.v
    for buf, sbuf, new in ((cache.k, cache.k_scale, k_new),
                           (cache.v, cache.v_scale, v_new)):
        codes, scale = _quantize_kv(new)
        buf[index] = codes
        sbuf[index] = scale
    return (_dequantize_kv(cache.k, cache.k_scale, x_dtype),
            _dequantize_kv(cache.v, cache.v_scale, x_dtype))


def _stash_rows(cache: KVCache, index) -> KVCache:
    """The rows at ``index`` of every field of ``cache`` (codes and scales
    in int8 mode), before a write overwrites them."""
    return KVCache(*(None if t is None else t[index] for t in cache))


def decode_attend(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D) current token
    pos,                      # int shared position, or (B,) per-slot tensor
    cache: KVCache,           # one layer's (B, C, n_kv, hd) view
    *,
    window: int = 0,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step: append K/V at pos (mod capacity), attend over cache.

    ``pos`` may be a Python int (the lock-step batch of one-shot
    ``generate``) or a (B,) device tensor (continuous batching: each slot
    at its own depth), which writes one ring slot per row at
    ``(arange(B), pos % C)`` and masks per row, without reading ``pos``
    back to the host.  Unlike the JAX function, the new K/V (codes and
    scales in int8 mode) are written into ``cache`` in place; the same
    cache is returned.
    """
    B = x.shape[0]
    q = _project_q(p, cfg, x)                                # (B,1,nq,hd)
    k_new, v_new = _project_kv(p, cfg, x)                    # (B,1,nkv,hd)
    per_slot = isinstance(pos, torch.Tensor)
    if not cfg.learned_pos:
        pvec = (pos[:, None] if per_slot else
                torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
        q = apply_rope(q, pvec, cfg.rope_theta)
        k_new = apply_rope(k_new, pvec, cfg.rope_theta)

    C = cache.capacity
    slots = torch.arange(C, device=x.device)
    if per_slot:
        slot = pos % C                                       # (B,)
        index = (torch.arange(B, device=x.device), slot)
        pos_c, slot_c = pos[:, None], slot[:, None]          # (B, 1)
    else:
        slot = pos % C
        index = (slice(None), slot)
        pos_c, slot_c = pos, slot
    k, v = _write_kv(cache, index, k_new[:, 0], v_new[:, 0], x.dtype)
    valid = _ring_valid(slots, pos_c, slot_c, C, window)
    # (B, 1, 1, C) per slot, (1, 1, 1, C) shared
    mask = valid[:, None, None, :] if per_slot else valid[None, None, None, :]

    out = _decode_sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache


def _ring_valid(slots: torch.Tensor, pos_c, slot_c, C: int, window: int
                ) -> torch.Tensor:
    """Ring validity of global ring slots ``slots``: slot s holds
    absolute position p_s; it is attendable iff p_s <= pos and p_s > pos
    - C (ring eviction) and (SWA) p_s > pos - window."""
    wraps = pos_c // C
    p_s = torch.where(slots <= slot_c, wraps * C + slots,
                      (wraps - 1) * C + slots)
    valid = (p_s >= 0) & (p_s <= pos_c)
    if window > 0:
        valid &= p_s > pos_c - window
    return valid


def decode_attend_tp(
    p: Params,
    tp,                       # distributed/tp.py::TPRun (not seq_sp)
    x: torch.Tensor,          # (B, 1, D) current token, replicated
    pos,                      # int shared position, or (B,) per-slot tensor
    cache: KVCache,           # this rank's (B, C / tp, n_kv, hd) ring block
) -> torch.Tensor:
    """One decode step on the sequence-split ring: this rank's partial
    sum of the attention output (the caller joins it over ``model``).

    The ring's slots are split over ``model`` (rank r holds global slots
    ``[r * C_l, (r + 1) * C_l)``), every K/V head on each rank.  The
    rank projects its local query and K/V heads; one gather over
    ``model`` gives every head's query and the new K/V rows, which the
    rank owning slot ``pos % C`` writes (int8: codes and scales).  Each
    rank then forms the partial max, sum and P.V of every head over its
    slots, with validity from the global slot indices, and the partials
    combine over ``model`` (one MAX and one SUM join: flash-decoding
    across ranks).  The rank keeps its own heads' rows for its ``wo``
    block.  The combine reassociates the softmax's sums, so the result
    equals the one-rank step within rounding, not bit for bit.
    """
    from repro_torch.distributed import tp as tp_lib

    lay = tp.layout
    cfg, lcfg = lay.cfg, lay.local_cfg
    mesh = lay.mesh
    B = x.shape[0]
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _project_q(p, lcfg, x)                               # (B,1,hl,hd)
    k_new, v_new = _project_kv(p, lcfg, x)                   # (B,1,kv_l,hd)
    per_slot = isinstance(pos, torch.Tensor)
    pvec = (pos[:, None] if per_slot else
            torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
    q = apply_rope(q, pvec, cfg.rope_theta)
    k_new = apply_rope(k_new, pvec, cfg.rope_theta)
    # one gather: every rank's query heads and K/V heads
    both = tp_lib.gather_heads(mesh, torch.cat([q, k_new, v_new], dim=2)
                               [:, 0].transpose(0, 1).contiguous(), 0)
    both = both.reshape(lay.tp, lay.hl + 2 * lay.kv_l, B, hd)
    pick = torch.tensor(lay.kv_pick, device=x.device)
    q_all = both[:, :lay.hl].reshape(lay.hp, B, hd)[:nq].transpose(0, 1)
    k_all = both[:, lay.hl:lay.hl + lay.kv_l].reshape(-1, B, hd)
    v_all = both[:, lay.hl + lay.kv_l:].reshape(-1, B, hd)
    k_row = k_all.index_select(0, pick).transpose(0, 1)      # (B,nkv,hd)
    v_row = v_all.index_select(0, pick).transpose(0, 1)

    C_l = cache.capacity
    C = C_l * lay.tp
    r = lay.rank
    if per_slot:
        slot = pos % C                                       # (B,)
        rows = torch.arange(B, device=x.device)
        index = (rows, slot % C_l)
        owned = (slot // C_l == r)[:, None, None]
        for buf, sbuf, new in ((cache.k, cache.k_scale, k_row),
                               (cache.v, cache.v_scale, v_row)):
            if cache.quantized:
                codes, scale = _quantize_kv(new)
                buf[index] = torch.where(owned, codes, buf[index])
                sbuf[index] = torch.where(owned[..., 0], scale, sbuf[index])
            else:
                buf[index] = torch.where(owned, new.to(buf.dtype),
                                         buf[index])
        pos_c, slot_c = pos[:, None], slot[:, None]
    else:
        slot = pos % C
        if slot // C_l == r:
            _write_kv(cache, (slice(None), slot % C_l), k_row, v_row,
                      x.dtype)
        pos_c, slot_c = pos, slot
    k, v = cache.k, cache.v
    if cache.quantized:
        k = _dequantize_kv(k, cache.k_scale, x.dtype)
        v = _dequantize_kv(v, cache.v_scale, x.dtype)

    slots = r * C_l + torch.arange(C_l, device=x.device)
    valid = _ring_valid(slots, pos_c, slot_c, C, 0)
    mask = valid[:, None, None, :] if per_slot else valid[None, None, None, :]
    n_rep = nq // nkv
    qg = q_all.reshape(B, nkv, n_rep, hd)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, k).float()
    s = torch.where(mask, s * (1.0 / math.sqrt(hd)), NEG_INF)
    m = s.amax(dim=-1)                                       # (B,nkv,rep)
    m_all = tp_lib.vocab_max(mesh, m)
    e = torch.exp(s - m_all[..., None])
    part = torch.cat([torch.einsum("bhrk,bkhd->bhrd", e.to(v.dtype),
                                   v).float(),
                      e.sum(dim=-1)[..., None]], dim=-1)
    part = mesh.all_reduce(part, tp_lib.AXIS)
    out = (part[..., :hd] / part[..., hd:]).to(x.dtype)      # (B,nkv,rep,hd)
    out = out.reshape(B, nq, hd)
    out = F.pad(out, (0, 0, 0, lay.hp - nq))[:, r * lay.hl:(r + 1) * lay.hl]
    return out.reshape(B, 1, lay.hl * hd) @ p["wo"].to(x.dtype)


def decode_cross_attend(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        enc_k: torch.Tensor, enc_v: torch.Tensor
                        ) -> torch.Tensor:
    """Cross attention of one decode token over the encoder K/V a prefill
    left in the cache (B, T_enc, n_kv, hd): no mask, no RoPE."""
    B = x.shape[0]
    q = _project_q(p, cfg, x)
    out = _decode_sdpa(q, enc_k, enc_v, None, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


def _verify_sdpa(q, k, v, mask, n_rep: int):
    """``_decode_sdpa`` generalised to L queries.  q: (B, L, nq, hd); k/v:
    the (B, C, nkv, hd) ring view with the new rows already written;
    mask: (B, 1, 1, L, C) per-query validity."""
    B, L, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, L, nkv, n_rep, hd)
    scores = torch.einsum("blhrd,bkhd->bhrlk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrlk,bkhd->blhrd", probs, v)
    return out.reshape(B, L, nq, hd)


def decode_attend_multi(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, L, D) current token + drafted run
    pos: torch.Tensor,        # (B,) absolute position of x[:, 0]
    cache: KVCache,           # one layer's (B, C, n_kv, hd) ring view
) -> tuple[torch.Tensor, KVCache, KVCache]:
    """Verify-grid attention: L tokens per row in one step.

    Writes all L K/V rows into the ring in place at slots (pos+l) % C, the
    slots L serial steps would write, then attends each query l over the
    same C-row buffer with the serial step's validity mask at depth
    pos+l, so a ring slot written for a deeper draft position is masked
    as serial decode masks the stale row it overwrote.

    Returns (out (B, L, D'), cache, stash): ``stash`` holds the pre-write
    (B, L, n_kv, hd) rows at the touched slots (and their (B, L, n_kv)
    scales in int8 mode), which ``models.decode.rollback_cache_runs``
    puts back for rejected drafts.
    """
    B, L, _ = x.shape
    C = cache.capacity
    if L > C:
        raise ValueError(
            f"draft run length {L} exceeds cache capacity {C}: ring slots "
            "would collide")
    q = _project_q(p, cfg, x)                                # (B,L,nq,hd)
    k_new, v_new = _project_kv(p, cfg, x)                    # (B,L,nkv,hd)
    pgrid = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    if not cfg.learned_pos:
        q = apply_rope(q, pgrid, cfg.rope_theta)
        k_new = apply_rope(k_new, pgrid, cfg.rope_theta)

    index = (torch.arange(B, device=x.device)[:, None], pgrid % C)
    stash = _stash_rows(cache, index)
    k, v = _write_kv(cache, index, k_new, v_new, x.dtype)

    mask = _paged_slot_mask(pgrid, C)[:, None, None]         # (B,1,1,L,C)
    out = _verify_sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, L, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache, stash


# ---------------------------------------------------------------------------
# paged decode path (page-table KV cache)
# ---------------------------------------------------------------------------

def paged_view(buf: torch.Tensor, table: torch.Tensor, context: int
               ) -> torch.Tensor:
    """Gather each slot's page chain into the dense ring layout.

    buf: (n_pages, P, ...) page pool; table: (B, max_chain) page ids ->
    (B, context, ...).  Chain page j holds ring slots [j*P, (j+1)*P), so
    the concatenated chain sliced to ``context`` is the dense per-slot
    ring buffer element for element.  Tail entries past the last mapped
    page read the null page; the validity mask excludes them.
    """
    B = table.shape[0]
    gathered = buf[table.long()]                 # (B, max_chain, P, ...)
    return gathered.reshape((B, -1) + buf.shape[2:])[:, :context]


def _paged_slot_mask(pgrid: torch.Tensor, context: int) -> torch.Tensor:
    """Dense ``decode_attend``'s per-slot validity mask at each query
    depth.  pgrid: (B, L) absolute positions -> (B, L, C) bool."""
    C = context
    slots = torch.arange(C, device=pgrid.device)[None, None, :]
    pq = pgrid[:, :, None]
    slot_q = pq % C
    wraps = pq // C
    p_s = torch.where(slots <= slot_q, wraps * C + slots,
                      (wraps - 1) * C + slots)
    return (p_s >= 0) & (p_s <= pq)


def paged_decode_attend_multi(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, L, D) current token (+ drafted run)
    pos: torch.Tensor,        # (B,) absolute position of x[:, 0]
    cache: KVCache,           # page-pool layout: k/v (n_pages, P, nkv, hd)
    table: torch.Tensor,      # (B, max_chain) int32 page ids
    *,
    context: int,
    impl: str = "gather",
    stash: bool = True,
) -> tuple[torch.Tensor, KVCache, KVCache | None]:
    """Attention of L tokens per slot over a page-table cache (L == 1 is
    the plain decode step).  K/V rows are written in place at (page =
    table[b, slot // P], offset = slot % P) for ring slot (pos+l) % C, so
    a draft run crosses page boundaries as it crosses ring slots; then
    each query reduces over its slot's chain with the serial validity
    mask at its depth.  Inactive slots point their table rows at the null
    page, so their writes land there.

    ``impl``: ``"gather"`` (the chain gathered back into ring order and
    the dense sdpa: bit-identical to the dense ring by construction) or
    ``"hopper"`` (the kernel K6, ``ops.paged_attend``: its plain version
    on the CPU; an online softmax, so equal within tolerance).

    Returns (out (B, L, D'), pool, stash): ``stash`` holds the pre-write
    (B, L, n_kv, hd) rows at the touched (page, offset) targets, which
    ``models.decode.rollback_paged_runs`` puts back for rejected drafts;
    None with ``stash=False`` (the serial step, which never rolls back).
    An int8 pool raises, as in JAX.
    """
    if cache.quantized:
        raise NotImplementedError("paged cache does not support int8 K/V")
    B, L, _ = x.shape
    C = context
    P = cache.k.shape[1]
    if L > C:
        raise ValueError(
            f"draft run length {L} exceeds cache capacity {C}: ring slots "
            "would collide")
    if impl not in ("gather", "hopper"):
        raise ValueError(f"unknown paged attention impl {impl!r}")
    q = _project_q(p, cfg, x)                                # (B,L,nq,hd)
    k_new, v_new = _project_kv(p, cfg, x)                    # (B,L,nkv,hd)
    pgrid = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    if not cfg.learned_pos:
        q = apply_rope(q, pgrid, cfg.rope_theta)
        k_new = apply_rope(k_new, pgrid, cfg.rope_theta)

    slots_w = pgrid % C                                      # (B, L)
    rows = torch.arange(B, device=x.device)[:, None]
    pages_w = table[rows, slots_w // P].long()               # (B, L)
    offs_w = slots_w % P
    kept = (KVCache(k=cache.k[pages_w, offs_w], v=cache.v[pages_w, offs_w])
            if stash else None)
    cache.k[pages_w, offs_w] = k_new.to(cache.k.dtype)
    cache.v[pages_w, offs_w] = v_new.to(cache.v.dtype)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    if impl == "hopper":
        out = ops.paged_attend(cache.k, cache.v, table, pos, q, context=C)
    else:
        mask = _paged_slot_mask(pgrid, C)[:, None, None]     # (B,1,1,L,C)
        k = paged_view(cache.k, table, C)                    # (B,C,nkv,hd)
        v = paged_view(cache.v, table, C)
        if L == 1:
            # serial decode: the SAME reduction as the dense decode_attend
            out = _decode_sdpa(q, k, v, mask[:, :, :, 0], n_rep)
        else:
            out = _verify_sdpa(q, k, v, mask, n_rep)
    out = out.reshape(B, L, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache, kept


def attend_with_prefix(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, S_suf, D) suffix activations
    positions: torch.Tensor,  # (B, S_suf) absolute positions of the suffix
    k_pre: torch.Tensor,      # (B, start, nkv, hd) cached prefix K (roped)
    v_pre: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Suffix-prefill attention: queries for positions ``[start, S)``
    over [cached prefix K/V ; the suffix's own K/V], the prefill-skip
    forward.  Key order and values match what a cold full prefill reduces
    over for the same rows."""
    B, S_suf, _ = x.shape
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if not cfg.learned_pos:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kf = torch.cat([k_pre.to(k.dtype), k], dim=1)
    vf = torch.cat([v_pre.to(v.dtype), v], dim=1)
    S = kf.shape[1]
    qp = positions[:, :, None]                               # (B,S_suf,1)
    kp = torch.arange(S, device=x.device)[None, None, :]     # (1,1,S)
    mask = (kp <= qp)[:, None]                               # (B,1,S_suf,S)
    out = _sdpa(q, kf, vf, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, S_suf, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), (k, v)
