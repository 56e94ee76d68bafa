"""K6: paged decode/verify attention over a page-table KV cache, by hand
in CUDA.

Replaces the Pallas kernel ``paged_attend`` (``src/repro/kernels/
paged_attend.py:97``, body ``_kernel`` :41): per slot, attention of the
``L`` queries at positions ``pos .. pos + L - 1`` over the ring buffer
that the slot's page chain spells, with the online softmax streamed page
by page.  The kernel is ``csrc/paged_attend.cu``; its source note gives
the bound and design.  ``paged_attend_plain`` is the plain PyTorch
version: a loop over the chain's pages with the TPU kernel's sentinels
(-1e30 for masked scores, ``max(l, 1e-30)``) and page order.

The pool's K/V rows must already hold the step's new rows (the caller
writes them first, as the dense path does).  Page ids in the table come
from the host allocator (``serving/paged.py``) and are not checked on
the device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use


def paged_attend_plain(pool_k, pool_v, table, pos, q, *, context: int):
    """(B, L, n_heads, hd) attention over each slot's page chain.

    pool_k, pool_v: (n_pages, P, n_kv, hd); table: (B, max_chain) page
    ids; pos: (B,) position of q[:, 0]; q: (B, L, n_heads, hd), roped.
    """
    n_pages, P, nkv, D = pool_k.shape
    B, L, nq, _ = q.shape
    R, C = nq // nkv, context
    # kv-major head grouping, rows l * R + rep, as the TPU kernel's tile
    qg = q.float().reshape(B, L, nkv, R, D).transpose(1, 2).reshape(
        B, nkv, L * R, D)
    pq = pos.long()[:, None] + torch.arange(L, device=q.device)  # (B, L)
    slot_q, wraps = (pq % C)[..., None], (pq // C)[..., None]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, nkv, L * R, 1), -math.inf, device=q.device)
    l = torch.zeros((B, nkv, L * R, 1), device=q.device)
    acc = torch.zeros((B, nkv, L * R, D), device=q.device)
    for j in range(table.shape[1]):
        pid = table[:, j].long()
        k_pg = pool_k[pid].float().transpose(1, 2)            # (B,nkv,P,D)
        v_pg = pool_v[pid].float().transpose(1, 2)
        s = qg @ k_pg.transpose(-1, -2) * scale               # (B,nkv,LR,P)
        lin = j * P + torch.arange(P, device=q.device)
        p_s = torch.where(lin <= slot_q, wraps * C + lin,
                          (wraps - 1) * C + lin)              # (B, L, P)
        valid = (p_s >= 0) & (p_s <= pq[..., None]) & (lin < C)
        mask = valid[:, None, :, None, :].expand(B, 1, L, R, P).reshape(
            B, 1, L * R, P)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ v_pg
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, nkv, L, R, D).transpose(1, 2).reshape(
        B, L, nq, D).to(q.dtype)


def smem_bytes(L: int, R: int, P: int, D: int) -> int:
    """Dynamic shared memory of one block (csrc/paged_attend.cu)."""
    LR = L * R
    return 4 * (2 * LR * D + 2 * P * D + LR * P + 3 * LR)


@functools.cache
def _entry():
    lib = build.library("paged_attend")
    fn = lib.paged_attend_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attend_cuda(pool_k, pool_v, table, pos, q, *, context: int):
    """Launch K6 on CUDA tensors; shapes as ``paged_attend_plain``.

    The pool and q share one dtype, bf16 or f32, and the output has it.
    """
    tensors = dict(pool_k=pool_k, pool_v=pool_v, table=table, pos=pos, q=q)
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (CUDA), got "
                             f"{t.device}")
    if pool_k.ndim != 4 or pool_v.shape != pool_k.shape or q.ndim != 4:
        raise ValueError(f"pools must be (n_pages, P, n_kv, hd) and q "
                         f"(B, L, n_heads, hd), got {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)}, {tuple(q.shape)}")
    n_pages, P, nkv, D = pool_k.shape
    B, L, nq, Dq = q.shape
    if (Dq != D or nq % nkv or table.ndim != 2 or table.shape[0] != B
            or tuple(pos.shape) != (B,) or not 1 <= B <= 65535):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)}, table {tuple(table.shape)},"
                         f" pos {tuple(pos.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            pool_k.dtype == pool_v.dtype == q.dtype):
        raise ValueError(f"q and the pools must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {pool_k.dtype}, "
                         f"{pool_v.dtype}")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("the page pools must be contiguous")
    R = nq // nkv
    if smem_bytes(L, R, P, D) > MAX_SMEM:
        raise ValueError(f"L={L}, n_rep={R}, page {P}, head_dim {D} need "
                         f"{smem_bytes(L, R, P, D)} bytes of shared memory "
                         f"(at most {MAX_SMEM})")
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        table = table.to(torch.int32).contiguous()
        pos = pos.to(torch.int32).contiguous()
        q = q.contiguous()
        out = torch.empty_like(q)
        err = fn(pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
                 pos.data_ptr(), q.data_ptr(), out.data_ptr(), B,
                 table.shape[1], P, nkv, D, L, R, context,
                 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
                 build.stream_ptr(q))
        build.check_launch(lib, err, "paged_attend")
        return out
