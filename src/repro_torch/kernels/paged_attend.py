"""K6: paged decode/verify attention over a page-table KV cache, by hand
in CUDA.

Replaces the Pallas kernel ``paged_attend`` (``src/repro/kernels/
paged_attend.py:97``, body ``_kernel`` :41): per slot, attention of the
``L`` queries at positions ``pos .. pos + L - 1`` over the ring buffer
that the slot's page chain spells, with the online softmax streamed page
by page.  The kernel is ``csrc/paged_attend.cu``, split-chain
flash-decoding: the chain is cut into ``n_split`` runs of pages, one
block each, whose partial softmax states a second kernel merges in split
order; its source note gives the bound and design.
``paged_attend_plain`` is the plain PyTorch version: a loop over the
chain's pages with the TPU kernel's sentinels (-1e30 for masked scores,
``max(l, 1e-30)``) and page order, per split, then the same merge.  With
``n_split=1`` (the default) it is the TPU kernel's arithmetic.

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
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
N_SMS = 132                    # the H100's SMs: see split_geometry
RING_PAGES = 4                 # pages in flight per block (kStages)


def split_geometry(B: int, n_kv: int, n_chain: int) -> tuple[int, int]:
    """(n_split, pages per split) of the kernel's grid: about two blocks
    per SM of the H100's 132, capped by the chain, with no empty split.
    A pure function of the shape, so the summation order, and with it the
    output bits, never depend on the data.  The SM count is tuned for the
    H100 and is a constant on purpose: read from the device, it would
    make the split count, and so the output bits, differ from one card to
    another."""
    return split_runs(n_chain, -(-2 * N_SMS // max(1, B * n_kv)))


def split_runs(n_chain: int, n_split: int) -> tuple[int, int]:
    """(n_split, pages per run) of a chain cut into at most ``n_split``
    runs of equal length, none empty."""
    pps = -(-n_chain // max(1, min(n_split, n_chain)))
    return -(-n_chain // pps), pps


def _attend_pages(qg, pool_k, pool_v, table, pq, pages, C):
    """The online softmax over ``pages`` of each slot's chain, in order,
    from (m, l, acc) = (-inf, 0, 0): the TPU kernel's page loop."""
    B, nkv, LR, D = qg.shape
    L = pq.shape[1]
    P = pool_k.shape[1]
    slot_q, wraps = (pq % C)[..., None], (pq // C)[..., None]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, nkv, LR, 1), -math.inf, device=qg.device)
    l = torch.zeros((B, nkv, LR, 1), device=qg.device)
    acc = torch.zeros((B, nkv, LR, D), device=qg.device)
    for j in pages:
        pid = table[:, j].long()
        k_pg = pool_k[pid].float().transpose(1, 2)            # (B,nkv,P,D)
        v_pg = pool_v[pid].float().transpose(1, 2)
        s = qg @ k_pg.transpose(-1, -2) * scale               # (B,nkv,LR,P)
        lin = j * P + torch.arange(P, device=qg.device)
        p_s = torch.where(lin <= slot_q, wraps * C + lin,
                          (wraps - 1) * C + lin)              # (B, L, P)
        valid = (p_s >= 0) & (p_s <= pq[..., None]) & (lin < C)
        mask = valid[:, None, :, None, :].expand(B, 1, L, LR // L, P).reshape(
            B, 1, LR, P)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ v_pg
        m = m_new
    return m, l, acc


def paged_attend_plain(pool_k, pool_v, table, pos, q, *, context: int,
                       n_split: int = 1):
    """(B, L, n_heads, hd) attention over each slot's page chain.

    pool_k, pool_v: (n_pages, P, n_kv, hd); table: (B, max_chain) page
    ids; pos: (B,) position of q[:, 0]; q: (B, L, n_heads, hd), roped.
    ``n_split`` cuts the chain into runs of ``ceil(chain / n_split)``
    pages, each run's softmax state from scratch, merged in run order
    with weights exp(m_s - m), as the kernel's split and combine do.
    """
    nkv, D = pool_k.shape[2:]
    B, L, nq, _ = q.shape
    R = nq // nkv
    # kv-major head grouping, rows l * R + rep, as the TPU kernel's tile
    qg = q.float().reshape(B, L, nkv, R, D).transpose(1, 2).reshape(
        B, nkv, L * R, D)
    pq = pos.long()[:, None] + torch.arange(L, device=q.device)  # (B, L)
    n_chain = table.shape[1]
    pps = -(-n_chain // max(1, min(n_split, n_chain)))
    parts = [_attend_pages(qg, pool_k, pool_v, table, pq,
                           range(j0, min(j0 + pps, n_chain)), context)
             for j0 in range(0, n_chain, pps)]
    m = parts[0][0]
    for m_s, _, _ in parts[1:]:
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        w = torch.exp(m_s - m)
        l = l + w * l_s
        acc = acc + w * acc_s
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, nkv, L, R, D).transpose(1, 2).reshape(
        B, L, nq, D).to(q.dtype)


def smem_bytes(L: int, R: int, P: int, D: int, itemsize: int) -> int:
    """Dynamic shared memory of one split block (csrc/paged_attend.cu): a
    ring of 4 K and V pages in the pool's dtype (K rows padded by 16
    bytes), then q and acc, the scores, m, l and the row bounds."""
    LR = L * R
    ring = RING_PAGES * P * (2 * D * itemsize + 16)
    return ring + 4 * (2 * LR * D + LR * P + 3 * LR)


@functools.cache
def _entry():
    lib = build.library("paged_attend")
    fn = lib.paged_attend_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attend_cuda(pool_k, pool_v, table, pos, q, *, context: int,
                      n_split: int | None = None):
    """Launch K6 on CUDA tensors; shapes as ``paged_attend_plain``.

    The pool and q share one dtype, bf16 or f32, and the output has it;
    head_dim in ``HEAD_DIMS``.  The chain is cut into ``n_split`` runs of
    equal length, none empty (default: ``split_geometry``'s; the kernel
    tier of ``core/tuning.py`` passes its decision): one C call launches
    the split and the combine kernels.
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
    n_chain = table.shape[1] if table.ndim == 2 else 0
    if (Dq != D or nq % nkv or table.ndim != 2 or table.shape[0] != B
            or tuple(pos.shape) != (B,) or not 1 <= B <= 65535
            or n_chain < 1):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)}, table {tuple(table.shape)},"
                         f" pos {tuple(pos.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            pool_k.dtype == pool_v.dtype == q.dtype):
        raise ValueError(f"q and the pools must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {pool_k.dtype}, "
                         f"{pool_v.dtype}")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("the page pools must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("the page pools must be 16-byte aligned")
    R = nq // nkv
    smem = smem_bytes(L, R, P, D, q.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"L={L}, n_rep={R}, page {P}, head_dim {D} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{MAX_SMEM})")
    if n_split is None:
        n_split, pps = split_geometry(B, nkv, n_chain)
    else:
        if split_runs(n_chain, n_split)[0] != n_split:
            raise ValueError(f"n_split = {n_split} does not cut a chain of "
                             f"{n_chain} pages into runs of equal length "
                             f"with none empty")
        pps = split_runs(n_chain, n_split)[1]
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        table = table.to(torch.int32).contiguous()
        pos = pos.to(torch.int32).contiguous()
        q = q.contiguous()
        out = torch.empty_like(q)
        scratch = torch.empty(B * nkv * n_split * L * R * (D + 2),
                              dtype=torch.float32, device=q.device)
        err = fn(pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
                 pos.data_ptr(), q.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B, n_chain, P, nkv, D, L, R, context,
                 n_split, pps, 1.0 / math.sqrt(D),
                 int(q.dtype == torch.bfloat16), build.stream_ptr(q))
        build.check_launch(lib, err, "paged_attend")
        return out
