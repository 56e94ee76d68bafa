"""K7: causal flash-attention forward, by hand in CUDA.

Replaces the Pallas kernel ``_flash_fwd_pallas`` (``src/repro/kernels/
flash_fwd.py:82``, body ``_kernel`` :35): causal attention over ``q, k, v``
of shape ``(B, S, heads, head_dim)`` with an optional sliding-window band
``kpos > qpos - window``, scores and the online-softmax state in f32,
masked scores at -1e30 and ``out = acc / max(l, 1e-30)`` in q's dtype.
The kernel is ``csrc/flash_fwd.cu``; its source note gives the bound and
design.  Beside the TPU kernel, the port takes ``n_rep``: q has
``n_kv * n_rep`` heads, k and v keep ``n_kv``, and query head ``h`` reads
kv head ``h // n_rep`` (the same function as K/V repeated to every head).

``flash_fwd_plain`` is the plain PyTorch version: the TPU kernel's
arithmetic per q tile over every kv tile in order, at its chunks.  For
bf16 v it rounds p to bf16 before P.V, as the bf16 kernel's tensor-core
product does and as JAX's ``flash_attend`` (which its ``attend`` runs at
S >= 4096) does; for f32 inputs p stays f32.  ``bf16_check`` holds the
bf16 kernel to it, element by element.
``FlashFwd`` is the gradient rule of JAX's ``custom_vjp``
(``flash_fwd.py:97-125``): the forward is K7 (its plain version for CPU
tensors), the backward the vjp of the chunked ``models.attention.
flash_attend`` at the same chunks and window, recomputed from the saved
q, k, v.  JAX has no backward kernel here, and neither has the port.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blocks import KV_CHUNK, Q_CHUNK

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations


def flash_fwd_plain(q, k, v, *, window: int = 0, n_rep: int = 1,
                    q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """(B, S, H, D) causal attention in q's dtype, computed as the TPU
    kernel computes it; S need not divide by the chunks (q and K/V are
    zero-padded, and the padded keys lie above every real query)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    p_dtype = v.dtype if v.dtype == torch.bfloat16 else torch.float32
    qf = q.float().transpose(1, 2)                       # (B, H, S, D)
    kf = k.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    n_q, n_kv = -(-S // q_chunk), -(-S // kv_chunk)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, n_q * q_chunk - S))
    kf = torch.nn.functional.pad(kf, (0, 0, 0, n_kv * kv_chunk - S))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, n_kv * kv_chunk - S))
    rows = []
    for qi in range(n_q):
        q_c = qf[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        m = torch.full((B, H, q_chunk, 1), -math.inf, device=q.device)
        l = torch.zeros((B, H, q_chunk, 1), device=q.device)
        acc = torch.zeros((B, H, q_chunk, D), device=q.device)
        for ki in range(n_kv):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = q_c @ kf[:, :, sl].transpose(-1, -2) * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(p_dtype).float() @ vf[:, :, sl]
            m = m_new
        rows.append(acc / torch.clamp_min(l, 1e-30))
    out = torch.cat(rows, dim=2)[:, :, :S]
    return out.transpose(1, 2).to(q.dtype)


def tc_kv_tile(head_dim: int) -> int:
    """Keys per K/V tile of the bf16 kernel (``TcGeom::kKeys`` in
    ``csrc/flash_fwd.cu``): its online softmax rescales at these edges."""
    return 64 if head_dim >= 128 else 128


class Bf16Check(NamedTuple):
    """K7's bf16 accuracy check, as ``bf16_check`` computes it.

    ``err``: the largest |out - ref|, ref the f32 reference
    (``flash_fwd_plain`` in f32 on the same bf16 inputs upcast);
    ``err_plain``: the same for the bf16 plain version; ``ulp``: one bf16
    ulp of ref's largest magnitude.  ``worst``: the largest ratio, over
    elements, of |out - tiled| to 2**-7 * (|tiled| + its row's largest
    |tiled|), where ``tiled`` is the bf16 plain version at the kernel's key
    tile (``tc_kv_tile``), so that both take the same running max and
    round the same p to bf16: one bf16 ulp of the element, which covers
    the two roundings of the output, plus one of its row's largest, which
    covers a p that rounds the other way in the last f32 bit.
    """
    err: float
    err_plain: float
    ulp: float
    worst: float

    @property
    def ok(self) -> bool:
        return self.err <= self.err_plain + self.ulp and self.worst <= 1.0

    def __str__(self) -> str:
        return (f"max |diff| from the f32 reference {self.err:.3g} (bf16 "
                f"plain {self.err_plain:.3g}, ulp {self.ulp:.3g}); element "
                f"by element against the plain version at the kernel's "
                f"tile {self.worst:.3g} of the allowance")


def bf16_check(out, q, k, v, *, window: int = 0, n_rep: int = 1):
    """``Bf16Check`` of K7's bf16 output ``out`` on inputs q, k, v: it
    passes when its largest |diff| from the f32 reference is at most the
    bf16 plain version's plus one bf16 ulp, and every element lies within
    the allowance of the plain version at the kernel's key tile."""
    kw = dict(window=window, n_rep=n_rep)
    ref = flash_fwd_plain(q.float(), k.float(), v.float(), **kw)
    got = out.float()
    err = (got - ref).abs().max().item()
    err_plain = (flash_fwd_plain(q, k, v, **kw).float() - ref).abs().max()
    top = max(ref.abs().max().item(), 2.0 ** -126)
    tiled = flash_fwd_plain(q, k, v, kv_chunk=tc_kv_tile(q.shape[-1]),
                            **kw).float()
    size = tiled.abs()
    allow = 2.0 ** -7 * (size + size.amax(dim=-1, keepdim=True))
    worst = ((got - tiled).abs() / allow.clamp_min(2.0 ** -126)).max().item()
    return Bf16Check(err, err_plain.item(),
                     2.0 ** (math.floor(math.log2(top)) - 7), worst)


def bind(lib):
    """(lib, its typed ``flash_fwd_launch``) for a library built from
    ``csrc/flash_fwd.cu``."""
    fn = lib.flash_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _entry():
    return bind(build.library("flash_fwd"))


def flash_fwd_cuda(q, k, v, *, window: int = 0, n_rep: int = 1):
    """Launch K7 on CUDA tensors; shapes as ``flash_fwd_plain``.

    q: (B, S, H, D); k, v: (B, S, H // n_rep, D); one dtype, bf16 or f32,
    which the output has.  head_dim in ``HEAD_DIMS``.  bf16 runs on the
    tensor cores (wgmma, TMA loads), f32 on the CUDA cores.
    """
    for name, t in dict(q=q, k=k, v=v).items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (CUDA), got "
                             f"{t.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, H_kv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if (n_rep < 1 or H % n_rep or tuple(k.shape) != (B, S, H // n_rep, D)
            or not 1 <= B <= 65535 or not 1 <= H <= 65535 or S < 1):
        raise ValueError(f"shapes disagree with n_rep={n_rep}: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q, k, v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        # TMA reads 16-byte aligned tensors only
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q.contiguous(), k.contiguous(), v.contiguous()))
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, n_rep, D, window, 1.0 / math.sqrt(D),
                 int(q.dtype == torch.bfloat16), build.stream_ptr(q))
        build.check_launch(lib, err, "flash_fwd")
        return out


class FlashFwd(torch.autograd.Function):
    """K7 forward, the chunked ``flash_attend``'s vjp backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, n_rep: int, q_chunk: int,
                kv_chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.geometry = dict(window=window, n_rep=n_rep, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
        if q.device.type != "cuda":          # the CPU, or the meta trace
            return flash_fwd_plain(q, k, v, window=window, n_rep=n_rep,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
        return flash_fwd_cuda(q, k, v, window=window, n_rep=n_rep)

    @staticmethod
    def backward(ctx, g):
        # imported here: models.attention imports the kernels
        from repro_torch.models.attention import flash_attend

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attend(*inputs, causal=True, **ctx.geometry)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None, None)
