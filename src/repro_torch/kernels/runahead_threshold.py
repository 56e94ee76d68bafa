"""K3: fused multi-round runahead top-k threshold, by hand in CUDA.

Replaces the Pallas kernel ``runahead_topk_threshold`` (``src/repro/
kernels/runahead_threshold.py:123``): per row, the ``(lo, hi)`` bracket of
the k-th largest value after ``rounds`` rounds of ``2**spec_k``-way
runahead bisection, all rounds in one launch.  The kernel is
``csrc/runahead_threshold.cu``; it equals the generic engine loop over K2
bit for bit.  ``runahead_topk_threshold_plain`` is the plain PyTorch
version, a step-for-step transcription of the TPU kernel's body.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_SPEC_K = 8        # the kernel's shared-memory grid holds 2**8 + 1 points


def runahead_topk_threshold_plain(x: torch.Tensor, *, k_target: int,
                                  rounds: int = 8, spec_k: int = 5
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each (B,), bracketing the k-th largest value of each row."""
    x = x.float()
    n = 1 << spec_k
    kf = torch.full((), k_target, dtype=torch.float32, device=x.device)

    def sign(tau):                   # bit of f(tau) = k - count(row > tau)
        return (kf - (x > tau[:, None]).sum(dim=-1).float()) < 0

    lo = x.amin(dim=-1) - 1.0
    hi = x.amax(dim=-1) + 1.0
    sl = sign(lo)
    for _ in range(rounds):
        pts = [None] * (n + 1)
        pts[0], pts[n] = lo, hi
        for level in range(1, spec_k + 1):
            d = 1 << (spec_k - level)
            for m in range(d, n, 2 * d):
                pts[m] = (pts[m - d] + pts[m + d]) / 2
        sign_vec = torch.stack([sl] + [sign(pts[m]) for m in range(1, n)],
                               dim=1)                        # (B, n)
        pts_vec = torch.stack(pts, dim=1)                    # (B, n + 1)
        li = torch.zeros_like(lo, dtype=torch.int64)
        hi_i = torch.full_like(li, n)
        s_cur = sign_vec[:, 0]
        for _ in range(spec_k):
            mid = (li + hi_i) // 2
            s_m = torch.gather(sign_vec, 1, mid[:, None])[:, 0]
            go_left = s_cur != s_m
            hi_i = torch.where(go_left, mid, hi_i)
            li = torch.where(go_left, li, mid)
            s_cur = torch.where(go_left, s_cur, s_m)
        lo = torch.gather(pts_vec, 1, li[:, None])[:, 0]
        hi = torch.gather(pts_vec, 1, hi_i[:, None])[:, 0]
        sl = torch.gather(sign_vec, 1, li[:, None])[:, 0]
    return lo, hi


@functools.cache
def _entry():
    lib = build.library("runahead_threshold")
    fn = lib.runahead_topk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.runahead_topk_max_spec_k() != MAX_SPEC_K:
        raise RuntimeError("csrc/runahead_threshold.cu and MAX_SPEC_K disagree")
    return lib, fn


def runahead_topk_threshold_cuda(x: torch.Tensor, *, k_target: int,
                                 rounds: int = 8, spec_k: int = 5
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on a CUDA tensor x (B, V) f32 -> (lo, hi), each (B,) f32."""
    build.check_rows(x, "x")
    if not 1 <= spec_k <= MAX_SPEC_K:
        raise ValueError(f"spec_k must be in [1, {MAX_SPEC_K}] (the kernel's "
                         f"shared grid holds 2**{MAX_SPEC_K} + 1 points), "
                         f"got {spec_k}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    lib, fn = _entry()
    B, V = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty((2, B), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), x.stride(0), out[0].data_ptr(),
                 out[1].data_ptr(), B, V, int(k_target), rounds, spec_k,
                 build.stream_ptr(x))
        build.check_launch(lib, err, "runahead_topk_threshold")
        return out[0], out[1]
