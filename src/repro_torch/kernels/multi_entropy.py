"""K5: softmax entropy moments at many temperatures, by hand in CUDA.

Replaces the Pallas kernel ``multi_entropy_moments`` (``src/repro/kernels/
multi_entropy.py:84``): for max-shifted logits ``z <= 0`` and candidate
temperatures ``T``, ``s = sum_v exp(z / T)`` and
``w = sum_v (z / T) exp(z / T)``; ``H = log s - w / s`` is finalised by the
``multi_entropy`` wrapper in ``kernels/ops.py``.  The kernel is
``csrc/multi_entropy.cu`` (true division, precise expf, a chunk-order
two-pass sum, bit-stable run to run).  ``multi_entropy_moments_plain`` is
the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

CHUNK = 2048          # vocab elements per block (8 per thread)
MAX_M = 8192


def multi_entropy_moments_plain(z: torch.Tensor, ts: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, w), each (B, M), for max-shifted z (B, V) and temperatures ts."""
    zt = z[:, None, :] / ts[:, :, None]
    e = torch.exp(zt)
    return e.sum(dim=-1), (zt * e).sum(dim=-1)


def entropy_from_moments(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = log s - w / s (``multi_entropy.py:110``)."""
    return torch.log(s) - w / s


@functools.cache
def _entry():
    lib = build.library("multi_entropy")
    fn = lib.multi_entropy_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def multi_entropy_moments_cuda(z: torch.Tensor, ts: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors: z (B, V) f32 with every element <= 0,
    ts (B, M) f32 positive -> (s, w), each (B, M) f32."""
    build.check_rows(z, "z")
    build.check_rows(ts, "ts")
    B, V = z.shape
    M = ts.shape[1]
    if ts.shape[0] != B or ts.device != z.device or M > MAX_M:
        raise ValueError(f"ts must be ({B}, M <= {MAX_M}) on {z.device}, "
                         f"got {tuple(ts.shape)} on {ts.device}")
    lib, fn = _entry()
    n_chunks = -(-V // CHUNK)
    with torch.cuda.device(z.device):
        partial = torch.empty((B, n_chunks, 2, M), dtype=torch.float32,
                              device=z.device)
        out = torch.empty((B, 2, M), dtype=torch.float32, device=z.device)
        err = fn(z.data_ptr(), z.stride(0), ts.data_ptr(), ts.stride(0),
                 partial.data_ptr(), out.data_ptr(), B, V, M, CHUNK,
                 build.stream_ptr(z))
        build.check_launch(lib, err, "multi_entropy_moments")
        return out[:, 0], out[:, 1]
