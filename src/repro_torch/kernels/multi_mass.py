"""K4: multi-threshold probability mass over the vocab, by hand in CUDA.

Replaces the Pallas kernel ``multi_mass`` (``src/repro/kernels/
multi_mass.py:65``): ``mass[b, m] = sum_v p[b, v] * [p[b, v] >= taus[b, m]]``.
The kernel is ``csrc/multi_mass.cu`` (a partial-sum pass and a chunk-order
sum, no float atomics, so results are bit-stable run to run).
``multi_mass_plain`` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

CHUNK = 2048          # vocab elements per block (8 per thread)
MAX_M = 8192


def multi_mass_plain(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[b, m] = sum of probs[b, v] where probs[b, v] >= taus[b, m]."""
    keep = probs[:, None, :] >= taus[:, :, None]
    return torch.where(keep, probs[:, None, :], 0.0).sum(dim=-1)


@functools.cache
def _entry():
    lib = build.library("multi_mass")
    fn = lib.multi_mass_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def multi_mass_cuda(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors: probs (B, V) f32, taus (B, M) f32 ->
    (B, M) f32."""
    build.check_rows(probs, "probs")
    build.check_rows(taus, "taus")
    B, V = probs.shape
    M = taus.shape[1]
    if taus.shape[0] != B or taus.device != probs.device or M > MAX_M:
        raise ValueError(f"taus must be ({B}, M <= {MAX_M}) on {probs.device}, "
                         f"got {tuple(taus.shape)} on {taus.device}")
    lib, fn = _entry()
    n_chunks = -(-V // CHUNK)
    with torch.cuda.device(probs.device):
        partial = torch.empty((B, n_chunks, M), dtype=torch.float32,
                              device=probs.device)
        out = torch.empty((B, M), dtype=torch.float32, device=probs.device)
        err = fn(probs.data_ptr(), probs.stride(0), taus.data_ptr(),
                 taus.stride(0), partial.data_ptr(), out.data_ptr(), B, V, M,
                 CHUNK, build.stream_ptr(probs))
        build.check_launch(lib, err, "multi_mass")
        return out
