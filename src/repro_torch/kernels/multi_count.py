"""K2: multi-threshold count over the vocab, by hand in CUDA.

Replaces the Pallas kernel ``multi_count`` (``src/repro/kernels/
multi_count.py:69``): ``counts[b, m] = #{v : x[b, v] > taus[b, m]}`` for
all ``M`` candidates of all rows in one sweep of the operand.  The kernel
is ``csrc/multi_count.cu``; its source note gives the bound and design.
``multi_count_plain`` is the plain PyTorch version: the CPU path of the
wrapper (``kernels/ops.py``) and the reference it is held to.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

CHUNK = 2048          # vocab elements per block (8 per thread)
MAX_M = 8192          # candidates per call: 32 KB of shared memory


def multi_count_plain(x: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """counts[b, m] = #{v : x[b, v] > taus[b, m]} as float32."""
    return (x[:, None, :] > taus[:, :, None]).sum(dim=-1).float()


@functools.cache
def _entry():
    lib = build.library("multi_count")
    fn = lib.multi_count_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def multi_count_cuda(x: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: x (B, V) f32, taus (B, M) f32 -> (B, M) f32.

    Exact integer counts (an int32 atomic sum) cast to f32, equal to the
    plain version bit for bit.
    """
    build.check_rows(x, "x")
    build.check_rows(taus, "taus")
    B, V = x.shape
    M = taus.shape[1]
    if taus.shape[0] != B or taus.device != x.device or M > MAX_M:
        raise ValueError(f"taus must be ({B}, M <= {MAX_M}) on {x.device}, "
                         f"got {tuple(taus.shape)} on {taus.device}")
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        out = torch.zeros((B, M), dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), x.stride(0), taus.data_ptr(), taus.stride(0),
                 out.data_ptr(), B, V, M, CHUNK, build.stream_ptr(x))
        build.check_launch(lib, err, "multi_count")
        return out.float()
