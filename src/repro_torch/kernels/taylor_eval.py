"""K1: the paper's Taylor-series f at M speculative points, by hand in CUDA.

Replaces the Pallas kernel ``taylor_sincos_eval`` (``src/repro/kernels/
taylor_eval.py:54``): ``sin(cos(x))`` by two ``terms``-term Taylor
recurrences at every point of a ``(M,)`` vector, cast to float32 as the
TPU kernel casts it.  The kernel is ``csrc/taylor_eval.cu``; its source
note gives the bound and design.  ``taylor_sincos_plain`` is the plain
PyTorch version (``core/paper_functions.py``'s recurrences), which the
kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.paper_functions import taylor_cos, taylor_sin
from repro_torch.kernels import build


def taylor_sincos_plain(x: torch.Tensor, *, terms: int) -> torch.Tensor:
    """sin(cos(x)) by ``terms``-term Taylor series in float32."""
    return taylor_sin(taylor_cos(x.float(), terms), terms)


@functools.cache
def _entry():
    lib = build.library("taylor_eval")
    fn = lib.taylor_sincos_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def taylor_sincos_cuda(x: torch.Tensor, *, terms: int) -> torch.Tensor:
    """Launch K1 on a CUDA tensor x (M,) (any float dtype) -> (M,) f32."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.ndim != 1 or not 1 <= x.shape[0] < 2 ** 31 or not x.is_floating_point():
        raise ValueError(f"x must be a non-empty 1-D float tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if terms < 1:
        raise ValueError(f"terms must be >= 1, got {terms}")
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        xf = x.float().contiguous()
        out = torch.empty_like(xf)
        err = fn(xf.data_ptr(), out.data_ptr(), xf.shape[0], terms,
                 build.stream_ptr(xf))
        build.check_launch(lib, err, "taylor_sincos_eval")
        return out
