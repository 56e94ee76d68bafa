"""K1: the paper's Taylor-series f at M speculative points, by hand in CUDA.

Replaces the Pallas kernel ``taylor_sincos_eval`` (``src/repro/kernels/
taylor_eval.py:54``): ``sin(cos(x))`` by two ``terms``-term Taylor
recurrences at every point of a ``(M,)`` vector, cast to float32 as the
TPU kernel casts it.  The kernel is ``csrc/taylor_eval.cu``; its source
note gives the bound, the design and the proof that its division (a
reciprocal table and one Markstein correction) is IEEE's.  ``taylor_sincos_plain`` is the plain
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


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = build.library("taylor_eval")
    for name, args in (("taylor_sincos_launch", [_P, _P, _I, _I, _P]),
                       ("taylor_sincos_reference_launch",
                        [_P, _P, _I, _I, _I, _P]),
                       ("taylor_div_probe_launch", [_P, _P, _P, _P, _I, _P]),
                       ("taylor_fma_latency_launch", [_P, _P, _I, _P])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check_points(x: torch.Tensor, terms: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.ndim != 1 or not 1 <= x.shape[0] < 2 ** 31 or not x.is_floating_point():
        raise ValueError(f"x must be a non-empty 1-D float tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if terms < 1:
        raise ValueError(f"terms must be >= 1, got {terms}")


def taylor_sincos_cuda(x: torch.Tensor, *, terms: int) -> torch.Tensor:
    """Launch K1 on a CUDA tensor x (M,) (any float dtype) -> (M,) f32."""
    _check_points(x, terms)
    lib = _lib()
    with torch.cuda.device(x.device):
        xf = x.float().contiguous()
        out = torch.empty_like(xf)
        err = lib.taylor_sincos_launch(xf.data_ptr(), out.data_ptr(),
                                       xf.shape[0], terms,
                                       build.stream_ptr(xf))
        build.check_launch(lib, err, "taylor_sincos_eval")
        return out


def taylor_sincos_reference_cuda(x: torch.Tensor, *, terms: int,
                                 zero_shortcut: bool = False) -> torch.Tensor:
    """K1's first version (an ``__fdiv_rn`` every step), for timing the
    division it paid for; ``zero_shortcut`` skips the division of a zero
    numerator.  Same result as ``taylor_sincos_cuda``; not on any path."""
    _check_points(x, terms)
    lib = _lib()
    with torch.cuda.device(x.device):
        xf = x.float().contiguous()
        out = torch.empty_like(xf)
        err = lib.taylor_sincos_reference_launch(
            xf.data_ptr(), out.data_ptr(), xf.shape[0], terms,
            int(zero_shortcut), build.stream_ptr(xf))
        build.check_launch(lib, err, "taylor_sincos_reference")
        return out


def taylor_division_cuda(t: torch.Tensor, x2n: torch.Tensor,
                         den: torch.Tensor) -> torch.Tensor:
    """K1's division step alone on (N,) f32 CUDA tensors:
    RN(RN(t * x2n) / den) as the kernel computes it (den > 0)."""
    for name, v in (("t", t), ("x2n", x2n), ("den", den)):
        if (v.device.type != "cuda" or v.dtype != torch.float32
                or v.shape != t.shape or v.ndim != 1):
            raise ValueError(f"{name} must be a 1-D f32 CUDA tensor shaped "
                             f"like t, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
    lib = _lib()
    t, x2n, den = (v.contiguous() for v in (t, x2n, den))
    with torch.cuda.device(t.device):
        q = torch.empty_like(t)
        err = lib.taylor_div_probe_launch(
            t.data_ptr(), x2n.data_ptr(), den.data_ptr(), q.data_ptr(),
            t.shape[0], build.stream_ptr(t))
        build.check_launch(lib, err, "taylor_div_probe")
        return q


def fma_latency_cycles(reps: int = 1000) -> float:
    """SM cycles per dependent f32 FMA on the current card: one thread runs
    64 * reps of them between two clock64() reads."""
    lib = _lib()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    err = lib.taylor_fma_latency_launch(cycles.data_ptr(), sink.data_ptr(),
                                        reps, build.stream_ptr(cycles))
    build.check_launch(lib, err, "fma_latency")
    return cycles.item() / (64 * reps)
