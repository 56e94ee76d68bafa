"""K2: multi-threshold count over the vocab, by hand in CUDA.

Replaces the Pallas kernel ``multi_count`` (``src/repro/kernels/
multi_count.py:69``): ``counts[b, m] = #{v : x[b, v] > taus[b, m]}`` for
all ``M`` candidates of all rows in one sweep of the operand, and with
``below=True`` ``#{v : x[b, v] < taus[b, m]}`` (the engine's count_below,
without negating the operand).  The kernel is ``csrc/multi_count.cu`` on
``csrc/row_reduce.cuh``: a compare and half an integer add per (v, m)
pair, one launch a call, exact integer counts converted to f32 once.
``multi_count_plain`` is the plain PyTorch version: the CPU path of the
wrapper (``kernels/ops.py``) and the reference it is held to.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, row_reduce


def multi_count_plain(x: torch.Tensor, taus: torch.Tensor,
                      below: bool = False) -> torch.Tensor:
    """counts[b, m] = #{v : x[b, v] > taus[b, m]} (``<`` with ``below``)
    as float32."""
    cmp = torch.lt if below else torch.gt
    return cmp(x[:, None, :], taus[:, :, None]).sum(
        dim=-1, dtype=torch.int32).float()


@functools.cache
def _entry(symbol: str):
    lib = build.library("multi_count")
    return lib, row_reduce.bind(lib, symbol)


def multi_count_cuda(x: torch.Tensor, taus: torch.Tensor,
                     below: bool = False, nb: int | None = None
                     ) -> torch.Tensor:
    """Launch K2 on CUDA tensors: x (B, V) f32, taus (B, M) f32 -> (B, M)
    f32, equal to the plain version bit for bit at any ``nb`` (blocks a
    row, ``row_reduce.launch``)."""
    symbol = "multi_count_below_launch" if below else "multi_count_launch"
    return row_reduce.launch(lambda: _entry(symbol), "multi_count", x, taus,
                             ("x", "taus"), 1, nb)[:, 0]
