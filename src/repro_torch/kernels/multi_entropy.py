"""K5: softmax entropy moments at many temperatures, by hand in CUDA.

Replaces the Pallas kernel ``multi_entropy_moments`` (``src/repro/kernels/
multi_entropy.py:84``): for max-shifted logits ``z <= 0`` and candidate
temperatures ``T``, ``s = sum_v exp(z / T)`` and
``w = sum_v (z / T) exp(z / T)``; ``H = log s - w / s`` is finalised by the
``multi_entropy`` wrapper in ``kernels/ops.py``.  The kernel is
``csrc/multi_entropy.cu``: one exponential a pair (``ex2.approx`` of
``z * log2(e) / T``), ``w`` as ``(sum z e) / T``, in one launch of one
wave of the card with a fixed summing order (``row_reduce.py``), so
results are bit-stable run to run.  ``multi_entropy_moments_plain`` is
the plain PyTorch version; ``multi_entropy_moments_emulated`` is the
kernel's arithmetic and block split in PyTorch, for the CPU tests.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, row_reduce

LOG2E = 1.4426950408889634       # rounded to f32 where it is used


def multi_entropy_moments_plain(z: torch.Tensor, ts: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, w), each (B, M), for max-shifted z (B, V) and temperatures ts."""
    zt = z[:, None, :] / ts[:, :, None]
    e = torch.exp(zt)
    return e.sum(dim=-1), (zt * e).sum(dim=-1)


def multi_entropy_moments_emulated(z: torch.Tensor, ts: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's scheme in PyTorch: a = RN(log2(e) / T) per candidate, every
    term e = 2 ** RN(z * a) (``exp2`` standing for ``ex2.approx``, which
    is within 2 ulp of it), s and u = sum z * e per block of the kernel's
    split on the H100, the blocks summed in block order, and
    w = RN(u / T)."""
    z, ts = z.float(), ts.float()
    B, V = z.shape
    a = torch.full_like(ts, LOG2E) / ts                     # (B, M)
    s = u = torch.zeros_like(ts)
    nb = row_reduce.blocks_per_row(B, V, row_reduce.CARD_SMS)
    for idx in row_reduce.block_indices(V, nb):
        seg = z[:, None, idx.to(z.device)]                  # (B, 1, n)
        e = torch.exp2(seg * a[:, :, None])
        s = s + e.sum(dim=-1)
        u = u + (seg * e).sum(dim=-1)
    return s, u / ts


def entropy_from_moments(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = log s - w / s (``multi_entropy.py:110``)."""
    return torch.log(s) - w / s


@functools.cache
def _entry():
    lib = build.library("multi_entropy")
    return lib, row_reduce.bind(lib, "multi_entropy_launch")


def multi_entropy_moments_cuda(z: torch.Tensor, ts: torch.Tensor,
                               nb: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors: z (B, V) f32 with every element <= 0,
    ts (B, M) f32 positive -> (s, w), each (B, M) f32; ``nb`` blocks a
    row (``row_reduce.launch``) sets the summing order."""
    out = row_reduce.launch(_entry, "multi_entropy_moments", z, ts,
                            ("z", "ts"), 2, nb)
    return out[:, 0], out[:, 1]
