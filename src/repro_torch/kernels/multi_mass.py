"""K4: multi-threshold probability mass over the vocab, by hand in CUDA.

Replaces the Pallas kernel ``multi_mass`` (``src/repro/kernels/
multi_mass.py:65``): ``mass[b, m] = sum_v p[b, v] * [p[b, v] >= taus[b, m]]``.
The kernel is ``csrc/multi_mass.cu``: a compare per (v, m) pair, in one
launch of one wave of the card with a fixed summing order
(``row_reduce.py``), no float atomics, so results are bit-stable run to
run.  ``multi_mass_plain`` is the plain PyTorch version;
``multi_mass_emulated`` sums in the kernel's block split, for the CPU
tests.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, row_reduce


def multi_mass_plain(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[b, m] = sum of probs[b, v] where probs[b, v] >= taus[b, m]."""
    keep = probs[:, None, :] >= taus[:, :, None]
    return torch.where(keep, probs[:, None, :], 0.0).sum(dim=-1)


def multi_mass_emulated(probs: torch.Tensor, taus: torch.Tensor
                        ) -> torch.Tensor:
    """The plain version's terms summed per block of K4's split on the
    H100, the blocks in block order."""
    B, V = probs.shape
    out = torch.zeros(taus.shape, dtype=torch.float32, device=probs.device)
    nb = row_reduce.blocks_per_row(B, V, row_reduce.CARD_SMS)
    for idx in row_reduce.block_indices(V, nb):
        out = out + multi_mass_plain(probs[:, idx.to(probs.device)], taus)
    return out


@functools.cache
def _entry():
    lib = build.library("multi_mass")
    return lib, row_reduce.bind(lib, "multi_mass_launch")


def multi_mass_cuda(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors: probs (B, V) f32, taus (B, M) f32 ->
    (B, M) f32."""
    lib, fn = _entry()
    return row_reduce.launch(lib, fn, "multi_mass", probs, taus,
                             ("probs", "taus"), 1)[:, 0]
