"""Gradient clipping, with the paper-technique quantile clip (port of
``repro.optim.clip``).

``clip_by_quantile`` clips each tensor's gradient norm at the q-quantile
of all per-tensor norms, the quantile found by runahead bisection
(``core/applications.py::quantile`` -> ``solve_kind("count_below")``) on
the ``"hopper"`` backend: on CUDA tensors each round's counts are one
launch of K2 (``multi_count``), on CPU tensors its plain version.  The
JAX function uses its ``"jnp"`` default; counts are exact on both
backends, so the bracket is the same bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.applications import quantile
from repro_torch.tree import leaves, tree_map, unflatten


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def clip_by_quantile(grads, q: float = 0.95, *, spec_k: int = 4,
                     rounds: int = 8):
    """Clip every tensor to the q-quantile of per-tensor grad norms."""
    flat = leaves(grads)
    norms = torch.stack([torch.linalg.vector_norm(l.float().reshape(-1))
                         for l in flat])
    cut = quantile(norms, q, spec_k=spec_k, rounds=rounds, backend="hopper")
    cut = torch.clamp_min(cut, 1e-12)
    clipped = [
        (l.float() * torch.clamp_max(cut / torch.clamp_min(n, 1e-12), 1.0)
         ).to(l.dtype)
        for l, n in zip(flat, norms)
    ]
    return unflatten(grads, clipped), norms
