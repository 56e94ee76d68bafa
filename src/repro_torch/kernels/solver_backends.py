"""``"hopper"`` backend registrations for the batched solver engine.

Imported lazily by ``repro_torch.core.solver`` the first time a problem
asks for ``backend="hopper"``.  Each factory BUILDS the ``"torch"``
oracle's problem and swaps only the evaluator (``dataclasses.replace``):
bracket init, sign semantics and the known-sign fast path come from the
oracle by construction, so the two backends cannot drift apart.

  count_above             -> ops.multi_count (K2; counts are bit-exact)
                             + whole-solve override
                             ops.runahead_topk_threshold (K3) when the
                             target count is a Python int
  mass_at_or_above        -> ops.multi_mass (K4; float sums: allclose)
  entropy_at_temperature  -> ops.multi_entropy_moments (K5; float sums:
                             allclose)
  count_below             -> ops.multi_count(below=True) on the operand
                             as it is (the reference counts #{-x > -c},
                             the same counts: negation is exact)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import solver
from repro_torch.core.solver import (
    MonotoneProblem,
    _param_col,
    register,
    true_div,
)
from repro_torch.kernels import multi_entropy, ops

Tensor = torch.Tensor


def _from_torch(kind: str, operand: Tensor, **params) -> MonotoneProblem:
    """The oracle problem for `kind`; its evaluator is replaced."""
    return solver.problem(kind, operand, backend="torch", **params)


@register("count_above", "hopper")
def _count_above_hopper(operand: Tensor, *, k) -> MonotoneProblem:
    x = operand.float()
    k_col = _param_col(k, x.device)

    def multi_eval(taus: Tensor) -> Tensor:
        return k_col - ops.multi_count(x, taus)

    fused = None
    if isinstance(k, int):
        def fused(*, rounds: int, spec_k: int):
            return ops.runahead_topk_threshold(
                x, k_target=k, rounds=rounds, spec_k=spec_k)

    return dataclasses.replace(_from_torch("count_above", operand, k=k),
                               multi_eval=multi_eval, fused_solve=fused)


@register("mass_at_or_above", "hopper")
def _mass_hopper(operand: Tensor, *, p) -> MonotoneProblem:
    probs = operand.float()
    p_col = _param_col(p, probs.device, probs.dtype)

    def multi_eval(taus: Tensor) -> Tensor:
        return p_col - ops.multi_mass(probs, taus)

    return dataclasses.replace(_from_torch("mass_at_or_above", probs, p=p),
                               multi_eval=multi_eval)


@register("entropy_at_temperature", "hopper")
def _entropy_hopper(operand: Tensor, *, target, **bracket) -> MonotoneProblem:
    z = operand.float()
    target_col = _param_col(target, z.device)
    # shift by the row max once, not in every round: the kernel needs
    # every element <= 0, and H is shift-invariant
    z_shifted = z - z.amax(dim=-1, keepdim=True)

    def multi_eval(ts: Tensor) -> Tensor:
        s, w = ops.multi_entropy_moments(z_shifted, ts)
        return target_col - multi_entropy.entropy_from_moments(s, w)

    return dataclasses.replace(
        _from_torch("entropy_at_temperature", z, target=target, **bracket),
        multi_eval=multi_eval)


@register("count_below", "hopper")
def _count_below_hopper(operand: Tensor, *, q) -> MonotoneProblem:
    x = operand.float()
    n = x.shape[-1]
    q_col = _param_col(q, x.device)

    def multi_eval(cs: Tensor) -> Tensor:
        return true_div(ops.multi_count(x, cs, below=True), n) - q_col

    return dataclasses.replace(_from_torch("count_below", operand, q=q),
                               multi_eval=multi_eval)
