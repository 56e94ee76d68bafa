"""AdamW with f32 master weights (port of ``repro.optim.adamw``).

The state (master params, first and second moments, all f32, and the
int8 error-feedback residual when ``compress="int8_ef"``) mirrors the
model's parameter tree; the compute params are the master cast to their
own dtype (the train config's ``param_dtype``).

Unlike the JAX function, which builds new trees (``adamw.py:86-98``),
``adamw_update`` works IN PLACE: master, mu, nu and the residual are
updated where they lie, and the compute params are overwritten with the
new master.  At internlm2-1.8b's 1.89 B parameters
the state is 22.7 GB of f32; a second copy would not fit beside the model
on an 80 GB card.  Only ``step`` (a 0-d int32 tensor) is replaced, so the
returned state is a new NamedTuple over the same tensors.  The update's
arithmetic runs in the JAX function's order.

ZeRO-1 (``adamw_init(params, mesh=)`` on a mesh of more than one ``data``
rank): master, mu, nu and the residual hold only this rank's block of
each leaf (``launch/shardings.py::zero1_block``, JAX's
``make_opt_state_shardings``), ``step`` stays whole; ``adamw_update``
then takes the gradient blocks and views of the params' blocks, and the
train step all-gathers the params (``train/step.py``).  ``zero1_whole``
gathers a sharded state whole: the caller that owns a ZeRO-1 state
calls it before it hands the state to ``checkpoint/manager.py``, which
writes trees as they are.  With replicated weights the ``model`` axis
holds replicas of the state.

Under the tensor-parallel layout (``distributed/tp.py``) the params a
rank holds are its ``launch/shardings.py::place_params`` blocks, and the
state mirrors them: ``adamw_init(blocks, mesh=)`` makes the ZeRO-1
blocks of the tensor-parallel blocks (``zero1_local_spec`` of each
block).  ``gather_state`` rebuilds the whole logical state for a
checkpoint: ``zero1_whole`` over ``data``, then ``gather_params`` over
``model``, padding dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.solver import true_div
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32: updates taken
    master: dict          # f32 master copy of params
    mu: dict              # first moment (f32)
    nu: dict              # second moment (f32)
    error: dict | None    # int8-compression residual (f32), or None


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params, *, compress: str | None = None,
               mesh=None) -> AdamWState:
    """The state of ``params``: whole, or under a ``mesh`` this rank's
    ZeRO-1 blocks of every leaf (``step`` whole)."""
    device = leaves(params)[0].device
    if mesh is not None:
        from repro_torch.launch.shardings import zero1_block

        params = unflatten(params, [zero1_block(p, path, mesh)
                                    for path, p in leaves_with_path(params)])
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        mu=tree_map(_zeros_f32, params),
        nu=tree_map(_zeros_f32, params),
        error=tree_map(_zeros_f32, params) if compress == "int8_ef" else None,
    )


def zero1_whole(state: AdamWState, params, mesh) -> AdamWState:
    """A ZeRO-1 ``state`` gathered whole on every rank (one all-gather
    over ``data`` a sharded leaf, in the shard's dtype); ``params`` gives
    each leaf's path and whole shape.  A collective: every rank calls it."""
    from repro_torch.launch.shardings import zero1_dim

    paths = [(path, p.shape) for path, p in leaves_with_path(params)]

    def whole(tree):
        if tree is None:
            return None
        out = []
        for (path, shape), t in zip(paths, leaves(tree)):
            dim = zero1_dim(path, shape, mesh)
            if dim is not None and tuple(t.shape) != tuple(shape):
                t = mesh.all_gather(t.movedim(dim, 0), "data").movedim(0,
                                                                      dim)
            out.append(t.contiguous())
        return unflatten(tree, out)

    return AdamWState(state.step, whole(state.master), whole(state.mu),
                      whole(state.nu), whole(state.error))


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = true_div(torch.clamp_min(g.abs().max(), 1e-12), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    compress: str | None = None,
    params,
):
    """Returns (params, new state), updating in place: ``params``, the
    compute-param tree, is overwritten with the new master cast to its
    own dtype (JAX's ``param_dtype``)."""
    step = state.step + 1
    tf = step.float()
    bc1 = 1.0 - b1 ** tf
    bc2 = 1.0 - b2 ** tf
    errors = leaves(state.error) if compress == "int8_ef" else None
    for i, (g, p, m, v) in enumerate(zip(leaves(grads), leaves(state.master),
                                         leaves(state.mu),
                                         leaves(state.nu))):
        g = g.float()
        if errors is not None:
            e = errors[i]
            ge = g + e
            q, scale = _quantize_int8(ge)
            g = q.float() * scale
            e.copy_(ge - g)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = m / bc1
        upd.div_(torch.sqrt(v / bc2).add_(eps))
        upd.add_(weight_decay * p)
        p.sub_(lr * upd)
    for dst, src in zip(leaves(params), leaves(state.master)):
        dst.copy_(src)
    return params, state._replace(step=step)


def gather_state(state: AdamWState, params, mesh, cfg) -> AdamWState:
    """The whole logical state of a tensor-parallel run (a collective:
    every rank calls it): the ZeRO-1 blocks gathered over ``data``
    (``zero1_whole``, where ``mesh`` has several data ranks), then each
    tree's tensor-parallel blocks over ``model`` (``launch/shardings.py::
    gather_params``), padding dropped.  ``params`` are this rank's
    blocks."""
    from repro_torch.launch.shardings import gather_params

    if mesh.shape.get("data", 1) > 1:
        state = zero1_whole(state, params, mesh)
    if mesh.shape.get("model", 1) == 1:
        return state

    def whole(tree):
        return None if tree is None else gather_params(tree, mesh, cfg)

    return AdamWState(state.step, whole(state.master), whole(state.mu),
                      whole(state.nu), whole(state.error))
