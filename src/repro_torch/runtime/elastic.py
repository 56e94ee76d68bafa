"""Elastic scaling: the mesh shape that fits the devices that survived
(port of the pure half of ``repro.runtime.elastic``).

Checkpoints store unsharded logical arrays (``checkpoint/manager.py``),
so a relaunch on fewer (or more) devices only needs a mesh that (a) keeps
the model axis large enough for TP divisibility and (b) puts the rest on
data.  ``make_elastic_mesh`` builds that mesh over the live world of
``torch.distributed`` ranks.  Its ``model`` axis is a real one: a
caller that places its weights on it (``launch/shardings.py::
place_params``, ``tp_sharding_fn`` for a restore) and enters
``distributed/tp.py::tensor_parallel(mesh)`` runs the tensor-parallel
layout there; the training launcher passes ``model_parallel=1``, as
JAX's does, and trains data-parallel.
"""
from __future__ import annotations

import logging

import torch.distributed as dist


def derive_mesh_shape(
    n_devices: int, *, model_parallel: int = 16, min_model: int = 1
) -> tuple[dict[str, int], int]:
    """Returns ({axis: size}, dropped_devices).

    Shrinks the model axis by powers of two until it divides the device
    count; leftover devices that can't form a full data row are dropped
    (reported so the controller can log the capacity loss).
    """
    mp = model_parallel
    while mp > min_model and (n_devices < mp or n_devices % mp):
        mp //= 2
    data = max(1, n_devices // mp)
    used = mp * data
    return {"data": data, "model": mp}, n_devices - used


def make_elastic_mesh(*, model_parallel: int = 16):
    """A (data, model) mesh over the ranks alive now: the world size of
    ``torch.distributed`` (1 when no process group is up).

    A mesh spans the whole world (``launch/mesh.py::Mesh``), so a world
    that leaves ranks over raises: relaunch on the ``data * model`` ranks
    ``derive_mesh_shape`` keeps, as the JAX package keeps that many
    devices.
    """
    from repro_torch.launch.mesh import Mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    shape, dropped = derive_mesh_shape(n, model_parallel=model_parallel)
    if dropped:
        logging.getLogger(__name__).warning(
            "elastic mesh drops %d ranks (%d usable)", dropped, n - dropped)
    return Mesh((shape["data"], shape["model"]), ("data", "model"))
