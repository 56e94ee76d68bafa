"""Elastic scaling: the mesh shape that fits the devices that survived
(port of the pure half of ``repro.runtime.elastic``).

Checkpoints store unsharded logical arrays (``checkpoint/manager.py``),
so a relaunch on fewer (or more) devices only needs a mesh that (a) keeps
the model axis large enough for TP divisibility and (b) puts the rest on
data.  Building the mesh itself (``make_elastic_mesh``) waits for the
port's multi-GPU layer.
"""
from __future__ import annotations


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
