"""Checkpointing: atomic, hash-verified, async (port of
``repro.checkpoint.manager``, with its on-disk format).

  * ATOMIC: write to ``<dir>/tmp.<step>.<pid>``, fsync the manifest,
    rename to ``step_<n>``: a crash mid-save never corrupts the latest
    checkpoint.
  * VERIFIED: ``manifest.json`` stores a SHA256 per leaf; restore_latest
    skips any checkpoint whose hashes do not match and falls back to the
    previous one.
  * ASYNC: ``save_async`` copies the tensors to the host, then a writer
    thread serialises them, so the train loop blocks only for the copy.

The format is the JAX package's: one ``.npy`` per leaf, named by the
first 16 hex digits of the SHA256 of its path string (``tree.py``: dict
keys, list indices and NamedTuple field names joined by ``/``), bf16
stored as its ``uint16`` bits with ``"dtype": "bfloat16"`` in the
manifest.  A checkpoint written by either package restores in the other.
Leaves are stored unsharded (a tensor-parallel run gathers its blocks
whole, padding dropped: ``launch/shardings.py::gather_params``), so a
checkpoint restores on any world size and (data, model) placement (the
elastic restart): ``restore_pytree(..., sharding_fn)`` places each
leaf on the current mesh, as JAX's does (``sharding_fn(name, array)``
returns a device, or a ``Placement``: a device and a spec that
``launch/shardings.py::local_block`` cuts the leaf by on a mesh);
without one a leaf lands on ``device``, or on the template leaf's device.
Under a mesh (``CheckpointManager(..., mesh=)``) only the mesh's rank 0
writes, and every rank waits for the write on a barrier.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def _as_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name); bf16 becomes its uint16 bits
    (numpy has no bf16 dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_pytree(directory: str, step: int, tree) -> str:
    """Atomic checkpoint write.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": {}}
    for name, leaf in leaves_with_path(tree):
        arr, logical_dtype = _as_numpy(leaf)
        fname = hashlib.sha256(name.encode()).hexdigest()[:16] + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"][name] = {
            "file": fname,
            "sha256": digest,
            "shape": list(arr.shape),
            "dtype": logical_dtype,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _verify(ckpt_dir: str) -> dict | None:
    mpath = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for meta in manifest["leaves"].values():
            fpath = os.path.join(ckpt_dir, meta["file"])
            with open(fpath, "rb") as fh:
                if hashlib.sha256(fh.read()).hexdigest() != meta["sha256"]:
                    return None
        return manifest
    except (json.JSONDecodeError, OSError, KeyError):
        return None


def _load_leaf(ckpt_dir: str, meta: dict) -> tuple[np.ndarray, torch.Tensor]:
    """(the array as stored, bf16 as its uint16 bits; the tensor)."""
    arr = np.load(os.path.join(ckpt_dir, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return arr, torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr, torch.from_numpy(arr)


class Placement(NamedTuple):
    """Where a restored leaf goes: ``device``, cut to this rank's block
    of ``spec`` on ``mesh`` (``launch/shardings.py::local_block``; an
    empty spec keeps the leaf whole), or to what ``block(whole)``
    returns (the tensor-parallel layout's blocks, whose heads are
    padded: ``launch/shardings.py::tp_sharding_fn``)."""

    device: Any
    spec: tuple = ()
    mesh: Any = None
    block: Callable[[torch.Tensor], torch.Tensor] | None = None


def _place(t: torch.Tensor, where, dtype) -> torch.Tensor:
    if isinstance(where, Placement):
        if where.block is not None:
            t = where.block(t)
        elif where.spec:
            from repro_torch.launch.shardings import local_block

            t = local_block(t, where.spec, where.mesh)
        where = where.device
    return t.to(device=where, dtype=dtype).contiguous()


def restore_pytree(ckpt_dir: str, template,
                   sharding_fn: Callable[[str, np.ndarray], Any] | None = None,
                   *, device=None):
    """Restore into the structure of ``template`` (shapes must match).

    Each leaf takes the template leaf's dtype.  ``sharding_fn(name,
    array)`` (the leaf's path string and its array as stored, bf16 as
    its uint16 bits) decides its
    placement on the current mesh, as JAX's does: a device, a
    ``Placement``, or None for the default: ``device``, or the template
    leaf's device when ``device`` is None.
    """
    manifest = _verify(ckpt_dir)
    if manifest is None:
        raise ValueError(f"corrupt or missing checkpoint at {ckpt_dir}")
    out = []
    for name, leaf in leaves_with_path(template):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr, t = _load_leaf(ckpt_dir, meta)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                f"template {tuple(leaf.shape)}")
        where = sharding_fn(name, arr) if sharding_fn else None
        if where is None:
            where = leaf.device if device is None else device
        out.append(_place(t, where, leaf.dtype))
    return unflatten(template, out)


class CheckpointManager:
    """keep-last-N manager with async writes and corrupt-skip restore.

    With a ``mesh``, its ranks hold one replicated state: rank 0 alone
    writes, and ``save`` and ``wait`` return on every rank once the
    checkpoint is on disk (a barrier after rank 0's write); ``save_async``
    returns once rank 0 holds its host copy."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.directory = directory
        self.keep = keep
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    # ---- discovery --------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_valid(self) -> int | None:
        for step in reversed(self.steps()):
            if _verify(os.path.join(self.directory, f"step_{step}")):
                return step
        return None

    # ---- save --------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    @staticmethod
    def _to_host(tree):
        # a COPY of every leaf, never a view: the train step updates the
        # master weights and moments in place, and a zero-copy .numpy() of
        # a CPU tensor would change under the writer thread while it
        # serialises (the hazard JAX's manager.py:189-194 notes for
        # donated buffers)
        return unflatten(tree, [leaf.detach().to("cpu", copy=True)
                                for _, leaf in leaves_with_path(tree)])

    def save(self, step: int, tree) -> str:
        self.wait()   # never race a pending async write on the same step
        path = os.path.join(self.directory, f"step_{step}")
        if self.writes:
            path = save_pytree(self.directory, step, self._to_host(tree))
            self._gc()
        self._barrier()
        return path

    def save_async(self, step: int, tree) -> None:
        self.wait()
        if not self.writes:
            return
        host_tree = self._to_host(tree)              # blocking D2H copy only

        def work():
            save_pytree(self.directory, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Drain the async writer (every rank, under a mesh)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    # ---- restore -----------------------------------------------------------

    def restore_latest(self, template, sharding_fn=None, *, device=None):
        """Returns (step, tree) from the newest VALID checkpoint, or None."""
        for step in reversed(self.steps()):
            path = os.path.join(self.directory, f"step_{step}")
            if _verify(path):
                return step, restore_pytree(path, template, sharding_fn,
                                            device=device)
        return None
