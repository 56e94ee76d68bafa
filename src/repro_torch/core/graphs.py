"""CUDA graphs of the port's bodies, one per static key: the port's
stand-in for ``jax.jit``'s cache.

The JAX package runs a solve, a decode step and a horizon of decode steps
each as one compiled program.  The port runs each as one CUDA-graph
replay: ``Graphs.run(key, body, *args)`` calls ``body(*args)``, and

  * on CPU tensors runs the body, eagerly: the CPU has no graphs;
  * on CUDA tensors, at the first call at ``key``, runs the body eagerly
    on a side stream (the warm-up: libraries load, the kernels' cached
    scratch is allocated, cuBLAS picks its kernels) and returns that
    result; then captures the body over static copies of ``args`` into a
    graph in the owner's memory pool.  Every later call at ``key`` copies
    ``args`` into the static copies, replays the graph and returns copies
    of its outputs, so a caller may keep a result across calls.

``key`` holds everything the body's launches depend on besides ``args``
(the counterpart of jit's static arguments).  A body may also read and
write tensors it closes over (weights, caches, a scheduler's slot state):
the graph holds them by address, so they keep their storage for the
graph's life, and the body writes state back in place (``copy_``) instead
of rebinding it.  A body does no host work the capture cannot record (no
``.item()``, no host copies) and no Python bookkeeping, since the capture
runs its Python again.  A capture or replay that fails raises: nothing
runs eagerly instead on the card.

Launch counts: a kernel wrapper adds to ``kernels.ops.LAUNCHES`` when it
launches, and also while a capture records its launch.  The capture's
counts move from ``LAUNCHES`` into the graph, and each replay adds them
back, so ``LAUNCHES`` counts the kernels the card ran.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Hashable, NamedTuple

import torch

from repro_torch.kernels import ops


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]    # the static copies of args
    outputs: Any                        # a tensor or a tuple of tensors
    launches: dict[str, int]            # kernel launches one replay makes


def _tensors(out) -> tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


def _copy(out):
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


class Graphs:
    """An owner's graphs, one per static key, in one shared memory pool.

    The graphs of one owner replay one at a time on one stream and keep
    their outputs, so they can share a pool.  ``capture_s`` sums the wall
    seconds of warm-ups and captures.
    """

    def __init__(self):
        self._entries: dict[Hashable, _Entry] = {}
        self._pool = None
        self.capture_s = 0.0

    @property
    def keys(self) -> list:
        return list(self._entries)

    def clear(self) -> None:
        """Drop every graph (their pool goes with the last of them)."""
        self._entries.clear()
        self._pool = None

    def run(self, key: Hashable, body: Callable, *args: torch.Tensor,
            device=None):
        """``body(*args)``, as one graph replay on CUDA (see the module
        docstring).  ``device`` is where the body runs, by default that
        of ``args[0]``."""
        dev = torch.device(device) if device is not None else args[0].device
        if dev.type != "cuda":
            return body(*args)
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, body, args, dev)
        for static, a in zip(entry.inputs, args):
            static.copy_(a)
        entry.graph.replay()
        for name, n in entry.launches.items():
            ops.LAUNCHES[name] += n
        return _copy(entry.outputs)

    def _capture(self, key, body, args, dev):
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = body(*args)
            main.wait_stream(side)
            for t in _tensors(out):
                t.record_stream(main)
            inputs = tuple(a.clone() for a in args)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = dict(ops.LAUNCHES)
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = body(*inputs)
            launches = {name: ops.LAUNCHES[name] - n
                        for name, n in before.items()
                        if ops.LAUNCHES[name] != n}
            ops.LAUNCHES.update(before)
        self._entries[key] = _Entry(graph, inputs, outputs, launches)
        self.capture_s += time.perf_counter() - t0
        return out
