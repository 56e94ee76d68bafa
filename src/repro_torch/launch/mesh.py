"""Meshes of ranks over ``torch.distributed`` (port of
``repro.launch.mesh``).

The JAX package runs one controller over a named-axis grid of devices and
lets GSPMD place global arrays.  The port runs SPMD: every rank runs the
same program, holds its local block of each global array, and joins
blocks with collectives over the process group of a mesh axis.  A
:class:`Mesh` is that grid: axis names, their sizes (``shape``, a dict as
JAX's ``Mesh.shape``), this rank's coordinates, and one process group per
set of axes.  Ranks are laid out row-major over the axes, as
``jax.make_mesh`` reshapes its device list, so the last axis varies
fastest: on a ``data x model`` mesh the ``model`` ranks of one data row
are neighbours.

Backends (``choose_backend``), logged once by rank 0:

  * gloo on the CPU;
  * NCCL when every rank of this host has a GPU of its own;
  * gloo over CUDA tensors when ranks share a GPU (one card): each rank's
    tensors and kernels stay on the card, and gloo stages each collective
    through the host.

Nothing moves work to the CPU: a rank's device is the card whenever the
launch asked for ``cuda``.

``spawn_local(fn, world_size, device=...)`` starts the ranks of one host
(a free port, one torch thread a rank), runs ``fn(*args)`` on each and
returns their results in rank order; a rank that fails ends the launch
with its traceback.  Under ``torchrun`` a program calls
``init_from_env`` instead.

Every collective the port's solves, serving and training issue goes
through ``Mesh.all_reduce``, ``Mesh.all_gather``, ``Mesh.reduce_scatter``,
``Mesh.broadcast`` or ``Mesh.broadcast_object``, which
count them and their host seconds in ``Mesh.stats`` (a collective waits
for its result, so host seconds are its cost on the critical path).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import logging
import math
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger("repro_torch.mesh")

DEVICE_ENV = "REPRO_TORCH_MESH_DEVICE"
COLLECTIVE_TIMEOUT_S = 600


@dataclasses.dataclass
class JoinStats:
    """Collectives issued through a mesh: how many, and their host
    seconds (each waits for its result)."""

    count: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.count, self.seconds = 0, 0.0


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class Mesh:
    """A named-axis grid over the ranks of the world.

    ``shape`` maps each axis name to its size, in axis order.  Every rank
    builds the same mesh, in the same order, since each process group is
    made by a collective call; a mesh of one rank needs no process group
    at all.  Building a mesh whose size differs from the world's raises.
    """

    def __init__(self, shape: Mapping[str, int] | Sequence[int],
                 axis_names: Sequence[str] | None = None):
        if axis_names is None:
            axis_names, dims = tuple(shape), tuple(shape.values())
        else:
            axis_names, dims = tuple(axis_names), tuple(shape)
        if len(axis_names) != len(dims) or len(set(axis_names)) != len(dims):
            raise ValueError(f"mesh axes {axis_names} do not match the "
                             f"shape {dims}")
        if any(d < 1 for d in dims):
            raise ValueError(f"mesh shape {dims} has an empty axis")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, dims))
        self.size = math.prod(dims)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(
                f"a {'x'.join(map(str, dims))} mesh needs {self.size} ranks; "
                f"the world has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(axis_names, _unravel(self.rank, dims)))
        self.device = local_device()
        self.stats = JoinStats()
        self.reduce_scatter_form: str | None = None
        # decisions every rank of a group agreed on (core/solver.py)
        self.agreed: dict = {}
        # frozenset(axes) -> (ranks of my group, process group or None)
        self._groups: dict[frozenset, tuple[tuple[int, ...], Any]] = {}
        for n in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n):
                self._make_groups(axes)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"device {self.device})")

    def _make_groups(self, axes: tuple[str, ...]) -> None:
        """The groups over ``axes``, one for each setting of the other
        axes, each rank in row-major order: every rank takes part in
        making each of them, and keeps its own."""
        dims = tuple(self.shape.values())
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            where = dict(zip(others, fixed))
            ranks = tuple(
                r for r in range(self.size)
                if all(_unravel(r, dims)[self.axis_names.index(a)] == c
                       for a, c in where.items()))
            group = None
            if len(ranks) > 1:
                group = (dist.group.WORLD if len(ranks) == self.size
                         else dist.new_group(list(ranks)))
            if self.rank in ranks:
                mine = (ranks, group)
        self._groups[frozenset(axes)] = mine

    # -- axes -------------------------------------------------------------

    def _axes(self, axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.shape}")
        return axes

    def axis_size(self, axes) -> int:
        """Ranks behind an axis or a tuple of axes (1 for None or ())."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over an axis or tuple of axes."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes) -> tuple[int, ...]:
        """The global ranks of this rank's group over ``axes``, in the
        order a gather concatenates them."""
        axes = self._axes(axes)
        if not axes:
            return (self.rank,)
        return self._groups[frozenset(axes)][0]

    def _group(self, axes):
        axes = self._axes(axes)
        return self._groups[frozenset(axes)][1] if axes else None

    # -- collectives --------------------------------------------------------

    @contextlib.contextmanager
    def _counted(self):
        t0 = time.perf_counter()
        yield
        self.stats.count += 1
        self.stats.seconds += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``op`` ("sum", "min" or "max") of ``t`` over the group of
        ``axes``: a new tensor, the same bits on every rank of the group
        (``t`` itself is left as it was)."""
        group = self._group(axes)
        if group is None:
            return t
        out = t.contiguous().clone()
        with self._counted():
            dist.all_reduce(out, op=_OPS[op], group=group)
        return out

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The blocks ``t`` of every rank in the group of ``axes``,
        concatenated along dim 0 in the group's order (the tiling of
        JAX's ``P(axes)`` on that dim).  Every block must have one shape."""
        group = self._group(axes)
        if group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in self.group_ranks(axes)]
        with self._counted():
            dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=0)

    def reduce_scatter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """This rank's block of the sum of ``t`` over the group of
        ``axes``: dim 0 of ``t`` cut into one block a member in the
        group's order (the tiling ``all_gather`` undoes), the block at
        this rank's index summed over the members.  A new tensor.

        NCCL, and gloo on CPU tensors, run ``reduce_scatter_tensor``
        (``reduce_scatter_single`` where torch has it);
        gloo over CUDA tensors (ranks sharing a card) runs an all-reduce
        and keeps the block: its reduce-scatter is not relied on for
        device tensors.  ``reduce_scatter_form`` names the form of the
        last call."""
        group = self._group(axes)
        ways = self.axis_size(axes)
        if t.shape[0] % ways:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"{ways} ways over {axes}")
        if group is None:
            return t.clone()
        size = t.shape[0] // ways
        t = t.contiguous()
        gloo_cuda = (t.is_cuda and dist.get_backend(group) == "gloo")
        with self._counted():
            if gloo_cuda:
                self.reduce_scatter_form = "all_reduce+slice"
                out = t.clone()
                dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
                out = out[self.axis_index(axes) * size:][:size].clone()
            else:
                self.reduce_scatter_form = "reduce_scatter_tensor"
                out = torch.empty((size,) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=t.device)
                # reduce_scatter_single in newer torch, the same call
                rs = getattr(dist, "reduce_scatter_single",
                             dist.reduce_scatter_tensor)
                rs(out, t, group=group)
        return out

    def broadcast(self, t: torch.Tensor, axes, src_index: int
                  ) -> torch.Tensor:
        """``t`` of the group member at position ``src_index`` of the
        group of ``axes``, on every member (written into ``t``)."""
        group = self._group(axes)
        if group is None:
            return t
        src = self.group_ranks(axes)[src_index]
        with self._counted():
            dist.broadcast(t, src=src, group=group)
        return t

    def barrier(self) -> None:
        """Wait until every rank of the mesh has reached this call."""
        group = self._group(self.axis_names)
        if group is None:
            return
        with self._counted():
            dist.barrier(group=group)

    def broadcast_object(self, obj: Any, axes, src_index: int) -> Any:
        """The picklable ``obj`` of the group member at position
        ``src_index`` of the group of ``axes``, returned on every member
        (the others pass anything, say None)."""
        group = self._group(axes)
        if group is None:
            return obj
        box = [obj]
        src = self.group_ranks(axes)[src_index]
        with self._counted():
            dist.broadcast_object_list(box, src=src, group=group)
        return box[0]


def _unravel(rank: int, dims: Sequence[int]) -> tuple[int, ...]:
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _mesh_dims(spec: str) -> tuple[int, ...]:
    try:
        dims = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}; want e.g. '2x4'") from None
    if len(dims) not in (2, 3):
        raise ValueError(f"mesh spec {spec!r} must have 2 or 3 dims")
    return dims


def mesh_axes(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """A CLI mesh spec's (dims, axis names), without building a mesh."""
    dims = _mesh_dims(spec)
    return dims, (("data", "model") if len(dims) == 2
                  else ("pod", "data", "model"))


def parse_mesh(spec: str) -> Mesh:
    """CLI mesh spec -> Mesh: 'DxM' = (data, model), 'PxDxM' adds pods.

    '2x4' is 2-way data parallel (slot sharding in serving) x 4-way model
    parallel (solver vocab sharding); the world must hold D*M ranks (the
    serve launcher's ``--host-devices`` starts them on the CPU).
    """
    dims, names = mesh_axes(spec)
    return Mesh(dims, names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model).  Raises unless the
    world holds exactly that many."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# ranks: backend, device, launch
# ---------------------------------------------------------------------------

def choose_backend(device: str | torch.device, local_world: int
                   ) -> tuple[str, str]:
    """(backend, why) for ``local_world`` ranks of one host on
    ``device``'s type."""
    if torch.device(device).type != "cuda":
        return "gloo", "ranks on the CPU"
    n_gpus = torch.cuda.device_count()
    if n_gpus >= local_world:
        return "nccl", f"{local_world} ranks on {n_gpus} GPUs, one each"
    return "gloo", (f"{local_world} ranks share {n_gpus} GPU(s): gloo over "
                    "CUDA tensors, staged through the host")


def local_device() -> torch.device:
    """This rank's device: what its launch set (``spawn_local`` or
    ``init_from_env``); in a process no launch started, the current CUDA
    device where torch sees one, else the CPU.  A launch on ``cuda`` in
    a process that sees no card raises."""
    if DEVICE_ENV in os.environ:
        dev = torch.device(os.environ[DEVICE_ENV])
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"this rank was launched on {dev}, but torch "
                               f"sees no CUDA device")
        return dev
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rank_device(device: str, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _init(device: str, rank: int, world: int, local_rank: int,
          local_world: int, init_method: str) -> torch.device:
    backend, why = choose_backend(device, local_world)
    dev = _rank_device(device, local_rank)
    os.environ[DEVICE_ENV] = str(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if rank == 0:
        log.info("mesh backend: %s (%s)", backend, why)
    return dev


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the world ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); returns this
    rank's device."""
    world = int(os.environ["WORLD_SIZE"])
    return _init(device, int(os.environ["RANK"]), world,
                 int(os.environ.get("LOCAL_RANK", 0)),
                 int(os.environ.get("LOCAL_WORLD_SIZE", world)), "env://")


def under_torchrun() -> bool:
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ
        and "MASTER_ADDR" in os.environ)


def free_port() -> int:
    """A TCP port on the loopback that is free now (the rendezvous of
    one launch)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankExit(RuntimeError):
    """A spawned rank ended with a non-zero exit code before it reported
    (``exitcode``: the code of the first such rank found)."""

    def __init__(self, rank: int, world: int, exitcode: int):
        super().__init__(f"rank {rank} of {world} exited with code "
                         f"{exitcode} before reporting")
        self.rank, self.exitcode = rank, exitcode


def _rank_main(fn, args, rank, world, port, device, results) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, report."""
    torch.set_num_threads(1)
    try:
        _init(device, rank, world, rank, world, f"tcp://127.0.0.1:{port}")
        out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, *, device: str = "cpu",
                args: tuple = (), timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks started on this host;
    returns their results, rank 0 first.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  Each
    rank joins the world over a fresh loopback port with the backend
    ``choose_backend`` picks, on ``device`` (``cuda``: ranks beyond the
    host's GPUs share them).  A rank that raises or dies ends the launch:
    the other ranks are stopped and this raises with its traceback (a
    rank that exits before it reports: ``RankExit``, with its code).
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, rank, world_size, port, device,
                               results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RankExit(dead[0], world_size,
                                   procs[dead[0]].exitcode)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(
                    f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited non-zero: {bad}")
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
        results.close()
