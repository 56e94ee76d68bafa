"""The single-launch, whole-card row reduction of K4 and K5.

``csrc/row_reduce.cuh`` is the kernel skeleton both share: per row of a
(B, V) f32 operand and per candidate of a (B, M) row, one or two f32 sums
over the row, in one launch of one wave of the card, with a fixed summing
order (a ticket per row instead of a second launch).  This module holds
what the wrappers of ``multi_mass.py`` and ``multi_entropy.py`` share: the
grid (``blocks_per_row``), the scratch and tickets (``scratch``), the
launch (``launch``), and the block split the CPU emulations of the two
kernels sum in (``block_indices``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

THREADS = 256         # a block: 8 warps, two on each of an SM's 4 schedulers
WARPS = THREADS // 32
SCHEDULERS = 4
UNIT = 4 * 32         # elements in one warp's load: a float4 a lane
CARD_SMS = 132        # the H100's SMs, for the CPU emulations' split

# per device: (partial sums, tickets), grown to the largest call seen; the
# buffers a call outgrew stay alive, so a CUDA graph captured on them still
# replays on live memory
_SCRATCH: dict[int, list[tuple[torch.Tensor, torch.Tensor]]] = {}


def blocks_per_row(B: int, V: int, sms: int) -> int:
    """Blocks each row gets: the card's ``sms`` one-block slots spread
    over the B rows (one wave), but no more than the row has 128-element
    units for a block's 8 warps; at least one."""
    units = -(-V // UNIT)
    return max(1, min(sms // B, -(-units // WARPS)))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_indices(V: int, nb: int, head: int = 0) -> list[torch.Tensor]:
    """The element indices each of a row's ``nb`` blocks sums, in the
    kernel's split: the row's float4s from element ``head`` on (its first
    16-byte-aligned one) in units of 32 float4s, spread evenly over the
    nb * 4 scheduler slots (block c holds slots 4c..4c+3), and the at most
    3 elements before and 3 after them in the last block."""
    head = min(head, V)
    n4 = (V - head) // 4
    units = -(-n4 // 32)
    slots = nb * SCHEDULERS
    out = []
    for c in range(nb):
        u0 = c * SCHEDULERS * units // slots
        u1 = (c + 1) * SCHEDULERS * units // slots
        out.append(torch.arange(head + 4 * min(32 * u0, n4),
                                head + 4 * min(32 * u1, n4)))
    out[-1] = torch.cat([out[-1], torch.arange(head),
                         torch.arange(head + 4 * n4, V)])
    return out


def scratch(device: torch.device, n_partial: int, n_rows: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's (partial sums, tickets) buffers, at least n_partial
    f32 and n_rows int32.  Tickets start at 0 and every launch leaves them
    at 0, so the buffers are allocated only when a call outgrows them:
    their addresses stay fixed for CUDA-graph replay.  They are per device,
    not per stream: a call launches on the current stream, and two calls
    that run at the same time on two streams of one device would mix their
    tickets and sums, so the caller orders calls on other streams after
    each other (an event, as for any tensor two streams share)."""
    held = _SCRATCH.setdefault(device.index, [])
    if held:
        partial, tickets = held[-1]
        if partial.numel() >= n_partial and tickets.numel() >= n_rows:
            return partial, tickets
        n_partial = max(n_partial, partial.numel())
        n_rows = max(n_rows, tickets.numel())
    held.append((torch.empty(n_partial, dtype=torch.float32, device=device),
                 torch.zeros(n_rows, dtype=torch.int32, device=device)))
    return held[-1]


def launch(lib, fn, what: str, x: torch.Tensor, cand: torch.Tensor,
           names: tuple[str, str], k_acc: int) -> torch.Tensor:
    """Check the operands, size the grid, and launch ``fn`` once on the
    current stream; returns (B, k_acc, M) f32.  Raises on a launch error
    (the tickets are untouched by a launch that never ran)."""
    build.check_rows(x, names[0])
    build.check_rows(cand, names[1])
    B, V = x.shape
    M = cand.shape[1]
    if cand.shape[0] != B or cand.device != x.device:
        raise ValueError(f"{names[1]} must be ({B}, M) on {x.device}, got "
                         f"{tuple(cand.shape)} on {cand.device}")
    nb = blocks_per_row(B, V, sm_count(x.device.index))
    with torch.cuda.device(x.device):
        partial = tickets = 0
        if nb > 1:
            buf, tick = scratch(x.device, B * nb * k_acc * M, B)
            partial, tickets = buf.data_ptr(), tick.data_ptr()
        out = torch.empty((B, k_acc, M), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), x.stride(0), cand.data_ptr(), cand.stride(0),
                 out.data_ptr(), partial, tickets, B, V, M, nb,
                 build.stream_ptr(x))
        build.check_launch(lib, err, what)
        return out


STAGES = ("candidates ready", "units summed", "sums written",
          "ticket drawn", "finish done")
STAGE_DEFINES = ("ROW_REDUCE_STAGES",)
STAGE_BLOCKS = 4096     # csrc/row_reduce.cuh kStageBlocks
STAGE_BUILDS = tuple((name, STAGE_DEFINES)
                     for name in ("multi_mass", "multi_entropy"))


def stage_times(name: str, x: torch.Tensor, cand: torch.Tensor,
                k_acc: int, calls: int = 9) -> dict[str, tuple[float, ...]]:
    """Where a call's time goes, from the stage clock of a build of
    ``csrc/<name>.cu`` with -DROW_REDUCE_STAGES (thread 0 of every block
    reads %globaltimer at each stage): per stage, the (min, median, max)
    over ``calls`` eager calls of the median over the blocks that reached
    it of the microseconds since the call's first block started.  A
    warm-up call first, so the operands sit in L2 as in the sampler."""
    lib = build.library(name, STAGE_DEFINES)
    fn = bind(lib, f"{name}_launch")
    lib.row_reduce_stages.argtypes = [ctypes.c_void_p]
    lib.row_reduce_stages.restype = ctypes.c_int
    n = len(STAGES) + 1
    host = (ctypes.c_ulonglong * (STAGE_BLOCKS * n))()
    launch(lib, fn, name, x, cand, ("x", "cand"), k_acc)
    per_call = []
    for _ in range(calls):
        torch.cuda.synchronize()
        build.check_launch(lib, lib.row_reduce_stages(None), "stage clock")
        launch(lib, fn, name, x, cand, ("x", "cand"), k_acc)
        torch.cuda.synchronize()
        build.check_launch(lib, lib.row_reduce_stages(host), "stage clock")
        t = torch.tensor(list(host), dtype=torch.float64).reshape(-1, n)
        t = t[t[:, 0] > 0]
        t = torch.where(t > 0, (t - t[:, 0].min()) / 1e3, torch.nan)
        per_call.append(t[:, 1:].nanmedian(dim=0).values)
    stats = torch.stack(per_call)                      # (calls, stages)
    return {stage: (stats[:, i].min().item(), stats[:, i].median().item(),
                    stats[:, i].max().item())
            for i, stage in enumerate(STAGES)}


def bind(lib, symbol: str):
    """The C entry ``symbol`` of a row_reduce kernel's library, typed."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
