"""Request/response front-end over the continuous-batching scheduler (port
of ``repro.serving.server``).

``RunaheadServer`` is the serving loop ``launch/serve.py --continuous``
runs: submit ``Request``s at any time, call ``step()`` per decode tick,
collect ``Completion``s as each request finishes; no request waits for
another request's tail tokens.  The loop is synchronous and
single-threaded: one ``step()`` is one batched decode (with
``step_horizon`` K > 1, one fused horizon of K; with ``draft_len`` L > 1
each decode verifies L - 1 drafted tokens a slot), and admission happens
between steps.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Sequence

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival`` is the decode-step index at which the request becomes
    visible to the server (0 = available immediately), the simulated
    staggered-arrival knob of the tests and the driver.
    """

    rid: Any
    prompt: Sequence[int]
    n_new: int
    seed: int = 0
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    arrival: int = 0
    eos_id: int | None = None       # stop early on this token (n_new is
    # then a budget cap, not an exact length)


@dataclasses.dataclass
class Completion:
    rid: Any
    tokens: list[int]
    arrival_step: int
    admit_step: int
    finish_step: int
    arrival_time: float
    finish_time: float

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def queue_steps(self) -> int:
        """Decode steps spent waiting for a slot."""
        return self.admit_step - self.arrival_step


class RunaheadServer:
    """Continuous-batching serving engine over the runahead sampler.

    Keyword arguments go to ``ContinuousScheduler`` (slots, context,
    solver statics, dtypes, paging, ``step_horizon``, speculation:
    ``draft_len``, ``drafter``, ``draft_len_auto``, ``max_draft_len``,
    and ``mesh``, with which every speculation argument combines).  Under
    a mesh every rank runs this loop on the same requests (SPMD); each
    rank's completions are the same tokens.
    """

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 context: int = 64, mesh=None, **scheduler_kw):
        self.scheduler = ContinuousScheduler(cfg, params, n_slots=n_slots,
                                             context=context, mesh=mesh,
                                             **scheduler_kw)
        self._pending: deque[Request] = deque()
        self._meta: dict[Any, tuple[int, int, float]] = {}   # rid -> meta
        self._step_idx = 0

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.rid in self._meta:
            raise ValueError(
                f"request id {req.rid!r} already pending or in flight")
        # reject unservable requests HERE, before they enter the queue: a
        # late failure inside _admit_pending would lose the request
        self.scheduler.validate_request(req.n_new, req.sampler,
                                        prompt_len=len(req.prompt))
        self._pending.append(req)
        self._meta[req.rid] = (self._step_idx, -1, time.time())

    def step(self) -> list[Completion]:
        """Admit what fits, run one decode step (or one fused horizon of
        ``step_horizon`` steps), return new completions."""
        self._admit_pending()
        self.scheduler.step()
        self._step_idx += 1
        return self._drain_finished()

    def drain(self) -> list[Completion]:
        """Step until every submitted request has completed."""
        # n_new == 1 requests can finish inside admission without a step
        self._admit_pending()
        done = self._drain_finished()
        while self._pending or self.scheduler.n_active:
            done.extend(self.step())
        return done

    def run(self, requests: Sequence[Request]) -> list[Completion]:
        """Serve a scripted workload with staggered ``arrival`` steps,
        counted from the step this call starts at (a server that served
        before serves the same workload the same way)."""
        todo = sorted(requests, key=lambda r: r.arrival)
        base = self._step_idx
        done: list[Completion] = []
        i = 0
        while i < len(todo) or self._pending or self.scheduler.n_active:
            while i < len(todo) and base + todo[i].arrival <= self._step_idx:
                self.submit(todo[i])
                i += 1
            if not (self._pending or self.scheduler.n_active):
                # idle gap before the next arrival: jump to it
                self._step_idx = base + todo[i].arrival
                continue
            done.extend(self.step())
        done.extend(self._drain_finished())
        return done

    # -- internals ----------------------------------------------------------

    def _admit_pending(self) -> None:
        while self._pending and self.scheduler.has_free_slot():
            req = self._pending[0]
            if not self.scheduler.admit(req.rid, req.prompt, req.n_new,
                                        req.seed, req.sampler,
                                        eos_id=req.eos_id):
                break                        # pool filled under us
            self._pending.popleft()
            arr, _, t0 = self._meta[req.rid]
            self._meta[req.rid] = (arr, self._step_idx, t0)

    def _drain_finished(self) -> list[Completion]:
        out = []
        now = time.time()
        for fin in self.scheduler.pop_finished():
            arr, adm, t0 = self._meta.pop(fin.rid)
            out.append(Completion(
                rid=fin.rid, tokens=fin.tokens, arrival_step=arr,
                admit_step=adm, finish_step=self._step_idx,
                arrival_time=t0, finish_time=now))
        return out


def generate_oneshot_reference(cfg: ModelConfig, params, req: Request, *,
                               context: int,
                               compute_dtype=torch.bfloat16) -> list[int]:
    """The request served alone through the one-shot engine: the
    per-request ground truth continuous batching must reproduce."""
    device = params["embed"].device
    prompt = torch.tensor([list(req.prompt)], dtype=torch.int64,
                          device=device)
    gen = torch.Generator(device=device).manual_seed(req.seed)
    toks = generate(cfg, params, prompt, req.n_new, gen, context=context,
                    sampler=req.sampler, compute_dtype=compute_dtype)
    out = [int(t) for t in toks[0].tolist()]
    if req.eos_id is not None and req.eos_id in out:
        out = out[: out.index(req.eos_id) + 1]
    return out
