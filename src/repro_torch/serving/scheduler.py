"""Fixed-slot continuous-batching scheduler, per-step path (port of
``repro.serving.scheduler``).

The scheduler keeps a fixed pool of ``n_slots`` decode lanes and admits /
evicts requests per decode step instead of waiting for a whole batch to
drain (the one-shot ``serving.engine.generate`` shape).  Device state is
slot-major and fixed-shape:

  * either one slotted dense KV cache (``models.decode.init_cache`` at
    batch = n_slots), recycled in place by per-slot prefill, or a page
    pool plus an ``(n_slots, max_chain)`` page table (``page_size``), with
    pages allocated, shared copy-on-write and freed on the host
    (``serving.paged``);
  * (B,) current-token and position tensors: ``decode_step`` and
    ``decode_step_paged`` take one position per slot;
  * one ``torch.Generator`` per request, seeded with its seed, so a
    request draws the same noise as a B=1 one-shot ``generate``;
  * per-slot sampler knobs (``SlotSamplers``) riding the solver engine's
    batch axis.

One step is one batched decode over every slot plus one ``sample_slots``;
inactive slots ride along masked out (their token and position frozen;
their dense cache rows restored, their paged writes sent to the null
page).  The device part of a step (``step_device``) reads nothing back;
the host reads the step's tokens once (``commit``), the one host sync of
a step, and books, truncates and evicts there.

Not ported: speculative decoding (``draft_len > 1``), fused horizons
(``step_horizon > 1``), the mesh and the tuner.  Asking for one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import (
    cache_lanes,
    decode_step,
    decode_step_paged,
    freeze_cache_lanes,
    init_cache,
    init_paged_pool,
    paged_prefill,
    paged_supported,
    prefill_into_slot,
)
from repro_torch.serving.paged import (
    PageAllocator,
    pages_for,
    plan_chain,
    prefix_key,
)
from repro_torch.serving.sampler import SamplerConfig, SlotSamplers, sample_slots


@dataclasses.dataclass
class _SlotInfo:
    """Host-side bookkeeping for one occupied slot."""

    rid: Any
    remaining: int                  # tokens still owed
    tokens: list[int]               # emitted so far (includes prefill token)
    sampler: SamplerConfig
    generator: torch.Generator      # the request's own noise stream
    eos_id: int | None = None       # stop token (host-side truncation)


@dataclasses.dataclass
class FinishedRequest:
    rid: Any
    tokens: list[int]


def _enable_bits(configs: list[SamplerConfig]) -> tuple[bool, bool, bool]:
    """(entropy, top_k, top_p): a solve runs only while SOME live request
    uses it.  Greedy rows never need one: argmax is invariant under every
    transform in the pipeline."""
    need = [c for c in configs if not c.greedy]
    return (
        any(c.target_entropy is not None for c in need),
        any(c.top_k > 0 for c in need),
        any(c.top_p > 0.0 for c in need),
    )


def _static_top_k(configs: list[SamplerConfig]) -> int | None:
    """The shared top_k when every solve-needing config agrees on one
    positive value: ``sample_slots`` then takes the static-k fast paths
    (the fused top-k kernel K3, the probe skip).  Greedy rows don't
    vote."""
    ks = {c.top_k for c in configs if not c.greedy}
    if len(ks) == 1:
        k = ks.pop()
        if k > 0:
            return k
    return None


def _unported(mesh, draft_len: int, step_horizon: int) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh-native serving is not ported yet")
    if draft_len != 1:
        raise NotImplementedError(
            f"speculative decoding (draft_len={draft_len}) is not ported yet")
    if step_horizon != 1:
        raise NotImplementedError(
            f"fused decode horizons (step_horizon={step_horizon}) are not "
            "ported yet")


class ContinuousScheduler:
    """Slot-based continuous batcher over the runahead sampler.

    Callers drive it with ``admit`` / ``step`` / ``pop_finished``.
    ``device`` defaults to the device of the model's weights;
    ``compute_dtype`` is the forward's, ``cache_dtype`` the KV cache's.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int,
        context: int,
        spec_k: int = 5,
        rounds: int = 8,
        backend: str = "torch",
        cache_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        page_size: int | None = None,
        cache_pages: int | None = None,
        page_impl: str = "gather",
        mesh=None,
        draft_len: int = 1,
        step_horizon: int = 1,
    ):
        _unported(mesh, draft_len, step_horizon)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.context = context
        self.spec_k, self.rounds, self.backend = spec_k, rounds, backend
        self.compute_dtype = compute_dtype
        self.device = params["embed"].device
        dev = self.device

        self.paged = page_size is not None
        self.page_size = page_size
        self.page_impl = page_impl
        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if page_impl not in ("gather", "hopper"):
                raise ValueError(f"unknown page_impl {page_impl!r}")
            if not paged_supported(cfg):
                raise ValueError(
                    "the paged KV cache needs an all-dense layer stack "
                    "(see models.decode.paged_supported)")
            self.max_chain = pages_for(context, page_size)
            if cache_pages is None:
                # dense-equivalent capacity + the reserved null page
                cache_pages = n_slots * self.max_chain + 1
            self.cache = None
            self.pool = init_paged_pool(cfg, cache_pages, page_size,
                                        cache_dtype, device=dev)
            self.table = torch.zeros((n_slots, self.max_chain),
                                     dtype=torch.int32, device=dev)
            self.alloc = PageAllocator(cache_pages, page_size)
            self._chains: list[list[int] | None] = [None] * n_slots
            self.n_prefix_hits = 0       # admissions that forked a prefix
            self.n_prefill_skipped = 0   # prompt tokens never re-prefilled
        else:
            if cache_pages is not None:
                raise ValueError("cache_pages requires page_size")
            self.cache = init_cache(cfg, n_slots, context, cache_dtype,
                                    device=dev)
        self.token = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        self.slots: list[_SlotInfo | None] = [None] * n_slots
        self._finished: list[FinishedRequest] = []
        self._step_args = None     # (slots, active, enable, k, greedy)
        self.n_decode_steps = 0          # batched decode iterations
        self.n_host_syncs = 0            # device->host reads
        self.n_admissions = 0            # requests prefilled into a slot

    # -- occupancy ----------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_free_slot(self) -> bool:
        return self.n_active < self.n_slots

    def pop_finished(self) -> list[FinishedRequest]:
        done, self._finished = self._finished, []
        return done

    @property
    def peak_pages(self) -> int:
        """High-water mark of live pool pages (paged mode; else 0)."""
        return self.alloc.peak_used if self.paged else 0

    def validate_request(self, n_new: int, sampler: SamplerConfig,
                         prompt_len: int | None = None) -> None:
        """Reject what the scheduler cannot serve: called by the server at
        submit() time, BEFORE a request enters the queue."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if (sampler.spec_k, sampler.rounds, sampler.backend) != (
                self.spec_k, self.rounds, self.backend):
            raise ValueError(
                "request sampler spec_k/rounds/backend must match the "
                "scheduler's (they are shared by every slot's solve)")
        if self.paged and prompt_len is not None:
            plan = plan_chain(prompt_len, n_new, self.context,
                              self.page_size)
            if plan.chain_len > self.alloc.n_pages - 1:
                raise ValueError(
                    f"request needs {plan.chain_len} pages even with an "
                    f"empty pool; pool holds {self.alloc.n_pages - 1} "
                    "(admission could never succeed: raise cache_pages)")

    # -- admission ----------------------------------------------------------

    def _admit_paged(self, prompt: torch.Tensor, ptoks: list[int],
                     n_new: int):
        """Allocate the request's chain (forking registered prefix pages)
        and prefill into it; None when the pool is exhausted."""
        plan = plan_chain(len(ptoks), n_new, self.context, self.page_size)
        # longest registered prefix wins: each hit is one page of prompt
        # K/V that admission never recomputes (copy-on-write fork)
        chain: list[int] = []
        if not plan.wrap:
            for j in range(1, plan.share_cap + 1):
                pid = self.alloc.lookup_prefix(
                    prefix_key(ptoks, j * self.page_size))
                if pid is None:
                    break
                chain.append(pid)
        skip = len(chain)
        self.alloc.fork_prefix(chain)
        for _ in range(plan.chain_len - skip):
            pid = self.alloc.alloc()
            if pid is None:              # pool exhausted: undo, try later
                self.alloc.release(chain)
                return None
            chain.append(pid)
        if skip:
            self.n_prefix_hits += 1
            self.n_prefill_skipped += skip * self.page_size
        logits, self.pool = paged_prefill(
            self.cfg, self.params, prompt, self.context, self.pool,
            torch.tensor(chain, dtype=torch.int64, device=self.device),
            page_size=self.page_size, skip=skip,
            compute_dtype=self.compute_dtype)
        if not plan.wrap:
            for j in range(plan.register_cap):
                self.alloc.register_prefix(
                    prefix_key(ptoks, (j + 1) * self.page_size), chain[j])
        return logits, chain

    def admit(self, rid: Any, prompt, n_new: int, seed: int,
              sampler: SamplerConfig = SamplerConfig(), *,
              eos_id: int | None = None) -> bool:
        """Prefill one request into a free slot; False when none is free
        or the page pool cannot hold it yet.

        Replays the one-shot engine's opening moves for this request at
        B=1: prefill, then the first token from the prefill logits with
        the request's own config and generator.
        """
        ptoks = [int(t) for t in prompt]
        self.validate_request(n_new, sampler, prompt_len=len(ptoks))
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        i = free[0]
        prompt_t = torch.tensor([ptoks], dtype=torch.int64,
                                device=self.device)
        chain = None
        if self.paged:
            admitted = self._admit_paged(prompt_t, ptoks, n_new)
            if admitted is None:
                return False
            logits, chain = admitted
        else:
            logits, self.cache = prefill_into_slot(
                self.cfg, self.params, prompt_t, self.context, self.cache, i,
                compute_dtype=self.compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first = int(sample_slots(
            logits, [None if sampler.greedy else gen],
            SlotSamplers.stack([sampler], self.device),
            spec_k=self.spec_k, rounds=self.rounds, backend=self.backend,
            enable=_enable_bits([sampler]),
            top_k_static=_static_top_k([sampler]),
            greedy_only=sampler.greedy)[0])
        self.n_host_syncs += 1           # int(first)
        self.n_admissions += 1

        self.token[i] = first
        self.pos[i] = len(ptoks)
        info = _SlotInfo(rid, n_new - 1, [first], sampler, gen, eos_id)
        if info.remaining <= 0 or (eos_id is not None and first == eos_id):
            self._finished.append(FinishedRequest(rid, info.tokens))
            if self.paged:               # done at admission: pages go back
                self.alloc.release(chain)
        else:
            self.slots[i] = info
            self._step_args = None       # occupancy changed
            if self.paged:
                self._chains[i] = chain
                row = torch.zeros((self.max_chain,), dtype=torch.int32)
                row[:len(chain)] = torch.tensor(chain, dtype=torch.int32)
                self.table[i] = row.to(self.device)
        return True

    # -- the decode step ----------------------------------------------------

    def _ensure_step_args(self):
        """(Re)build the occupancy-derived step arguments; cached until
        admission or eviction changes which slots are live.  Builds the
        slot tensors on the device (host-to-device copies), so it runs
        before a step's sync-free part."""
        if self._step_args is None:
            live = [s.sampler for s in self.slots if s is not None]
            idle = SamplerConfig(spec_k=self.spec_k, rounds=self.rounds,
                                 backend=self.backend)
            self._step_args = (
                SlotSamplers.stack([s.sampler if s is not None else idle
                                    for s in self.slots], self.device),
                torch.tensor([s is not None for s in self.slots],
                             device=self.device),
                _enable_bits(live),
                _static_top_k(live),
                all(c.greedy for c in live),
            )
        return self._step_args

    def step_device(self) -> torch.Tensor:
        """The device part of one decode step over every slot: the forward,
        the per-slot sample, the frozen inactive lanes.  Reads nothing
        back to the host.  Returns the (B,) sampled tokens (inactive rows
        are dead); ``commit`` books them."""
        slots_arr, active, enable, top_k_static, greedy_only = (
            self._step_args)
        if self.paged:
            logits, self.pool = decode_step_paged(
                self.cfg, self.params, self.token, self.pos, self.pool,
                self.table, context=self.context,
                compute_dtype=self.compute_dtype, impl=self.page_impl)
        else:
            stash = cache_lanes(self.cache, self.pos)
            logits, self.cache = decode_step(
                self.cfg, self.params, self.token, self.pos, self.cache,
                compute_dtype=self.compute_dtype)
            # inactive lanes keep their pre-step cache state
            freeze_cache_lanes(self.cache, stash, self.pos, active)
        gens = [None if s is None or s.sampler.greedy else s.generator
                for s in self.slots]
        nxt = sample_slots(logits, gens, slots_arr, spec_k=self.spec_k,
                           rounds=self.rounds, backend=self.backend,
                           enable=enable, top_k_static=top_k_static,
                           greedy_only=greedy_only)
        self.token = torch.where(active, nxt, self.token)
        self.pos = torch.where(active, self.pos + 1, self.pos)
        self.n_decode_steps += 1
        return nxt

    def commit(self, nxt: torch.Tensor) -> dict[Any, list[int]]:
        """Read a step's tokens back (the step's one host sync), truncate
        each live slot's run at its budget and ``eos_id``, and evict the
        slots that finished.  Returns {rid: tokens emitted}."""
        out_host = nxt.tolist()
        self.n_host_syncs += 1
        emitted: dict[Any, list[int]] = {}
        for i, info in enumerate(self.slots):
            if info is None:
                continue
            run = [out_host[i]]
            done = len(run) >= info.remaining
            if info.eos_id is not None and info.eos_id in run:
                done = True
            info.tokens.extend(run)
            info.remaining -= len(run)
            emitted[info.rid] = run
            if done:
                self._evict(i, info)
        return emitted

    def _evict(self, i: int, info: _SlotInfo) -> None:
        self._finished.append(FinishedRequest(info.rid, info.tokens))
        self.slots[i] = None
        self._step_args = None
        if self.paged:
            # decref the chain (shared prefix pages stay live for their
            # other holders) and point the slot's table row at the null
            # page, so its dead per-step writes never land in a recycled
            # page
            self.alloc.release(self._chains[i])
            self._chains[i] = None
            self.table[i] = 0

    def step(self) -> dict[Any, list[int]]:
        """One decode step over every active slot: {rid: tokens emitted}."""
        if self.n_active == 0:
            return {}
        self._ensure_step_args()
        return self.commit(self.step_device())
