"""Fixed-slot continuous-batching scheduler, per-step path and fused
decode horizons (port of ``repro.serving.scheduler``).

The scheduler keeps a fixed pool of ``n_slots`` decode lanes and admits /
evicts requests per decode step instead of waiting for a whole batch to
drain (the one-shot ``serving.engine.generate`` shape).  Device state is
slot-major and fixed-shape:

  * either one slotted dense cache (``models.decode.init_cache`` at
    batch = n_slots: K/V rings, int8 codes and scales with
    ``cache_dtype=torch.int8``, and, for the recurrent families, SSM and
    xLSTM states, for whisper its encoder K/V), recycled in place by
    per-slot prefill (whisper's with the request's frames), or a page
    pool plus an ``(n_slots, max_chain)`` page table (``page_size``), with
    pages allocated, shared copy-on-write and freed on the host
    (``serving.paged``);
  * (B,) current-token and position tensors: ``decode_step`` and
    ``decode_step_paged`` take one position per slot;
  * one ``torch.Generator`` per request, seeded with its seed, so a
    request draws the same noise as a B=1 one-shot ``generate``;
  * per-slot sampler knobs (``SlotSamplers``) riding the solver engine's
    batch axis, and the active mask.

Every device tensor here keeps its storage for the scheduler's life and
is written in place, because the decode runs as CUDA graphs that hold it
by address (``core/graphs.py``).  One step (``_step_body``, JAX's
``_step_body`` / ``_step_body_paged``) is one batched decode over every
slot plus one ``sample_slots``; inactive slots ride along masked out
(their token and position frozen; their dense ring rows restored and
their recurrent states left unwritten, their paged writes sent to the
null page).

``step_horizon == 1``: ``step_device`` is one replay of a graph of one
step, keyed by the statics JAX's step jits on (the enabled solves, the
static top_k, greedy-only, paged or dense); ``commit`` reads the step's
tokens back, the one host sync of a step, and books, truncates and
evicts.  ``step_horizon == K > 1`` (DESIGN.md §14): one replay runs K
iterations of the same step body, with EOS and budget detected on the
card (``_horizon_done``) so a slot that finishes at iteration j < K is
frozen for the rest; the host replays the (K, B) emissions once per
horizon.  Admission and eviction run between replays only.

Speculative decoding (``draft_len`` L > 1, JAX's verify branch): before
each step the host drafter (``serving.draft``) proposes L - 1 tokens per
live slot from its prompt and emitted history (``_SlotInfo.context``)
into a static (n_slots, L - 1) buffer; the step body feeds [token, draft]
through one ``decode_verify`` forward, accepts through ``verify_slots``,
and rolls back the rejected rows (``rollback_*`` with ``n_keep = 1 +
accepted`` for live slots and 0 for inactive ones, which replaces the
serial step's lane freeze).  A slot emits 1 to L tokens a step.  A fused
speculative horizon drafts on the card by repeating each slot's current
token (``RepeatLastDrafter``), since no host drafter can run inside a
graph.  ``draft_len_auto`` re-decides L from the measured acceptance
(``core/tuning.py::decide_draft_len``) at step or horizon boundaries; L
is part of the graph key, so each distinct L is captured once.

The noise: a graph cannot draw from generators that change at every
admission, so before each replay the host draws each live sampled slot's
uniforms from its generator into static buffers, the draws eager serving
makes (per slot per step, in slot order: (1, V) for a serial step, an
(L - 1) coin draw and (1, L, V) for a verify step), and the graph turns
them into Gumbel noise, so the streams are eager serving's bit for bit.

Not ported: the mesh.  Asking for a mesh raises.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from repro_torch.core.graphs import Graphs
from repro_torch.core.tuning import (
    DISPATCH_OVERHEAD,
    decide_draft_len,
    decide_step_horizon,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import (
    cache_lanes,
    decode_step,
    decode_step_paged,
    decode_verify,
    decode_verify_paged,
    freeze_cache_lanes,
    init_cache,
    init_paged_pool,
    mask_table_rows,
    paged_prefill,
    paged_supported,
    prefill_into_slot,
    rollback_cache_runs,
    rollback_paged_runs,
    verify_supported,
)
from repro_torch.models.transformer import unembed_table
from repro_torch.serving.draft import DraftSource, NGramDrafter
from repro_torch.serving.paged import (
    PageAllocator,
    pages_for,
    plan_chain,
    prefix_key,
)
from repro_torch.serving.sampler import (
    SamplerConfig,
    SlotSamplers,
    draw_slot_uniforms,
    draw_verify_uniforms,
    sample_slots,
    slot_noise,
    verify_slots,
)


@dataclasses.dataclass
class _SlotInfo:
    """Host-side bookkeeping for one occupied slot."""

    rid: Any
    remaining: int                  # tokens still owed
    tokens: list[int]               # emitted so far (includes prefill token)
    sampler: SamplerConfig
    generator: torch.Generator      # the request's own noise stream
    context: list[int] = dataclasses.field(default_factory=list)
    # prompt + emitted history, the draft source's lookup corpus
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


def _unported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh-native serving is not ported yet")


def _horizon_done(active, remaining, eos, out, n_acc):
    """In-horizon EOS/budget detection: the device dual of the host's
    truncation rules in ``ContinuousScheduler._finish_run``.

    A live slot emitted ``1 + n_acc`` tokens this iteration.  It is done
    when that meets its remaining budget, or when an EOS lands anywhere in
    the budget-truncated run: the order the host applies (budget first,
    then EOS within the surviving prefix), so device freeze and host
    eviction agree on the iteration a slot stops.  ``eos`` is -1 for
    slots without a stop token (never a token id).

    Returns (done (B,) bool, emitted (B,) int).
    """
    emitted = torch.where(active, 1 + n_acc, 0)
    lim = torch.minimum(emitted, remaining)
    cols = torch.arange(out.shape[1], device=out.device)[None, :]
    hit_eos = ((out == eos[:, None]) & (cols < lim[:, None])).any(dim=1)
    done = active & ((emitted >= remaining) | hit_eos)
    return done, emitted


class ContinuousScheduler:
    """Slot-based continuous batcher over the runahead sampler.

    Callers drive it with ``admit`` / ``step`` / ``pop_finished``.
    ``device`` defaults to the device of the model's weights;
    ``compute_dtype`` is the forward's, ``cache_dtype`` the KV cache's.
    ``step_horizon`` K fuses K decode steps into one replay; ``draft_len``
    L > 1 verifies L - 1 drafted tokens a step (``drafter``, default
    n-gram self-drafting), re-decided from the measured acceptance when
    ``draft_len_auto`` (up to ``max_draft_len``, which sizes the page
    chains and the draft and noise buffers).  The graphs are this
    instance's (they hold its state by address); a key's first step runs
    eagerly and captures it.
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
        drafter: DraftSource | None = None,
        step_horizon: int = 1,
        draft_len_auto: bool = False,
        max_draft_len: int | None = None,
    ):
        _unported(mesh)
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if draft_len_auto and draft_len < 2:
            raise ValueError(
                "draft_len_auto needs an initial draft_len >= 2: L = 1 "
                "never drafts, so the acceptance window that drives "
                "decide_draft_len would stay empty forever")
        if max_draft_len is None:
            max_draft_len = (max(draft_len, 8) if draft_len_auto
                             else draft_len)
        if max_draft_len < draft_len:
            raise ValueError(
                f"max_draft_len {max_draft_len} < draft_len {draft_len}")
        if max_draft_len > 1 and not verify_supported(cfg):
            raise ValueError(
                "speculative decoding (draft_len > 1) needs an all-dense "
                "layer stack: this config has recurrent/MoE layers (see "
                "models.decode.verify_supported)")
        if max_draft_len > context:
            raise ValueError(
                f"draft_len {max_draft_len} exceeds cache capacity "
                f"{context}")
        self.draft_len = draft_len
        self.draft_len_auto = draft_len_auto
        self.max_draft_len = max_draft_len
        # the acceptance window of a live retune: L is re-decided at a
        # boundary once the window holds this many drafted tokens
        self.draft_retune_min = 64
        self._retune_drafted_mark = 0
        self._retune_accepted_mark = 0
        self.drafter: DraftSource = (drafter if drafter is not None
                                     else NGramDrafter())
        if step_horizon < 1:
            raise ValueError(
                f"step_horizon must be >= 1, got {step_horizon}")
        if step_horizon > 1 and max_draft_len > 1 and not getattr(
                self.drafter, "device_capable", False):
            raise ValueError(
                "fused horizons (step_horizon > 1) draft on the card inside "
                "the horizon's graph, so a speculative scheduler needs a "
                "device-capable drafter (serving.draft.RepeatLastDrafter): "
                "host drafters cannot run mid-horizon")
        self.step_horizon = step_horizon
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.context = context
        self.spec_k, self.rounds, self.backend = spec_k, rounds, backend
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
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
                                    device=dev, compute_dtype=compute_dtype)
            self.table = None

        def zeros(dtype, *shape):
            return torch.zeros(shape or (n_slots,), dtype=dtype, device=dev)

        self.token = zeros(torch.int64)
        self.pos = zeros(torch.int64)
        self.active = zeros(torch.bool)
        idle = SamplerConfig(spec_k=spec_k, rounds=rounds, backend=backend)
        self.knobs = SlotSamplers.stack([idle] * n_slots, dev)
        self.remaining = zeros(torch.int64)      # budgets, horizon entry
        self.eos = zeros(torch.int64)            # stop tokens, -1 = none
        # the noise each iteration reads, drawn before a replay: (B, V)
        # uniforms for a serial step; an (L - 1) coin and (L, V) uniforms
        # a slot for a verify step, sliced to the current L
        V = unembed_table(cfg, params).shape[-1]
        K, Lm = step_horizon, max_draft_len
        self.uniforms = zeros(torch.float32, K, n_slots,
                              V if draft_len == 1 else 0)
        self.coins = zeros(torch.float32, K, n_slots, Lm - 1)
        self.verify_uniforms = zeros(torch.float32, K, n_slots,
                                     Lm if Lm > 1 else 0, V)
        self.draft = zeros(torch.int64, n_slots, Lm - 1)   # host drafts
        self.graphs = Graphs()
        self.slots: list[_SlotInfo | None] = [None] * n_slots
        self._finished: list[FinishedRequest] = []
        self._statics = None       # (enable, top_k_static, greedy_only)
        self.n_decode_steps = 0          # batched decode iterations
        self.n_dispatches = 0            # graph replays and eager calls
        self.n_host_syncs = 0            # device->host reads
        self.n_drafted = 0               # drafted tokens offered to verify
        self.n_accepted = 0              # drafted tokens accepted
        self.n_admissions = 0            # requests prefilled into a slot
        self.n_horizons = 0              # fused horizons (K > 1 only)
        self.n_wasted_steps = 0          # all-idle horizon iterations
        self.n_draft_retunes = 0         # live decide_draft_len L switches
        self.draft_s = 0.0               # host seconds in the drafter

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify steps accepted."""
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0

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
            # chains hold max_draft_len's overshoot, so a verify write past
            # the last position (or a live retune of L) stays on the chain
            plan = plan_chain(prompt_len, n_new, self.context,
                              self.page_size, self.max_draft_len)
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
        plan = plan_chain(len(ptoks), n_new, self.context, self.page_size,
                          self.max_draft_len)
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
              encoder_frames: torch.Tensor | None = None,
              eos_id: int | None = None) -> bool:
        """Prefill one request into a free slot; False when none is free
        or the page pool cannot hold it yet.

        Replays the one-shot engine's opening moves for this request at
        B=1, eagerly: prefill, then the first token from the prefill
        logits with the request's own config and generator.  An enc-dec
        arch (whisper) takes the request's own frames (1, T_enc, D), which
        its prefill encodes into the slot's encoder K/V; the paged cache
        does not serve it.
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
            if encoder_frames is not None:
                raise ValueError("paged cache does not serve enc-dec archs")
            admitted = self._admit_paged(prompt_t, ptoks, n_new)
            if admitted is None:
                return False
            logits, chain = admitted
        else:
            logits, self.cache = prefill_into_slot(
                self.cfg, self.params, prompt_t, self.context, self.cache, i,
                encoder_frames=encoder_frames,
                compute_dtype=self.compute_dtype, kv_dtype=self.cache_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first = int(sample_slots(
            logits, [None if sampler.greedy else gen],
            SlotSamplers.stack([sampler], self.device),
            spec_k=self.spec_k, rounds=self.rounds, backend=self.backend,
            enable=_enable_bits([sampler]),
            top_k_static=_static_top_k([sampler]),
            greedy_only=sampler.greedy)[0])
        self.n_dispatches += 2           # prefill + first-token sample
        self.n_host_syncs += 1           # int(first)
        self.n_admissions += 1

        self.token[i] = first
        self.pos[i] = len(ptoks)
        info = _SlotInfo(rid, n_new - 1, [first], sampler, gen,
                         context=ptoks + [first], eos_id=eos_id)
        if info.remaining <= 0 or (eos_id is not None and first == eos_id):
            self._finished.append(FinishedRequest(rid, info.tokens))
            if self.paged:               # done at admission: pages go back
                self.alloc.release(chain)
        else:
            self.slots[i] = info
            self._statics = None         # occupancy changed
            if self.paged:
                self._chains[i] = chain
                row = torch.zeros((self.max_chain,), dtype=torch.int32)
                row[:len(chain)] = torch.tensor(chain, dtype=torch.int32)
                self.table[i] = row.to(self.device)
        return True

    # -- the decode step ----------------------------------------------------

    def _ensure_step_args(self) -> tuple:
        """The step's statics (enable, top_k_static, greedy_only), and its
        slot inputs written into the static buffers the graphs read (the
        knobs and the active mask: host-to-device copies).  Redone only
        after admission or eviction changed which slots are live, so it
        runs before a step's sync-free part."""
        if self._statics is None:
            live = [s.sampler for s in self.slots if s is not None]
            idle = SamplerConfig(spec_k=self.spec_k, rounds=self.rounds,
                                 backend=self.backend)
            host = SlotSamplers.stack([s.sampler if s is not None else idle
                                       for s in self.slots], "cpu")
            for dst, src in zip(self.knobs, host):
                dst.copy_(src)
            self.active.copy_(torch.tensor([s is not None
                                             for s in self.slots]))
            self._statics = (_enable_bits(live), _static_top_k(live),
                             all(c.greedy for c in live))
        return self._statics

    def _noise(self, j: int, L: int) -> tuple:
        """Iteration j's noise buffers at draft length L (views of the
        static buffers)."""
        if L == 1:
            return (self.uniforms[j],)
        return self.coins[j, :, :L - 1], self.verify_uniforms[j, :, :L]

    def _draw_noise(self, iterations: int, L: int) -> None:
        """Each live sampled slot's noise for ``iterations`` steps at draft
        length L from its generator, into the static buffers the graph
        reads: the draws eager serving makes, in its order (a slot that
        finishes inside a horizon draws past its end; its generator goes
        with it).  Greedy-only steps draw nothing."""
        if self._statics[2]:
            return
        gens = [None if s is None or s.sampler.greedy else s.generator
                for s in self.slots]
        for j in range(iterations):
            if L == 1:
                draw_slot_uniforms(self.uniforms[j], gens)
            else:
                draw_verify_uniforms(*self._noise(j, L), gens)

    def _step_body(self, statics: tuple, L: int, active: torch.Tensor,
                   table: torch.Tensor | None, draft: torch.Tensor | None,
                   noise: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """One decode step over every slot (JAX's ``_step_body`` /
        ``_step_body_paged``); token, pos and the cache written in place.

        L == 1: the forward at each slot's position, the per-slot sample,
        inactive lanes frozen.  L > 1: one verify forward over [token,
        draft] (B, L), acceptance by ``verify_slots``, and the rejected
        rows rolled back (all L of an inactive slot).  Returns (out
        (B, L), n_acc (B,)): a live row b emitted ``out[b, :n_acc[b] +
        1]``; inactive rows are dead."""
        enable, top_k_static, greedy_only = statics
        kw = dict(spec_k=self.spec_k, rounds=self.rounds,
                  backend=self.backend, enable=enable,
                  top_k_static=top_k_static, greedy_only=greedy_only)
        if L == 1:
            if self.paged:
                logits, _ = decode_step_paged(
                    self.cfg, self.params, self.token, self.pos, self.pool,
                    table, context=self.context,
                    compute_dtype=self.compute_dtype, impl=self.page_impl)
            else:
                stash = cache_lanes(self.cache, self.pos)
                logits, _ = decode_step(
                    self.cfg, self.params, self.token, self.pos, self.cache,
                    compute_dtype=self.compute_dtype, active=active)
                # inactive lanes keep their pre-step cache state: their
                # recurrent states were never written, their ring rows
                # are put back
                freeze_cache_lanes(self.cache, stash, self.pos, active)
            nxt = sample_slots(
                logits, [None] * self.n_slots, self.knobs,
                noise=None if greedy_only else slot_noise(noise[0]), **kw)
            self.token.copy_(torch.where(active, nxt, self.token))
            self.pos.copy_(torch.where(active, self.pos + 1, self.pos))
            return nxt[:, None], torch.zeros_like(self.pos)

        feed = torch.cat([self.token[:, None], draft], dim=1)    # (B, L)
        if self.paged:
            grid, _, stash = decode_verify_paged(
                self.cfg, self.params, feed, self.pos, self.pool, table,
                context=self.context, compute_dtype=self.compute_dtype,
                impl=self.page_impl)
        else:
            grid, _, stash = decode_verify(
                self.cfg, self.params, feed, self.pos, self.cache,
                compute_dtype=self.compute_dtype)
        coins, uniforms = (None, None) if greedy_only else noise
        out, n_acc = verify_slots(grid, draft, [None] * self.n_slots,
                                  self.knobs, coins=coins,
                                  uniforms=uniforms, **kw)
        n_acc = torch.where(active, n_acc, 0)
        # live slots commit 1 + accepted rows; inactive slots get every
        # row restored, bit-frozen as in the serial branch
        n_keep = torch.where(active, 1 + n_acc, 0)
        if self.paged:
            rollback_paged_runs(self.pool, stash, table, self.pos, n_keep,
                                context=self.context)
        else:
            rollback_cache_runs(self.cache, stash, self.pos, n_keep)
        bonus = out.gather(1, n_acc[:, None])[:, 0]
        self.token.copy_(torch.where(active, bonus, self.token))
        self.pos.copy_(torch.where(active, self.pos + 1 + n_acc, self.pos))
        return out, n_acc

    def _packed_step(self, statics: tuple, L: int) -> torch.Tensor:
        """The per-step graph's body: one step, its (B, L) emissions and
        (B,) accept counts packed into one (B, L + 1) tensor, so the host
        reads a step back in one sync."""
        out, n_acc = self._step_body(statics, L, self.active, self.table,
                                     self.draft[:, :L - 1],
                                     self._noise(0, L))
        return torch.cat([out, n_acc[:, None]], dim=1)

    def _horizon(self, statics: tuple, L: int) -> torch.Tensor:
        """The fused horizon's body (JAX's ``_scheduler_horizon[_paged]``):
        K iterations of the step body, a slot done at iteration j frozen
        for the rest (on the paged cache its table row is pointed at the
        null page every iteration, so its dead writes land there).  A
        speculative iteration drafts each slot's current token repeated
        (``RepeatLastDrafter`` on the card).  Returns the (K, B, L + 2)
        packed emissions, accept counts and entry masks."""
        active, remaining = self.active, self.remaining
        packed = []
        for j in range(self.step_horizon):
            table = (mask_table_rows(self.table, active) if self.paged
                     else None)
            draft = self.token[:, None].repeat(1, L - 1) if L > 1 else None
            out, n_acc = self._step_body(statics, L, active, table, draft,
                                         self._noise(j, L))
            done, emitted = _horizon_done(active, remaining, self.eos, out,
                                          n_acc)
            packed.append(torch.cat([out, n_acc[:, None],
                                     active[:, None].long()], dim=1))
            active = active & ~done
            remaining = remaining - emitted
        return torch.stack(packed)

    def _write_drafts(self, L: int) -> None:
        """The host drafter's L - 1 tokens for every live slot, into the
        static draft buffer (one host-to-device copy); host time counted
        in ``draft_s``."""
        t0 = time.perf_counter()
        host = torch.zeros((self.n_slots, L - 1), dtype=torch.int64)
        for i, info in enumerate(self.slots):
            if info is not None:
                host[i] = torch.tensor(self.drafter(info.context, L - 1),
                                       dtype=torch.int64)
        self.draft[:, :L - 1].copy_(host)
        self.draft_s += time.perf_counter() - t0

    def step_device(self) -> torch.Tensor:
        """The device part of one decode step over every slot: the host
        drafts (L > 1) and noise, then one replay of the step graph of the
        current statics and L (a key's first step runs eagerly and
        captures it).  Reads nothing back to the host.  Returns the
        (B, L + 1) packed emissions and accept counts; ``commit`` books
        them."""
        L = self.draft_len
        if L > 1:
            self._write_drafts(L)
        self._draw_noise(1, L)
        packed = self.replay_step(L)
        self.n_decode_steps += 1
        self.n_dispatches += 1
        self.n_drafted += (L - 1) * self.n_active
        return packed

    def replay_step(self, L: int) -> torch.Tensor:
        """The step graph's replay alone, on drafts and noise already in
        the static buffers (what a device timing of a step brackets)."""
        statics = self._statics
        return self.graphs.run(
            ("step", self.paged, L) + statics,
            functools.partial(self._packed_step, statics, L),
            device=self.device)

    def _finish_run(self, info: _SlotInfo, run: list[int]):
        """Budget-then-EOS truncation of one slot's emitted run, the host
        contract ``_horizon_done`` mirrors on the card.  Returns
        (surviving run, done)."""
        done = False
        if len(run) >= info.remaining:       # budget truncation
            run = run[: info.remaining]
            done = True
        if info.eos_id is not None and info.eos_id in run:
            run = run[: run.index(info.eos_id) + 1]   # EOS truncation
            done = True
        return run, done

    def _commit_row(self, i: int, info: _SlotInfo, row: list[int], L: int,
                    emitted: dict[Any, list[int]]) -> None:
        """Book one live slot's packed row (L emissions, then its accept
        count): the run of 1 + accepted tokens, truncated by budget then
        EOS; evict on done."""
        n_acc = row[L]
        self.n_accepted += n_acc
        run, done = self._finish_run(info, row[:n_acc + 1])
        info.tokens.extend(run)
        info.context.extend(run)
        info.remaining -= len(run)
        emitted.setdefault(info.rid, []).extend(run)
        if done:
            self._evict(i, info)

    def commit(self, packed: torch.Tensor) -> dict[Any, list[int]]:
        """Read a step's packed emissions back (the step's one host sync),
        book each live slot's run, evict the slots that finished and
        retune L.  Returns {rid: tokens emitted}."""
        host = packed.tolist()
        self.n_host_syncs += 1
        L = packed.shape[1] - 1
        emitted: dict[Any, list[int]] = {}
        for i, info in enumerate(self.slots):
            if info is not None:
                self._commit_row(i, info, host[i], L, emitted)
        self._maybe_retune_draft_len()
        return emitted

    def _evict(self, i: int, info: _SlotInfo) -> None:
        self._finished.append(FinishedRequest(info.rid, info.tokens))
        self.slots[i] = None
        self._statics = None
        if self.paged:
            # decref the chain (shared prefix pages stay live for their
            # other holders) and point the slot's table row at the null
            # page, so its dead per-step writes never land in a recycled
            # page
            self.alloc.release(self._chains[i])
            self._chains[i] = None
            self.table[i] = 0

    def step(self) -> dict[Any, list[int]]:
        """Advance serving by one host-visible boundary: {rid: tokens
        emitted}.

        ``step_horizon == 1``: one decode step over every active slot, one
        replay and one host sync.  ``step_horizon == K > 1``: one fused
        horizon of K decode iterations, still one replay and one sync,
        its K iterations replayed into host state here.  Admission and
        eviction (and so the server's loop) run between calls only.
        """
        if self.n_active == 0:
            return {}
        self._ensure_step_args()
        if self.step_horizon == 1:
            return self.commit(self.step_device())
        return self._step_fused()

    def _step_fused(self) -> dict[Any, list[int]]:
        """One fused horizon, then one host replay of its (K, B) rows in
        iteration order, each live row through the per-step truncation
        and eviction.  The card's entry mask of every iteration must agree
        with the host's slot table: a divergence would mean the on-card
        done logic and the host contract drifted apart, so it raises
        instead of mis-attributing tokens."""
        statics = self._statics
        K, L = self.step_horizon, self.draft_len
        self.remaining.copy_(torch.tensor(
            [s.remaining if s is not None else 0 for s in self.slots]))
        self.eos.copy_(torch.tensor(
            [-1 if s is None or s.eos_id is None else s.eos_id
             for s in self.slots]))
        self._draw_noise(K, L)
        packed = self.graphs.run(
            ("horizon", K, self.paged, L) + statics,
            functools.partial(self._horizon, statics, L), device=self.device)
        self.n_decode_steps += K
        self.n_dispatches += 1           # the whole horizon is one replay
        self.n_horizons += 1
        host = packed.tolist()
        self.n_host_syncs += 1           # ... and one boundary read

        emitted: dict[Any, list[int]] = {}
        for j in range(K):
            live = [bool(row[L + 1]) for row in host[j]]
            self.n_wasted_steps += not any(live)
            self.n_drafted += (L - 1) * sum(live)
            for i, info in enumerate(self.slots):
                if live[i] != (info is not None):
                    raise RuntimeError(
                        "fused horizon freeze mask diverged from the host "
                        f"slot table at iteration {j}, slot {i}: on-card "
                        "done detection and host truncation disagree")
                if info is not None:
                    self._commit_row(i, info, host[j][i], L, emitted)
        self._maybe_retune_draft_len()
        return emitted

    # -- live re-tuning -----------------------------------------------------

    def _maybe_retune_draft_len(self) -> None:
        """Re-decide L from the live acceptance window at a boundary.

        Once the verify counters have seen at least ``draft_retune_min``
        drafted tokens since the last decision, the window's measured
        rate prices ``decide_draft_len`` (floor 2, so the window keeps
        filling).  L is part of the graph key, so a switch captures once
        per distinct L, bounded by ``max_draft_len``.
        """
        if not self.draft_len_auto:
            return
        drafted = self.n_drafted - self._retune_drafted_mark
        if drafted < self.draft_retune_min:
            return
        accepted = self.n_accepted - self._retune_accepted_mark
        self._retune_drafted_mark = self.n_drafted
        self._retune_accepted_mark = self.n_accepted
        new_len = max(2, decide_draft_len(
            acceptance=accepted / drafted,
            overhead=DISPATCH_OVERHEAD / self.step_horizon,
            max_draft_len=self.max_draft_len))
        if new_len != self.draft_len:
            self.draft_len = new_len
            self.n_draft_retunes += 1

    def suggested_step_horizon(self, *, max_horizon: int = 32) -> int:
        """K the cost model (``core/tuning.py::decide_step_horizon``)
        would pick for the live workload: the mean remaining budget over
        occupied slots, in decode steps of ``1 + acceptance * (L - 1)``
        tokens each.  The horizon stays fixed per scheduler instance (its
        graphs are captured at it), so callers read this between
        serves."""
        live = [s.remaining for s in self.slots if s is not None]
        if not live:
            return self.step_horizon
        per_step = 1.0 + self.acceptance_rate * (self.draft_len - 1)
        return decide_step_horizon(
            mean_remaining=max(1.0, (sum(live) / len(live)) / per_step),
            max_horizon=max_horizon)
