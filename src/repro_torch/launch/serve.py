"""Serving entry point through the runahead-bisection sampler (port of
``repro.launch.serve``).

One-shot mode: the whole batch prefills and decodes in lock step.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-4b --batch 4 --prompt-len 64 --new-tokens 16 \
      --top-k 40 --top-p 0.9 --target-entropy 3.0 --backend hopper

Continuous mode: a fixed slot pool with per-step admission and eviction;
requests with staggered arrivals stream through
``serving.server.RunaheadServer``.  ``--page-size`` swaps the dense
per-slot ring for the page-table cache (copy-on-write prefix sharing),
whose attention is ``--page-impl gather`` (the dense reduction over the
gathered chain) or ``hopper`` (the hand-written kernel K6):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-4b --continuous --requests 8 --slots 4 \
      --arrival-burst 2 --prompt-len 512 --new-tokens 32 --page-size 16 \
      --page-impl hopper --top-k 40 --top-p 0.9 --target-entropy 3.0 \
      --backend hopper

Runs on the card unless ``--device cpu`` is given.  On the card the
sampler backend and the page impl default to ``hopper`` (the kernels); on
the CPU to ``torch`` and ``gather`` (where ``hopper`` would run the
kernels' plain versions).
Weights are random, drawn from ``--seed``.  Meshes, speculative decoding,
fused horizons and autotuning are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.testing import reduced_config
from repro_torch.models.transformer import Params, init_params
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.server import Completion, Request, RunaheadServer

log = logging.getLogger("repro_torch.serve")


class Served(NamedTuple):
    tokens: torch.Tensor        # (B, n_new) on the run's device
    seconds: float              # wall time of generate, device work included


class ServedContinuous(NamedTuple):
    completions: list[Completion]   # one per request, in completion order
    seconds: float                  # wall time of the serve, device included
    scheduler: ContinuousScheduler  # its counters and page allocator


class Session(NamedTuple):
    """What serving holds between runs: the model and its sampler."""
    cfg: ModelConfig
    params: Params
    args: argparse.Namespace
    sampler: SamplerConfig
    gen: torch.Generator
    device: torch.device


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; asking for ``cuda`` without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no "
                           "CUDA device (pass --device cpu to run on the CPU)")
    return torch.device(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(session: Session) -> Served:
    """One batch of prompts from the session's generator, generated through
    the sampler; ``seconds`` times ``generate`` alone."""
    cfg, params, args, sc, gen, device = session
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    sync(device)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.new_tokens, gen, sampler=sc)
    sync(device)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.new_tokens
    log.info("generated %d tokens in %.3fs (%.1f tok/s)",
             n_tok, dt, n_tok / dt)
    log.info("sample row: %s", toks[0, :16].tolist())
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError("generated token ids out of range")
    return Served(toks, dt)


def continuous_requests(cfg: ModelConfig, args, sc: SamplerConfig
                        ) -> list[Request]:
    """The driver's workload, drawn as the JAX driver draws it: prompts
    uniform over the vocab, ``n_new`` uniform in [new/2, new], seed
    ``seed + i``, ``arrival-burst`` requests arriving per decode step."""
    rng = np.random.default_rng(args.seed)
    return [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).tolist(),
            n_new=int(rng.integers(max(1, args.new_tokens // 2),
                                   args.new_tokens + 1)),
            seed=args.seed + i,
            sampler=sc,
            arrival=i // max(1, args.arrival_burst),
        )
        for i in range(args.requests)
    ]


def server_for(session: Session) -> RunaheadServer:
    """A fresh server (empty slots and cache) over the session's model."""
    cfg, params, args, sc, _, _ = session
    return RunaheadServer(
        cfg, params, n_slots=args.slots,
        context=args.prompt_len + args.new_tokens, spec_k=sc.spec_k,
        rounds=sc.rounds, backend=sc.backend, page_size=args.page_size,
        cache_pages=args.cache_pages, page_impl=args.page_impl)


def run_continuous(session: Session) -> ServedContinuous:
    """Serve the driver's workload through a fresh server; ``seconds``
    times the serve alone, with a device sync at both ends."""
    cfg, _, args, sc, _, device = session
    server = server_for(session)
    s = server.scheduler
    if args.page_size:
        log.info("paged KV cache on: page_size=%d, pool of %d pages (%s "
                 "impl)", args.page_size, s.alloc.n_pages, args.page_impl)
    requests = continuous_requests(cfg, args, sc)
    sync(device)
    t0 = time.perf_counter()
    done = server.run(requests)
    sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done)
    lat = np.sort(np.asarray([c.latency_s for c in done]))
    log.info("served %d requests / %d tokens in %.3fs over %d decode steps "
             "(%.1f tok/s; %d slots)", len(done), n_tok, dt,
             s.n_decode_steps, n_tok / dt, args.slots)
    log.info("host syncs: %d for %d decode steps and %d admissions",
             s.n_host_syncs, s.n_decode_steps, s.n_admissions)
    log.info("latency p50=%.0fms p99=%.0fms max=%.0fms; max queue wait %d "
             "steps", 1e3 * float(np.quantile(lat, 0.5)),
             1e3 * float(np.quantile(lat, 0.99)), 1e3 * float(lat[-1]),
             max(c.queue_steps for c in done))
    if args.page_size:
        log.info("paging: peak %d pages (%d rows vs %d dense), %d prefix "
                 "hits, %d prefill tokens skipped", s.peak_pages,
                 s.peak_pages * args.page_size,
                 args.slots * (args.prompt_len + args.new_tokens),
                 s.n_prefix_hits, s.n_prefill_skipped)
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        log.info("rid=%s first tokens: %s", c.rid, c.tokens[:8])
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    if not all(0 <= t < cfg.vocab for c in done for t in c.tokens):
        raise RuntimeError("generated token ids out of range")
    return ServedContinuous(done, dt, s)


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with ``--backend`` and ``--page-impl`` resolved."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--target-entropy", type=float, default=None)
    ap.add_argument("--backend", default=None, choices=["torch", "hopper"],
                    help="engine backend for every sampler solve (default: "
                         "hopper with --device cuda, torch with --device "
                         "cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching (RunaheadServer)")
    ap.add_argument("--requests", type=int, default=12,
                    help="[continuous] number of requests to serve")
    ap.add_argument("--slots", type=int, default=4,
                    help="[continuous] decode slot pool size")
    ap.add_argument("--arrival-burst", type=int, default=2,
                    help="[continuous] requests arriving per decode step")
    ap.add_argument("--page-size", type=int, default=None,
                    help="[continuous] KV-cache page size in rows; enables "
                         "the page-table cache (dense ring when omitted)")
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="[continuous] page-pool size (requires "
                         "--page-size; default fits slots*context + null)")
    ap.add_argument("--page-impl", default=None,
                    choices=["gather", "hopper"],
                    help="[continuous] paged attention: the gather (bit-"
                         "exact vs dense) or the hand-written kernel K6 "
                         "(default: hopper with --device cuda, gather with "
                         "--device cpu)")
    args = ap.parse_args(argv)
    # on the card the kernels carry the path; the CPU keeps the plain ones
    on_card = args.device == "cuda"
    if args.backend is None:
        args.backend = "hopper" if on_card else "torch"
    if args.page_impl is None:
        args.page_impl = "hopper" if on_card else "gather"
    if not args.continuous and (args.page_size or args.cache_pages):
        ap.error("--page-size and --cache-pages need --continuous")
    return args


def setup(argv=None) -> Session:
    """Parse the flags, then draw the model's weights on the device."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, torch.bfloat16)
    sc = SamplerConfig(
        temperature=args.temperature,
        target_entropy=args.target_entropy,
        top_k=args.top_k,
        top_p=args.top_p,
        backend=args.backend,
    )
    return Session(cfg, params, args, sc, gen, device)


def main(argv=None) -> Served | ServedContinuous:
    session = setup(argv)
    out = (run_continuous if session.args.continuous else run)(session)
    log.info("kernel launches: %s", dict(ops.LAUNCHES))
    return out


if __name__ == "__main__":
    main()
