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

``--step-horizon K`` fuses K decode steps into one replay and one host
sync (``auto``: ``core/tuning.py::decide_step_horizon`` for the
workload's mean budget).  On the card every decode step or horizon is
one CUDA-graph replay, captured at its first step.

``--speculative`` turns on speculative decoding, as in the JAX launcher:
each decode step verifies L - 1 tokens an n-gram self-drafter proposed
from the request's own history.  ``--draft-len`` sets L (default ``auto``:
``core/tuning.py::decide_draft_len`` at an acceptance prior of 0.6, the
verify step priced from the card's measured verify steps,
``tuning.verify_step_cost``); ``--draft-len N`` with N > 1 turns
speculation on by itself.  ``--adaptive-draft`` re-decides L from the
measured acceptance while serving.  With ``--step-horizon`` K > 1 the
drafts are made on the card by repeating the current token:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-4b --reduced --continuous --speculative \
      --adaptive-draft --page-size 4 --device cpu

Runs on the card unless ``--device cpu`` is given.  On the card the
sampler backend and the page impl default to ``hopper`` (the kernels); on
the CPU to ``torch`` and ``gather`` (where ``hopper`` would run the
kernels' plain versions).  ``--backend auto`` leaves the backend to the
tuner per solve shape (``hopper`` on the card), and ``--autotune`` turns
on its measured tier: candidates are timed on the device and the winners
kept in the port's cache (``REPRO_TORCH_TUNING_CACHE``, by default
``build/repro_torch/solver_tuning.json`` in the checkout); a ``tuned
<key> -> ...`` line per decision is logged after the serve.  Without
``--autotune`` the serve still replays the winners that cache holds (its
solve decompositions, and kernel geometries that change K4, K5 and K6's
output bits within their tolerances); ``REPRO_DISABLE_TUNING=1`` pins the
fixed decomposition and today's geometries.
Weights are random, drawn from ``--seed``.

``--mesh DxM`` (with ``--continuous``, as in JAX) serves SPMD over a
``data x model`` mesh of ranks: D-way slot data parallelism, M-way
vocab-sharded sampler solves (``serving/scheduler.py``).  Outside
``torchrun`` the launcher starts the D*M ranks itself
(``launch/mesh.py::spawn_local``): on the card they share its GPUs (gloo
over CUDA tensors when there are fewer GPUs than ranks, NCCL when each
has its own); ``--host-devices N`` runs N gloo ranks on the CPU, the
counterpart of JAX's forced host devices.  Every rank draws the same
weights from ``--seed``; only rank 0 logs.  ``--page-size``,
``--step-horizon``, ``--speculative``, ``--draft-len`` and
``--adaptive-draft`` serve under the mesh as without it (rank 0
resolves ``auto`` and broadcasts it):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-4b --reduced --continuous --mesh 2x2 --host-devices 4 \
      --requests 6 --slots 4 --prompt-len 8 --new-tokens 6 --draft-len 3

The MoE archs (``--arch qwen2-moe-a2.7b``, ``granite-moe-3b-a800m``)
serve one-shot and on the dense ring (per step or fused), routing with
the FIFO capacity cut as the JAX launcher does; ``--page-size`` and
``--speculative`` raise for them, as in JAX:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-moe-a2.7b --reduced --continuous --requests 6 \
      --slots 2 --prompt-len 8 --new-tokens 6 --device cpu

The recurrent archs (``--arch xlstm-1.3b``: mLSTM / sLSTM blocks;
``--arch hymba-1.5b``: attention || SSM blocks, sliding-window attention
on all but 3 layers) serve one-shot and on the dense ring (per step or
fused), their recurrent state carried in the cache; ``--page-size`` and
``--speculative`` raise for them, as in JAX:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch xlstm-1.3b --reduced --batch 2 --prompt-len 12 \
      --new-tokens 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch hymba-1.5b --reduced --continuous --requests 6 --slots 2 \
      --prompt-len 12 --new-tokens 6 --step-horizon 4 --device cpu

The enc-dec arch (``--arch whisper-tiny``) serves one-shot: each row's
encoder frames (batch, encoder_len, d_model) are drawn in bf16 from the
seed after its prompt (the convolutional front end is a stub, as in the
JAX package); ``--continuous`` refuses it, as the JAX launcher does (the
scheduler's ``admit(encoder_frames=...)`` serves it continuously):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper-tiny --reduced --batch 2 --prompt-len 8 \
      --new-tokens 6 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.core import tuning
from repro_torch.kernels import ops
from repro_torch.launch import env
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import verify_supported
from repro_torch.models.testing import reduced_config
from repro_torch.models.transformer import Params, init_params
from repro_torch.serving.draft import RepeatLastDrafter
from repro_torch.serving.engine import DecodeGraphs, generate
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
    scheduler: ContinuousScheduler | None   # its counters and page
    # allocator (None in the result spawned ranks hand back)
    counts: dict[str, int]          # this serve's share of its counters


COUNTERS = ("decode_steps", "dispatches", "host_syncs", "admissions",
            "horizons", "wasted_steps", "drafted", "accepted",
            "draft_retunes")


def counters(s: ContinuousScheduler) -> dict[str, int]:
    """A scheduler's counters (``n_<name>``), by name."""
    return {name: getattr(s, f"n_{name}") for name in COUNTERS}


class Session(NamedTuple):
    """What serving holds between runs: the model, its sampler, and the
    one-shot decode step's graphs."""
    cfg: ModelConfig
    params: Params
    args: argparse.Namespace
    sampler: SamplerConfig
    gen: torch.Generator
    device: torch.device
    decode: DecodeGraphs
    mesh: mesh_lib.Mesh | None = None     # --mesh: this rank's mesh


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
    """One batch of prompts (and, for an enc-dec arch, their frames) from
    the session's generator, generated through the sampler; ``seconds``
    times ``generate`` alone."""
    cfg, params, args, sc, gen, device, decode = session[:7]
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    frames = (torch.randn((args.batch, cfg.encoder_len, cfg.d_model),
                          generator=gen, device=device, dtype=torch.bfloat16)
              if cfg.is_encdec else None)
    sync(device)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.new_tokens, gen, sampler=sc,
                    graphs=decode, encoder_frames=frames)
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


ACCEPTANCE_PRIOR = 0.6     # --draft-len auto's assumed acceptance


def speculating(args) -> bool:
    """``--speculative``, or ``--draft-len N`` with N > 1."""
    return args.speculative or args.draft_len not in ("auto", "1")


def resolve_draft_len(args, cfg: ModelConfig) -> int:
    """1 without speculation; ``--draft-len N`` pins L; ``auto`` asks
    ``decide_draft_len`` at the acceptance prior with a verify step
    priced as the card's measured verify steps are
    (``tuning.verify_step_cost``), not as L serial steps (the live
    counters refine it with ``--adaptive-draft``)."""
    if not speculating(args):
        return 1
    if not verify_supported(cfg):
        raise SystemExit(
            "--speculative needs an all-dense layer stack "
            f"(arch {args.arch!r} has recurrent/MoE layers)")
    if args.draft_len != "auto":
        return int(args.draft_len)
    row, overhead = tuning.verify_step_cost()
    return tuning.decide_draft_len(acceptance=ACCEPTANCE_PRIOR,
                                   token_cost=row, overhead=overhead)


def resolve_step_horizon(args, draft_len: int = 1) -> int:
    """``--step-horizon N`` pins K; ``auto`` asks ``decide_step_horizon``
    with the workload's mean budget (n_new is uniform in [new/2, new]) in
    decode steps, at ``1 + 0.6 (L - 1)`` tokens a step (the acceptance
    prior of ``--draft-len auto``)."""
    if args.step_horizon != "auto":
        return int(args.step_horizon)
    per_step = 1.0 + ACCEPTANCE_PRIOR * (draft_len - 1)
    return tuning.decide_step_horizon(
        mean_remaining=max(1.0, 0.75 * args.new_tokens / per_step))


def server_for(session: Session) -> RunaheadServer:
    """A fresh server (empty slots and cache) over the session's model.

    A speculative serve's ring holds the deepest draft row too (context
    ``prompt + new + max_draft_len - 1``): a verify that wrapped the ring
    would overwrite rows its shallower queries still read.  A fused
    speculative serve drafts on the card by repeating the current token:
    host drafters cannot run inside a horizon's graph.  Under a mesh the
    mesh's first rank resolves L and K and broadcasts them, so every
    rank captures and joins at the same ones."""
    cfg, params, args, sc = session[:4]
    draft_len = resolve_draft_len(args, cfg)
    step_horizon = resolve_step_horizon(args, draft_len)
    if session.mesh is not None:
        draft_len, step_horizon = session.mesh.broadcast_object(
            (draft_len, step_horizon), session.mesh.axis_names, 0)
    fused_spec = step_horizon > 1 and draft_len > 1
    auto = args.adaptive_draft and draft_len > 1
    max_draft_len = max(draft_len, 8) if auto else draft_len
    return RunaheadServer(
        cfg, params, n_slots=args.slots,
        context=args.prompt_len + args.new_tokens + max_draft_len - 1,
        spec_k=sc.spec_k,
        rounds=sc.rounds, backend=sc.backend, page_size=args.page_size,
        cache_pages=args.cache_pages, page_impl=args.page_impl,
        step_horizon=step_horizon, draft_len=draft_len,
        drafter=RepeatLastDrafter() if fused_spec else None,
        draft_len_auto=auto, max_draft_len=max_draft_len,
        mesh=session.mesh)


def run_continuous(session: Session,
                   server: RunaheadServer | None = None) -> ServedContinuous:
    """Serve the launcher's workload through ``server`` (a fresh one when
    None; a server served before replays the graphs it captured then);
    ``seconds`` times the serve alone, with a device sync at both ends."""
    cfg, _, args, sc, _, device = session[:6]
    if cfg.is_encdec:
        raise SystemExit("--continuous does not drive enc-dec archs yet")
    server = server or server_for(session)
    s = server.scheduler
    before = counters(s)
    capture_s = s.graphs.capture_s
    if args.page_size:
        log.info("paged KV cache on: page_size=%d, pool of %d pages (%s "
                 "impl)", args.page_size, s.alloc.n_pages, args.page_impl)
    if s.step_horizon > 1:
        log.info("fused decode horizons on: step_horizon=%d (one replay "
                 "and one host sync per %d decode iterations)",
                 s.step_horizon, s.step_horizon)
    if s.max_draft_len > 1:
        log.info("speculative decoding on: draft_len=%d (%s)%s",
                 s.draft_len, type(s.drafter).__name__,
                 ", live-retuned from acceptance" if s.draft_len_auto
                 else "")
    requests = continuous_requests(cfg, args, sc)
    sync(device)
    t0 = time.perf_counter()
    done = server.run(requests)
    sync(device)
    dt = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in counters(s).items()}
    n_tok = sum(len(c.tokens) for c in done)
    lat = np.sort(np.asarray([c.latency_s for c in done]))
    log.info("served %d requests / %d tokens in %.3fs over %d decode steps "
             "(%.1f tok/s; %d slots)", len(done), n_tok, dt,
             counts["decode_steps"], n_tok / dt, args.slots)
    log.info("dispatch accounting: %d dispatches, %d host syncs for %d "
             "decode iterations and %d admissions (%d horizons, %d "
             "all-idle iterations); %d graphs, %.3fs of this serve spent "
             "capturing", counts["dispatches"], counts["host_syncs"],
             counts["decode_steps"], counts["admissions"],
             counts["horizons"], counts["wasted_steps"],
             len(s.graphs.keys), s.graphs.capture_s - capture_s)
    if s.max_draft_len > 1:
        log.info("speculation: %d drafted, %d accepted (rate %.3f), %.2f "
                 "tokens per decode step, %d draft_len retunes (now %d), "
                 "%.1f ms drafting on the host%s", counts["drafted"],
                 counts["accepted"],
                 counts["accepted"] / max(1, counts["drafted"]),
                 (n_tok - counts["admissions"])
                 / max(1, counts["decode_steps"]),
                 counts["draft_retunes"], s.draft_len, 1e3 * s.draft_s,
                 "" if s.mesh is None else
                 " (counts over every slot of the mesh, host ms rank 0's)")
    log.info("latency p50=%.0fms p99=%.0fms max=%.0fms; max queue wait %d "
             "steps", 1e3 * float(np.quantile(lat, 0.5)),
             1e3 * float(np.quantile(lat, 0.99)), 1e3 * float(lat[-1]),
             max(c.queue_steps for c in done))
    if args.page_size:
        log.info("paging: peak %d pages (%d rows vs %d dense), %d prefix "
                 "hits, %d prefill tokens skipped", s.peak_pages,
                 s.peak_pages * args.page_size, args.slots * s.context,
                 s.n_prefix_hits, s.n_prefill_skipped)
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        log.info("rid=%s first tokens: %s", c.rid, c.tokens[:8])
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    if not all(0 <= t < cfg.vocab for c in done for t in c.tokens):
        raise RuntimeError("generated token ids out of range")
    return ServedContinuous(done, dt, s, counts)


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with ``--backend`` and ``--page-impl`` resolved."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first N layers (a depth cut; "
                         "every width stays the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--target-entropy", type=float, default=None)
    ap.add_argument("--backend", default=None,
                    choices=["torch", "hopper", "auto"],
                    help="engine backend for every sampler solve; auto "
                         "lets the tuner choose per solve shape (default: "
                         "hopper with --device cuda, torch with --device "
                         "cpu)")
    ap.add_argument("--autotune", action="store_true",
                    help="the tuner's measured tier: time the top "
                         "candidate configurations on the device and keep "
                         "the winners (REPRO_TORCH_TUNING_CACHE)")
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
    ap.add_argument("--step-horizon", default="1",
                    help="[continuous] decode steps fused per replay and "
                         "host sync: a count >= 1, or auto")
    ap.add_argument("--speculative", action="store_true",
                    help="[continuous] draft-and-verify speculative "
                         "decoding (n-gram self-drafting; dense archs)")
    ap.add_argument("--draft-len", default="auto",
                    help="[continuous] tokens fed per verify step, or auto "
                         "for the speculation cost model; N > 1 turns "
                         "speculation on by itself")
    ap.add_argument("--adaptive-draft", action="store_true",
                    help="[continuous] re-decide draft_len from the live "
                         "acceptance counters while serving")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="[continuous] mesh of ranks, e.g. 2x4 = 2-way "
                         "slot data-parallel x 4-way solver vocab sharding")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run the mesh's ranks on the CPU: N gloo ranks "
                         "(N must equal the mesh's size)")
    args = ap.parse_args(argv)
    if args.host_devices is not None:
        args.device = "cpu"              # the mesh's ranks on the CPU
    # on the card the kernels carry the path; the CPU keeps the plain ones
    on_card = args.device == "cuda"
    if args.backend is None:
        args.backend = "hopper" if on_card else "torch"
    if args.page_impl is None:
        args.page_impl = "hopper" if on_card else "gather"
    if not args.continuous and (args.page_size or args.cache_pages):
        ap.error("--page-size and --cache-pages need --continuous")
    for flag, value in (("--step-horizon", args.step_horizon),
                        ("--draft-len", args.draft_len)):
        if value != "auto" and not (value.isdigit() and int(value) >= 1):
            ap.error(f"{flag} must be a count >= 1 or auto, got {value!r}")
    if not args.continuous and speculating(args):
        ap.error("--speculative and --draft-len need --continuous")
    if args.mesh is not None:
        if not args.continuous:
            raise SystemExit("--mesh requires --continuous")
        try:
            dims, _ = mesh_lib.mesh_axes(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        if args.host_devices is not None and args.host_devices != \
                int(np.prod(dims)):
            ap.error(f"--host-devices {args.host_devices} does not match "
                     f"--mesh {args.mesh}")
    if args.host_devices is not None and args.mesh is None:
        ap.error("--host-devices needs --mesh")
    return args


def setup(argv=None) -> Session:
    """Parse the flags, then draw the model's weights on the device."""
    args = parse_args(argv)
    rank = dist.get_rank() if dist.is_initialized() else 0
    # under a mesh only rank 0 logs: every rank serves the same requests
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        mesh = mesh_lib.parse_mesh(args.mesh)
        if mesh.device.type != device.type:
            raise RuntimeError(f"--device {args.device} was asked for, but "
                               f"this rank of the mesh runs on {mesh.device}")
        device = mesh.device
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, torch.bfloat16)
    if mesh is not None:
        check_same_weights(mesh, params)
    sc = SamplerConfig(
        temperature=args.temperature,
        target_entropy=args.target_entropy,
        top_k=args.top_k,
        top_p=args.top_p,
        backend=args.backend,
    )
    return Session(cfg, params, args, sc, gen, device, DecodeGraphs(), mesh)


def weights_checksum(params: Params) -> torch.Tensor:
    """The f64 sum of every weight: a (1,) tensor on the weights' device,
    each leaf summed in f64 in chunks of 2**24 elements (a whole leaf in
    f64 would take four times its own memory)."""
    return torch.stack([c.sum(dtype=torch.float64)
                        for t in tree.leaves(params)
                        for c in t.detach().reshape(-1).split(1 << 24)]
                       ).sum().reshape(1)


def check_same_weights(mesh: mesh_lib.Mesh, params: Params) -> None:
    """Every rank drew the same weights from the seed (each on its own
    device generator): their checksums, gathered over the mesh, agree."""
    sums = mesh.all_gather(weights_checksum(params), mesh.axis_names)
    if not bool((sums == sums[0]).all()):
        raise RuntimeError(f"the mesh's ranks drew different weights: "
                           f"checksums {sums.tolist()}")


def log_decisions(autotuned: bool) -> None:
    """One ``tuned <key> -> ...`` line per solver and kernel decision the
    tuner took (``tuning.explain``), and the cache after a measured run."""
    for cfg_key, d in tuning.explain():
        log.info("tuned %s -> %s/%s spec_k=%d rounds=%d [%s]", cfg_key,
                 d.placement, d.backend, d.spec_k, d.rounds, d.source)
    for kern_key, kd in tuning.explain_kernels():
        log.info("tuned %s -> %s [%s]", kern_key, kd.label(), kd.source)
    if autotuned:
        log.info("tuning cache: %s", tuning.cache_path())


def _rank_main(argv) -> ServedContinuous:
    """One spawned rank of a ``--mesh`` launch: the launcher's main, its
    result without the scheduler (which stays in the rank)."""
    return main(argv)._replace(scheduler=None)


def main(argv=None) -> Served | ServedContinuous:
    env.configure()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh is not None and not dist.is_initialized():
        dims, _ = mesh_lib.mesh_axes(args.mesh)
        if mesh_lib.under_torchrun():
            mesh_lib.init_from_env(args.device)
        else:
            # the launcher starts the ranks itself: rank 0's result
            return mesh_lib.spawn_local(
                _rank_main, int(np.prod(dims)), device=args.device,
                args=(argv,))[0]
    session = setup(argv)
    with (tuning.autotune() if session.args.autotune
          else contextlib.nullcontext()):
        out = (run_continuous if session.args.continuous else run)(session)
    log.info("kernel launches: %s", dict(ops.LAUNCHES))
    log_decisions(session.args.autotune)
    return out


if __name__ == "__main__":
    main()
