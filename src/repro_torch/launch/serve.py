"""Serving entry point, one-shot mode: the whole batch prefills and decodes in
lock step through the runahead-bisection sampler (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-4b --batch 4 --prompt-len 64 --new-tokens 16 \
      --top-k 40 --top-p 0.9 --target-entropy 3.0 --backend hopper

Runs on the card unless ``--device cpu`` is given (on the CPU the
``hopper`` backend runs its kernels' plain versions).  Weights are random,
drawn from ``--seed``.  Continuous batching, meshes, paging, speculative
decoding and autotuning are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import NamedTuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.testing import reduced_config
from repro_torch.models.transformer import Params, init_params
from repro_torch.serving.engine import generate
from repro_torch.serving.sampler import SamplerConfig

log = logging.getLogger("repro_torch.serve")


class Served(NamedTuple):
    tokens: torch.Tensor        # (B, n_new) on the run's device
    seconds: float              # wall time of generate, device work included


class Session(NamedTuple):
    """What one-shot serving holds between runs: the model and its sampler."""
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(session: Session) -> Served:
    """One batch of prompts from the session's generator, generated through
    the sampler; ``seconds`` times ``generate`` alone."""
    cfg, params, args, sc, gen, device = session
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.new_tokens, gen, sampler=sc)
    _sync(device)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.new_tokens
    log.info("generated %d tokens in %.3fs (%.1f tok/s)",
             n_tok, dt, n_tok / dt)
    log.info("sample row: %s", toks[0, :16].tolist())
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError("generated token ids out of range")
    return Served(toks, dt)


def setup(argv=None) -> Session:
    """Parse the flags, then draw the model's weights on the device."""
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
    ap.add_argument("--backend", default="torch", choices=["torch", "hopper"],
                    help="engine backend for every sampler solve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

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


def main(argv=None) -> Served:
    out = run(setup(argv))
    log.info("kernel launches: %s", dict(ops.LAUNCHES))
    return out


if __name__ == "__main__":
    main()
