"""End-to-end training driver with checkpoint/restart and a straggler
watchdog (port of ``repro.launch.train``).

Fault tolerance: resume from the newest valid checkpoint, periodic async
saves, EWMA straggler detection, and ``--die-at-step`` fault injection
(drain the async writer, then exit 42).  Runs on the card unless
``--device cpu`` is given; weights are random bf16, drawn from ``--seed``
by a ``torch.Generator`` on the device.  One device (the JAX driver's
``--mesh`` waits for the port's multi-GPU layer).  Every decoder-only
family trains (dense, MoE, hymba, xlstm); an enc-dec arch (whisper)
raises, as JAX's launcher fails on it: its batches carry no frames.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch internlm2-1.8b --steps 5 --batch 2 --seq 4096 \\
      --clip-mode quantile
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 6 --batch 4 --seq 32 --clip-mode quantile
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite-moe-3b-a800m --reduced --capacity-mode bisect \\
      --steps 4 --batch 2 --seq 32 --clip-mode quantile
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch xlstm-1.3b --steps 4 --batch 2 --seq 1024 --clip-mode quantile
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.serve import resolve_device, sync
from repro_torch.models.testing import reduced_config
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.runtime.watchdog import StragglerWatchdog
from repro_torch.train.step import TrainConfig, make_train_step

log = logging.getLogger("repro_torch.train")


def build(args):
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.is_encdec:
        # SyntheticTokens has no frames: JAX's launcher fails the same way
        # (its forward asserts); train an enc-dec model through
        # train.step.make_train_step with batch["frames"]
        raise ValueError(
            f"{args.arch} is an encoder-decoder model: the launcher's "
            f"token stream carries no encoder frames")
    tc = TrainConfig(
        lr=args.lr,
        warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
        n_microbatches=args.microbatches,
        capacity_mode=args.capacity_mode,
        clip_mode=args.clip_mode,
        compress=args.compress,
        remat=not args.no_remat,
    )
    lr_fn = linear_warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    step_fn = make_train_step(cfg, tc, lr_fn)
    return cfg, tc, step_fn


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="train the config's first N layers (a depth cut; "
                         "every width stays the config's)")
    ap.add_argument("--capacity-mode", default="fifo",
                    choices=["fifo", "bisect"],
                    help="MoE capacity cut: GShard's FIFO drop, or the "
                         "per-expert gate threshold by runahead bisection "
                         "(K3 on the card)")
    ap.add_argument("--clip-mode", default="global",
                    choices=["global", "quantile"])
    ap.add_argument("--compress", default=None, choices=[None, "int8_ef"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="fault-injection: hard-exit at this step")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, *, on_step=None):
    """Train; returns {first_loss, last_loss, straggler_events} as the JAX
    driver does, plus ``losses`` (one per step run) and ``step_seconds``
    (host clock per step, the device synced at its end).  ``on_step(step,
    metrics)``, when given, is called after each step."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    cfg, tc, step_fn = build(args)

    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, getattr(torch, tc.param_dtype))
    opt_state = adamw_init(params, compress=tc.compress)
    start_step = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            start_step, tree = restored
            params, opt_state = tree["params"], tree["opt"]
            del tree
            log.info("resumed from checkpoint step %d", start_step)

    watchdog = StragglerWatchdog()
    losses, step_seconds = [], []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        watchdog.step_start()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])           # waits for the step
        sync(device)
        step_seconds.append(time.perf_counter() - t0)
        if watchdog.step_end(step):
            log.warning("straggler detected at step %d (events=%d)",
                        step, len(watchdog.events))
        losses.append(loss)
        if on_step is not None:
            on_step(step, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %5d loss %.4f ce %.4f lr %.2e",
                     step, loss, float(metrics["ce"]), float(metrics["lr"]))
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
        if args.die_at_step is not None and step == args.die_at_step:
            # crash BETWEEN checkpoint windows: drain the async writer
            # first, else os._exit kills the daemon thread with only
            # tmp.<step> on disk (a mid-write crash is covered by the
            # atomic rename: tmp dirs are never restored from)
            if mgr is not None:
                mgr.wait()
            log.error("fault injection: dying at step %d", step)
            os._exit(42)
    if mgr is not None:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
    dt = time.time() - t_start
    n = len(losses)
    if n:
        log.info("done: %d steps in %.1fs (%.2f steps/s); loss %.4f -> %.4f",
                 n, dt, n / max(dt, 1e-9), losses[0], losses[-1])
    return {"first_loss": losses[0] if n else None,
            "last_loss": losses[-1] if n else None,
            "straggler_events": len(watchdog.events),
            "losses": losses, "step_seconds": step_seconds}


if __name__ == "__main__":
    main()
