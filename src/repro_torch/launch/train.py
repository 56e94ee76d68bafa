"""End-to-end training driver with checkpoint/restart and a straggler
watchdog (port of ``repro.launch.train``).

Fault tolerance: resume from the newest valid checkpoint, periodic async
saves, EWMA straggler detection, and ``--die-at-step`` fault injection
(drain the async writer, then exit 42).  Runs on the card unless
``--device cpu`` is given; weights are random bf16, drawn from ``--seed``
by a ``torch.Generator`` on the device.  Every decoder-only family
trains (dense, MoE, hymba, xlstm); an enc-dec arch (whisper) raises, as
JAX's launcher fails on it: its batches carry no frames.

``--mesh elastic`` (the default, as JAX's) trains data-parallel over the
ranks of the world (``runtime/elastic.py::make_elastic_mesh(
model_parallel=1)``: data = world, so a world of one is the one-device
run; ``train/step.py`` has the step).  The ranks come from ``torchrun``
(``launch/mesh.py::init_from_env``) or from ``--host-devices N``, which
spawns N ranks on this host on ``--device`` (ranks beyond the host's
GPUs share them, over gloo).  Every rank draws the global batch
(``host_count`` 1, as JAX's launcher) and keeps its rows; rank 0 logs
and writes the checkpoints.  The ranks' params and optimizer state stay
bit-identical; ``check_replicas``, called from ``on_state``, checks it
(the tests and ``chip_smoke.py`` do, after every step).
Checkpoints are unsharded, so a run resumes on any world size: saved by
4 ranks, resumed on 2 or 1.  ``--die-at-step`` drains rank 0's writer,
then every rank exits 42, and the launcher with it.

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
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --host-devices 4 --steps 4 --batch 8 --seq 32 \\
      --clip-mode quantile
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import resolve_device, sync
from repro_torch.models.testing import reduced_config
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.runtime.watchdog import StragglerWatchdog
from repro_torch.train.step import TrainConfig, make_train_step

log = logging.getLogger("repro_torch.train")


def build(args, mesh=None):
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
    step_fn = make_train_step(cfg, tc, lr_fn, mesh=mesh)
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
    ap.add_argument("--mesh", default="elastic", choices=["elastic", "single"],
                    help="elastic: data-parallel over the world's ranks "
                         "(one rank: the one-device run); single: one "
                         "device, no process group")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="spawn this many ranks on this host, on --device "
                         "(needs --mesh elastic)")
    args = ap.parse_args(argv)
    if args.host_devices is not None:
        if args.mesh != "elastic":
            ap.error("--host-devices needs --mesh elastic")
        if args.host_devices < 1:
            ap.error("--host-devices must be >= 1")
    return args


def replica_digest(state) -> torch.Tensor:
    """A (n_leaves,) int64 tensor: each leaf's bits summed as integers
    (exact, on the leaf's device).  Ranks that hold one replicated state
    give equal digests; a bit that differs changes its leaf's sum."""
    sums = []
    for leaf in tree.leaves(state):
        bits = leaf.detach().reshape(-1)
        if bits.is_floating_point():
            bits = bits.view({2: torch.int16, 4: torch.int32,
                              8: torch.int64}[bits.element_size()])
        sums.append(sum(c.sum(dtype=torch.int64)
                        for c in bits.split(1 << 24)))
    return torch.stack(sums)


def check_replicas(mesh, state, step: int) -> None:
    """Every rank's params and optimizer state are bit-identical: their
    ``replica_digest``s, gathered over the mesh, agree."""
    digest = replica_digest(state)
    got = mesh.all_gather(digest[None], mesh.axis_names)
    if not bool((got == got[0]).all()):
        bad = [r for r in range(got.shape[0])
               if not bool((got[r] == got[0]).all())]
        raise RuntimeError(f"after step {step} the replicas of ranks {bad} "
                           f"differ from rank 0's")


def main(argv=None, *, on_step=None, on_state=None):
    """Train; returns {first_loss, last_loss, straggler_events} as the JAX
    driver does, plus ``losses`` (one per step run), ``step_seconds``
    (host clock per step, the device synced at its end), ``world`` (the
    ranks that trained) and ``join_seconds`` (per step, the collectives'
    host seconds, ``mesh.stats``).  ``on_step(step, metrics)``, when
    given, is called after each step, and then ``on_state(step, state)``
    with ``{"params", "opt"}``.  A ``--host-devices`` launch
    returns rank 0's result; its ``--die-at-step`` raises SystemExit(42)
    here once every rank has exited 42."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh == "elastic" and not dist.is_initialized():
        if args.host_devices is not None:
            try:
                return mesh_lib.spawn_local(
                    main, args.host_devices, device=args.device,
                    args=(argv,), timeout=24 * 3600.0)[0]
            except mesh_lib.RankExit as e:
                if e.exitcode == 42:
                    raise SystemExit(42) from None
                raise
        if mesh_lib.under_torchrun():
            mesh_lib.init_from_env(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    # under a mesh only rank 0 logs: every rank trains the same model
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh == "elastic":
        mesh = make_elastic_mesh(model_parallel=1)
        if mesh.size > 1:
            if mesh.device.type != device.type:
                raise RuntimeError(
                    f"--device {args.device} was asked for, but this rank "
                    f"of the mesh runs on {mesh.device}")
            device = mesh.device
            log.info("data-parallel over %d ranks (%s)", mesh.size,
                     dist.get_backend())
        else:
            mesh = None                  # one rank: the one-device run
    cfg, tc, step_fn = build(args, mesh)

    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, getattr(torch, tc.param_dtype))
    opt_state = adamw_init(params, compress=tc.compress)
    start_step = 0

    mgr = (CheckpointManager(args.ckpt_dir, mesh=mesh) if args.ckpt_dir
           else None)
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state},
                                      lambda name, arr: device)
        if restored is not None:
            start_step, state = restored
            params, opt_state = state["params"], state["opt"]
            del state
            log.info("resumed from checkpoint step %d", start_step)

    watchdog = StragglerWatchdog()
    losses, step_seconds, join_seconds = [], [], []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        watchdog.step_start()
        if mesh is not None:
            mesh.stats.reset()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])           # waits for the step
        sync(device)
        step_seconds.append(time.perf_counter() - t0)
        if mesh is not None:
            join_seconds.append(mesh.stats.seconds)
        if watchdog.step_end(step):
            log.warning("straggler detected at step %d (events=%d)",
                        step, len(watchdog.events))
        losses.append(loss)
        if on_step is not None:
            on_step(step, metrics)
        if on_state is not None:
            on_state(step, {"params": params, "opt": opt_state})
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
            "losses": losses, "step_seconds": step_seconds,
            "world": 1 if mesh is None else mesh.size,
            "join_seconds": join_seconds}


if __name__ == "__main__":
    main()
