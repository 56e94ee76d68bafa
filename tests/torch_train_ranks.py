"""Rank bodies of the port's data-parallel training tests
(``tests/test_torch_train_mesh.py``, and the card case in
``tests/test_torch_cuda.py``).

Each function runs on every rank of a group that
``repro_torch.launch.mesh.spawn_local`` starts (gloo), and returns what
its test compares in the test process.  This module imports no JAX: the
ranks run the port only, and the test process holds their results
against the JAX package and the single-rank port.  Inputs arrive as
numpy arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging

import numpy as np
import torch

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    Placement,
    restore_pytree,
)
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import moe, testing, transformer
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.train import step
from repro_torch.tree import leaves


@contextlib.contextmanager
def recording_keep():
    """Each capacity cut's keep mask (``models/moe.py::_cut``: one a
    GShard group of a routing call, over the whole batch, the meshed
    step's gathered assignments included), in call order."""
    cut, keeps = moe._cut, []

    def recorded(*args, **kw):
        keep, pos = cut(*args, **kw)
        keeps.append(keep.detach().clone())
        return keep, pos

    moe._cut = recorded
    try:
        yield keeps
    finally:
        moe._cut = cut


@contextlib.contextmanager
def f32_forward():
    """``train/step.py``'s forward computing in f32 (the wrap the tests
    put on both packages' ``forward``)."""
    orig = step.forward
    step.forward = functools.partial(transformer.forward,
                                     compute_dtype=torch.float32)
    try:
        yield
    finally:
        step.forward = orig


def lr_fn(lr: float, warmup_steps: int, total_steps: int):
    return schedule.linear_warmup_cosine(lr, warmup_steps, total_steps)


def run_steps(cfg, params, tc_kw: dict, lr: tuple, batches: list,
              mesh=None) -> dict:
    """``len(batches)`` train steps from ``params`` (updated in place)
    with the f32 forward: each step's metrics as floats, the replica
    digest of the params and state after it, and each step's capacity
    cuts' keep masks (numpy)."""
    fn = step.make_train_step(cfg, step.TrainConfig(**tc_kw), lr_fn(*lr),
                              mesh=mesh)
    opt = adamw.adamw_init(params)
    out = {"metrics": [], "digests": [], "keeps": []}
    with f32_forward():
        for b in batches:
            batch = {k: torch.from_numpy(v).to(params["embed"].device)
                     for k, v in b.items()}
            with recording_keep() as keeps:
                params, opt, m = fn(params, opt, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["digests"].append(launch_train.replica_digest(
                {"params": params, "opt": opt}).tolist())
            out["keeps"].append([k.cpu().numpy() for k in keeps])
    out["params"] = params
    return out


def train_jobs(jobs: list, launcher_argv: list, ckpt_dir: str) -> dict:
    """On a 4-rank elastic mesh: each job (arch, config overrides, JAX's
    params as numpy, TrainConfig kwargs, lr schedule, batches) trained
    data-parallel (``run_steps``; rank 0 returns the params), the train
    launcher's main on ``launcher_argv`` in this world (its replicas
    checked, and their digests kept, after every step), and a checkpoint
    written under the mesh and restored on it through ``sharding_fn``
    (whole, and cut to this rank's block by a ``Placement``)."""
    logging.getLogger().setLevel(logging.WARNING)
    mesh = make_elastic_mesh(model_parallel=1)
    out = {"shape": dict(mesh.shape), "jobs": []}
    for arch, overrides, tree, tc_kw, lr, batches in jobs:
        cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
        got = run_steps(cfg, params_from_jax(tree, "cpu"), tc_kw, lr,
                        batches, mesh)
        got["params"] = ([t.numpy() for t in leaves(got["params"])]
                         if mesh.rank == 0 else None)
        out["jobs"].append(got)
    digests = []

    def on_state(i, state):
        launch_train.check_replicas(mesh, state, i)
        digests.append(launch_train.replica_digest(state).tolist())

    out["launcher"] = launch_train.main(launcher_argv, on_state=on_state)
    out["launcher"]["digests"] = digests

    tree = {"w": torch.arange(24, dtype=torch.float32).reshape(8, 3),
            "b": torch.arange(4, dtype=torch.bfloat16)}
    mgr = CheckpointManager(ckpt_dir, mesh=mesh)
    mgr.save(1, tree)
    names = []

    def whole(name, arr):
        names.append(name)
        return mesh.device

    _, back = mgr.restore_latest(tree, whole)
    block = restore_pytree(f"{ckpt_dir}/step_1", tree,
                           lambda name, arr: Placement(
                               mesh.device, ("data",) if name == "w" else (),
                               mesh))
    out["restore"] = {"names": names,
                      "equal": all(torch.equal(a, b) for a, b in
                                   zip(leaves(back), leaves(tree))),
                      "block": block["w"].numpy(), "b": block["b"].float()
                      .numpy(), "steps": mgr.steps()}
    return out


def cuda_train_checks(arch: str, capacity_mode: str) -> dict:
    """On ranks sharing cuda:0: two f32 steps of the reduced ``arch``
    (f32 params from seed 0 on this rank, the quantile clip: K2) under
    the elastic mesh and on this rank alone, from the same weights on
    the same global batches: {"mesh", "single"}, each ``run_steps``'
    metrics, keep masks and final params (numpy), the mesh's digests."""
    mesh = make_elastic_mesh(model_parallel=1)
    cfg = testing.reduced_config(arch)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, size=(4, 33)).astype(np.int64)
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    kw = dict(clip_mode="quantile", capacity_mode=capacity_mode,
              param_dtype="float32")
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        params = transformer.init_params(
            cfg, torch.Generator(device=mesh.device).manual_seed(0),
            torch.float32)
        got = run_steps(cfg, params, kw, (1e-3, 1, 10), batches, m)
        got["params"] = [t.cpu().numpy() for t in leaves(got["params"])]
        out[name] = got
    return out
