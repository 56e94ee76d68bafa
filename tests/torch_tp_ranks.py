"""Rank bodies of the port's tensor-parallel tests
(``tests/test_torch_tp.py``, and the card case in
``tests/test_torch_cuda.py``).

``tp_jobs`` runs on every rank of a group that
``repro_torch.launch.mesh.spawn_local`` starts (gloo) and returns what
the test process compares.  This module imports no JAX: the ranks run
the port only, on weights and inputs that arrive as numpy arrays.  Every
rank builds the same meshes in the same order (a mesh's process groups
are collective calls), so each job builds its own.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

import torch_train_ranks as train_ranks
from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.convert import params_from_jax
from repro_torch.core import applications
from repro_torch.core.solver import MeshPolicy, mesh_policy
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import TRAIN_RULES, axis_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (
    gather_params,
    place_cache,
    place_params,
    tp_sharding_fn,
    zero1_block,
)
from repro_torch.models import decode, testing, transformer
from repro_torch.optim import adamw
from repro_torch.serving import sampler
from repro_torch.train import step
from repro_torch.tree import leaves, leaves_with_path, unflatten

F32 = torch.float32


def config(arch: str, overrides: dict):
    return dataclasses.replace(testing.reduced_config(arch), **overrides)


def mesh_of(dims) -> Mesh:
    return Mesh(tuple(dims), ("data", "model"))


def gather_vocab(mesh, logits: torch.Tensor) -> np.ndarray:
    """Every rank's block of vocab columns, whole (numpy)."""
    return tp.gather_heads(mesh, logits.contiguous(), logits.ndim - 1
                           ).numpy()


def _np_tree(tree):
    return [t.detach().cpu().numpy().copy() for t in leaves(tree)]


def forward_job(arch, overrides, jparams, tokens, dims, capacity_mode,
                seq_sp):
    """The layout's forward on ``dims``: the whole f32 logits and aux."""
    cfg = config(arch, overrides)
    mesh = mesh_of(dims)
    local = place_params(params_from_jax(jparams, "cpu"), mesh, cfg)
    toks = torch.from_numpy(tokens)
    rules = (axis_rules(TRAIN_RULES, mesh) if seq_sp
             else contextlib.nullcontext())
    with torch.no_grad(), tp.tensor_parallel(mesh), rules:
        logits, aux = transformer.forward(cfg, local, toks, remat=False,
                                          capacity_mode=capacity_mode,
                                          compute_dtype=F32)
    return {"logits": gather_vocab(mesh, logits), "aux": float(aux),
            "joins": mesh.stats.count}


def roundtrip_job(arch, overrides, jparams, dims):
    """``gather_params(place_params(p))`` against ``p``, bit for bit, and
    this rank's blocks (numpy)."""
    cfg = config(arch, overrides)
    mesh = mesh_of(dims)
    whole = params_from_jax(jparams, "cpu")
    local = place_params(whole, mesh, cfg)
    back = gather_params(local, mesh, cfg)
    equal = all(torch.equal(a, b) for a, b in zip(leaves(whole),
                                                  leaves(back)))
    return {"equal": equal,
            "blocks": {p: t.numpy() for p, t in leaves_with_path(local)}}


def decode_job(arch, overrides, jparams, tokens, context, step_tokens,
               kv_dtype, dims):
    """Prefill and a decode step for each row of ``step_tokens`` (B,)
    under the layout: each step's whole logits, the ring bytes a rank
    holds, the one-rank cache's bytes, and the largest distance of the
    prefill's ring block from ``place_cache`` of the one-rank prefill's
    cache (int8: codes and scales)."""
    cfg = config(arch, overrides)
    mesh = mesh_of(dims)
    whole = params_from_jax(jparams, "cpu")
    local = place_params(whole, mesh, cfg)
    toks = torch.from_numpy(tokens)
    kvd = {"int8": torch.int8, "f32": F32}[kv_dtype]
    out = []
    with torch.no_grad():
        with tp.tensor_parallel(mesh):
            logits, cache = decode.prefill(cfg, local, toks, context,
                                           compute_dtype=F32, kv_dtype=kvd)
        out.append(gather_vocab(mesh, logits))
        ring = sum(t.numel() * t.element_size() for t in leaves(cache))
        ring_block = [t.clone() for t in leaves(cache)]
        pos = toks.shape[1]
        for tok in torch.from_numpy(step_tokens):
            with tp.tensor_parallel(mesh):
                logits, cache = decode.decode_step(cfg, local, tok, pos,
                                                   cache, compute_dtype=F32)
            out.append(gather_vocab(mesh, logits))
            pos += 1
    with torch.no_grad():
        _, one = decode.prefill(cfg, whole, toks, context, compute_dtype=F32,
                                kv_dtype=kvd)
    want = leaves(place_cache(one, mesh))
    return {"logits": out, "ring_bytes": ring,
            "one_rank_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves(one)),
            "ring_diff": max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(ring_block, want))}


def sample_job(logits, k, dims):
    """Greedy, top-k (one-shot and per-slot) on the rank's vocab block
    under a ``local_vocab`` policy against the one-rank port on the
    whole logits: tokens and the top-k brackets."""
    mesh = mesh_of(dims)
    z = torch.from_numpy(logits)
    ways, r = mesh.shape["model"], mesh.axis_index("model")
    w = z.shape[1] // ways
    block = z[:, r * w:(r + 1) * w]
    pol = MeshPolicy(mesh, vocab_axis="model", data_axes=(),
                     local_vocab=True)
    sc = sampler.SamplerConfig(top_k=k, backend="hopper")
    slots = sampler.SlotSamplers.stack([sc] * z.shape[0], "cpu")
    noise = sampler.gumbel_noise(z.shape, torch.Generator().manual_seed(7))

    def draws(x, n):
        return {
            "bracket": torch.stack(applications.topk_threshold(
                x, k, backend="hopper")).numpy(),
            "greedy": sampler.sample(x, None, sampler.SamplerConfig(
                greedy=True)).numpy(),
            "topk": sampler.sample(x, torch.Generator().manual_seed(3),
                                   sc).numpy(),
            "slots": sampler.sample_slots(x, [None] * z.shape[0], slots,
                                          backend="hopper",
                                          top_k_static=k, noise=n).numpy(),
        }

    one = draws(z, noise)
    mesh.stats.reset()
    with mesh_policy(pol):
        got = draws(block, noise)
    return {"one": one, "got": got, "joins": mesh.stats.count}


def train_job(arch, overrides, jparams, tc_kw, lr, batches, dims):
    """Two train steps under the layout with ``seq_sp`` (ZeRO-1 where the
    mesh has several data ranks): metrics, the whole params after the
    steps, the keep masks of every capacity cut, and the padded heads'
    largest |param| and |mu| (0 where their gradient is exactly 0)."""
    cfg = config(arch, overrides)
    mesh = mesh_of(dims)
    lay = tp.TPLayout.of(mesh, cfg)
    local = place_params(params_from_jax(jparams, "cpu"), mesh, cfg)
    zero1 = mesh.shape["data"] > 1
    fn = step.make_train_step(cfg, step.TrainConfig(**tc_kw),
                              train_ranks.lr_fn(*lr), mesh=mesh)
    opt = adamw.adamw_init(local, mesh=mesh if zero1 else None)
    metrics, keeps = [], []
    with train_ranks.f32_forward(), tp.tensor_parallel(mesh):
        for b in batches:
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            with train_ranks.recording_keep() as kept:
                local, opt, m = fn(local, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            keeps.append([k.numpy() for k in kept])
    whole = gather_params(local, mesh, cfg)
    return {"metrics": metrics, "params": _np_tree(whole), "keeps": keeps,
            "pad": _padding_max(local, lay, opt, zero1)}


def _padding_max(local, lay, opt, zero1: bool) -> float:
    """The largest |value| of the padded heads' ``wq`` columns and ``wo``
    rows in the params and (whole-state runs) the first moment."""
    hd, worst = lay.cfg.head_dim, 0.0
    pads = [j for j in range(lay.hl)
            if lay.rank * lay.hl + j >= lay.cfg.n_heads]
    if not pads:
        return 0.0
    trees = [local] + ([] if zero1 else [opt.mu])
    for tree in trees:
        for path, t in leaves_with_path(tree):
            name = path.split("/")[-1]
            if name not in ("wq", "wo", "bq"):
                continue
            dim = t.ndim - (2 if name == "wo" else 1)
            h = t.unflatten(dim, (lay.hl, hd))
            for j in pads:
                worst = max(worst, float(h.select(dim, j).abs().max()))
    return worst


def ckpt_job(arch, overrides, jparams, tc_kw, lr, batch, ckpt_dir):
    """A step on 1x4, the state gathered whole and written; restored on
    2x2 and 4x1 through ``tp_sharding_fn``: each rank's blocks against
    the placement of the whole tree, and a step on 2x2 from it."""
    cfg = config(arch, overrides)
    mesh = mesh_of((1, 4))
    whole0 = params_from_jax(jparams, "cpu")
    local = place_params(whole0, mesh, cfg)
    fn = step.make_train_step(cfg, step.TrainConfig(**tc_kw),
                              train_ranks.lr_fn(*lr), mesh=mesh)
    opt = adamw.adamw_init(local)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with train_ranks.f32_forward(), tp.tensor_parallel(mesh):
        local, opt, _ = fn(local, opt, b)
    tree = {"params": gather_params(local, mesh, cfg),
            "opt": adamw.gather_state(opt, local, mesh, cfg)}
    path = f"{ckpt_dir}/step_1"
    if mesh.rank == 0:
        save_pytree(ckpt_dir, 1, tree)
    mesh.barrier()
    out = {"path": path, "params": _np_tree(tree["params"])}
    for dims in ((2, 2), (4, 1)):
        m2 = mesh_of(dims)
        got = restore_pytree(path, tree, tp_sharding_fn(m2, cfg, "cpu"))
        if dims[1] > 1:
            want_p = place_params(tree["params"], m2, cfg)
        else:
            want_p = tree["params"]
        want_m = unflatten(want_p, [
            zero1_block(t, p, m2) for p, t in leaves_with_path(
                place_params(tree["opt"].master, m2, cfg)
                if dims[1] > 1 else tree["opt"].master)])
        ok = all(torch.equal(a, b) for a, b in zip(
            leaves(got["params"]), leaves(want_p)))
        ok &= all(torch.equal(a, b) for a, b in zip(
            leaves(got["opt"].master), leaves(want_m)))
        loss = None
        if dims == (2, 2):
            fn2 = step.make_train_step(cfg, step.TrainConfig(**tc_kw),
                                       train_ranks.lr_fn(*lr), mesh=m2)
            with train_ranks.f32_forward(), tp.tensor_parallel(m2):
                _, _, m = fn2(got["params"], got["opt"], b)
            loss = float(m["loss"])
        out[dims] = {"equal": ok, "loss": loss}
    return out


JOBS = {"forward": forward_job, "roundtrip": roundtrip_job,
        "decode": decode_job, "sample": sample_job, "train": train_job,
        "ckpt": ckpt_job}


def tp_jobs(jobs: list) -> list:
    """Every job (name, args) in order; their results."""
    return [JOBS[name](*args) for name, args in jobs]


def cuda_tp_checks(arch: str, capacity_mode: str) -> dict:
    """On ranks sharing cuda:0, a 1x2 mesh: two f32 steps of the reduced
    ``arch`` (f32 params from seed 0, the quantile clip: K2; bisect: K3)
    under the tensor-parallel layout with ``seq_sp`` and on this rank
    alone, from the same weights on the same batches: {"tp", "single"},
    each ``run_steps``-like record of metrics, keep masks and the whole
    params (numpy; the layout's gathered)."""
    mesh = mesh_of((1, 2))
    cfg = testing.reduced_config(arch)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, size=(4, 33)).astype(np.int64)
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    kw = dict(clip_mode="quantile", capacity_mode=capacity_mode,
              param_dtype="float32")
    out = {}
    for name in ("tp", "single"):
        params = transformer.init_params(
            cfg, torch.Generator(device=mesh.device).manual_seed(0), F32)
        if name == "single":
            got = train_ranks.run_steps(cfg, params, kw, (1e-3, 1, 10),
                                        batches)
            got["params"] = _np_tree(got["params"])
        else:
            local = place_params(params, mesh, cfg)
            fn = step.make_train_step(cfg, step.TrainConfig(**kw),
                                      train_ranks.lr_fn(1e-3, 1, 10),
                                      mesh=mesh)
            opt = adamw.adamw_init(local)
            got = {"metrics": [], "keeps": []}
            with train_ranks.f32_forward(), tp.tensor_parallel(mesh):
                for b in batches:
                    batch = {k: torch.from_numpy(v).to(mesh.device)
                             for k, v in b.items()}
                    with train_ranks.recording_keep() as kept:
                        local, opt, m = fn(local, opt, batch)
                    got["metrics"].append({k: float(v) for k, v in m.items()})
                    got["keeps"].append([k.cpu().numpy() for k in kept])
            got["params"] = [t.cpu().numpy() for t in leaves(
                gather_params(local, mesh, cfg))]
        got.pop("opt", None)
        out[name] = {k: got[k] for k in ("metrics", "keeps", "params")}
    return out
