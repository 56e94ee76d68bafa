"""Dry run of every (architecture x input-shape) cell on the production
meshes, on the CPU with no GPU (the port's counterpart of
``repro.launch.dryrun``).

JAX's dry run compiles each cell for 256 or 512 forced host devices and
reads the compiled artifact.  The port runs SPMD, one program a rank, so
it traces the program ONE rank runs: the cell's step on meta tensors
(``launch/specs.py``) under a ``launch/cost.py::RecordingMesh`` of the
production shape (``launch/mesh.py::make_production_mesh``'s 16x16, or
2x16x16 with pods), counting it with ``launch/cost.py``.  No process
group is made and nothing is allocated; the trace runs the kernels'
plain versions (it never imports the card's kernels), so K7's cells are
counted as its plain chunked version computes them.

The rank programs are the port's own.  The seven decoder-only
transformer architectures (the dense and MoE families) trace the
tensor-parallel layout (``distributed/tp.py``): weights, heads (padded
to a multiple of the ``model`` ranks), vocab and experts split over
``model`` (``launch/shardings.py::place_params``), as JAX's GSPMD layout
splits them.  hymba, xlstm and whisper keep replicated weights, the
``model`` axis holding replicas, and their records say so:

  * train cells: ``train/step.py``'s step over the data axes (``pod`` x
    ``data``) with ZeRO-1 optimizer state (``adamw_init(params,
    mesh=)``, inside the tensor-parallel blocks), remat on,
    ``moe_groups`` the data ranks as JAX's, a rank's expert buffer at
    its bound, the whole batch's capacity (``models/moe.py::
    capacity_at_bound``: no count can be read on meta tensors), and
    under the layout the residual stream sequence-parallel
    (``TRAIN_RULES``' ``seq_sp``) and the loss vocab-parallel;
    ``--zero-grads`` adds the ZeRO-1 gradient constraint
    (reduce-scatter);
  * prefill cells: one admission's prefill over the rank's slots (the
    global batch over the data axes where it divides, else every row);
    under the layout (``SERVE_RULES``) the stream replicated, the
    ring's slots split over ``model``; ``--sampler`` adds the first
    token's runahead top-k sample, on the rank's vocab block under the
    layout (``MeshPolicy(local_vocab=True)``), else vocab-sharded over
    ``model`` (the tuner's fixed decision, ``tuning.disabled()``,
    whatever its analytic tier would pick for the CPU the trace runs
    on);
  * decode cells: one decode step of the rank's slots over their cache
    (``--kv-int8``: int8 codes and f16 scales), under the layout on the
    sequence-split ring; ``--sampler`` adds the slot sampler's top-k
    solve (the serving scheduler's ``MeshPolicy(local_rows=True)``, on
    the local vocab block under the layout).

Each record: ``memory`` (argument bytes per device: params, optimizer
state, cache and batch; the traced peak of live bytes), ``fits`` (the
peak against the card's memory: the device's when one is present, else
an H100 80GB HBM3's 80 GB), ``cost`` (flops, bytes at op granularity),
``collective_bytes`` and ``collectives`` (a histogram), as JAX's records.

Usage (PYTHONPATH=src):
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod off --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    get_config,
    input_shapes,
    skipped_shapes,
)
from repro_torch.launch import cost as cost_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import data_axes
from repro_torch.models.moe import capacity_at_bound

DEVICE_BYTES = 80e9          # an H100 80GB HBM3, where no card is present
TP_TEXT = ("tensor-parallel over model ({model}): weights, heads ({heads}), "
           "vocab and experts split")
TRAIN_LAYOUT = ("data-parallel over {data}; " + TP_TEXT + ", the residual "
                "stream sequence-parallel (seq_sp); ZeRO-1 optimizer state "
                "over data inside the model blocks")
SERVE_LAYOUT = ("slots over {data}{slots}; " + TP_TEXT + ", the ring's "
                "slots split over model, K/V heads replicated; the sampler "
                "on the rank's vocab block")
REPLICATED = (" (the port splits weights over model for the dense and MoE "
              "families only)")
TRAIN_LAYOUT_REPL = ("data-parallel over {data}; ZeRO-1 optimizer state "
                     "over data; the model axis ({model}) holds replicas"
                     + REPLICATED)
SERVE_LAYOUT_REPL = ("slots over {data}{slots}; the sampler's solves "
                     "vocab-sharded over model ({model}); weights "
                     "replicated" + REPLICATED)


def tp_covers(cfg, mesh) -> bool:
    """Whether the cell traces the tensor-parallel layout: a ``model``
    axis of several ranks and a dense or MoE architecture."""
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.models.transformer import layer_plan

    return (mesh.shape.get("model", 1) > 1 and cfg.act == "swiglu"
            and {k for k, _ in layer_plan(cfg)} <= set(tp_lib.TP_KINDS))


def _heads_text(cfg, mesh) -> str:
    from repro_torch.distributed.tp import head_plan

    hp, kv_rows, _ = head_plan(cfg.n_heads, cfg.n_kv_heads,
                               mesh.shape["model"])
    pad = f", padded to {hp}" if hp > cfg.n_heads else ""
    return (f"{cfg.n_heads} query{pad}, {len(kv_rows[0])} K/V a rank")


def production_mesh(multi_pod: bool) -> cost_lib.RecordingMesh:
    """The recording stand-in of ``make_production_mesh``'s mesh."""
    if multi_pod:
        return cost_lib.RecordingMesh((2, 16, 16), ("pod", "data", "model"))
    return cost_lib.RecordingMesh((16, 16), ("data", "model"))


def device_bytes() -> float:
    """The card's memory where torch sees one, else ``DEVICE_BYTES``."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return DEVICE_BYTES


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(cost_lib.nbytes(t) for t in leaves(tree))


def build_cell(arch: str, shape_name: str, mesh, *, kv_int8: bool = False,
               with_sampler: bool = False, zero_grads: bool = False,
               cfg=None, shape=None, train_config=None):
    """(fn, its argument groups {name: tree}, layout) for one cell on
    ``mesh`` (a ``RecordingMesh``).  ``cfg`` replaces the registry's
    config (a reduced or depth-cut one), ``shape`` (a ``ShapeSpec``) the
    named shape, ``train_config`` the dry run's ``TrainConfig`` (a
    launcher's, to predict its run)."""
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.launch.shardings import place_params

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    axes = data_axes(mesh)
    d = mesh.axis_size(axes)
    params = specs_lib.params_specs(cfg)
    ins = specs_lib.input_specs(arch, shape, cfg=cfg)
    tp = tp_covers(cfg, mesh)
    tp_mesh = mesh if tp else None
    if tp:
        params = place_params(params, mesh, cfg)
    fmt = dict(model=mesh.shape.get("model", 1),
               heads=_heads_text(cfg, mesh) if tp else "")

    if shape.kind == "train":
        from repro_torch.launch.shardings import zero1_grad_constraint
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.optim.schedule import linear_warmup_cosine
        from repro_torch.train.step import TrainConfig, make_train_step

        tc = train_config or TrainConfig(n_microbatches=1, remat=True,
                                         moe_groups=d)
        step = make_train_step(
            cfg, tc, linear_warmup_cosine(3e-4, 100, 1000), mesh=mesh,
            grad_constraint=zero1_grad_constraint(mesh) if zero_grads
            else None)
        opt = adamw_init(params, mesh=mesh)
        batch = ins["batch"]
        layout = (TRAIN_LAYOUT if tp else TRAIN_LAYOUT_REPL).format(
            data=" x ".join(axes) + f" = {d}", **fmt)

        def train():
            with tp_lib.tensor_parallel(tp_mesh):
                return step(params, opt, batch)

        return train, {"params": params, "opt_state": opt, "batch": batch}, \
            layout

    from repro_torch.core import tuning
    from repro_torch.core.solver import MeshPolicy, mesh_policy
    from repro_torch.models import decode as decode_lib
    from repro_torch.serving.sampler import (
        SamplerConfig,
        SlotSamplers,
        sample_slots,
    )

    B = shape.global_batch
    local = B // d if B % d == 0 else B
    sharded = local < B
    policy = MeshPolicy(mesh, vocab_axis="model",
                        data_axes=axes if sharded else (),
                        local_rows=sharded, local_vocab=tp)
    sc = SamplerConfig(top_k=50, spec_k=5, rounds=6)
    layout = (SERVE_LAYOUT if tp else SERVE_LAYOUT_REPL).format(
        data=" x ".join(axes) + f" = {d}",
        slots=(f", {local} a rank" if sharded
               else f" (replicated: {B} does not split {d} ways)"), **fmt)

    def sample(logits):
        knobs = SlotSamplers.stack([sc] * logits.shape[0], logits.device)
        # the fixed decision: vocab-sharded over model, whatever the
        # analytic tier would pick for the CPU the trace runs on
        with tuning.disabled(), mesh_policy(policy):
            return sample_slots(logits, [None] * logits.shape[0], knobs,
                                spec_k=sc.spec_k, rounds=sc.rounds,
                                backend="torch", enable=(False, True, False),
                                top_k_static=sc.top_k, greedy_only=False,
                                noise=torch.zeros_like(logits))

    if shape.kind == "prefill":
        tokens = specs_lib.spec((local, shape.seq_len), torch.int32)
        frames = (specs_lib.spec((local,) + tuple(ins["frames"].shape[1:]),
                                 torch.bfloat16)
                  if "frames" in ins else None)

        def prefill():
            with torch.no_grad(), tp_lib.tensor_parallel(tp_mesh):
                logits, cache = decode_lib.prefill(
                    cfg, params, tokens, shape.seq_len,
                    encoder_frames=frames, moe_groups=1)
                return (sample(logits) if with_sampler else logits), cache

        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        return prefill, {"params": params, "batch": batch}, layout

    with tp_lib.tensor_parallel(tp_mesh):
        cache = specs_lib.cache_specs(cfg, local, shape.seq_len, torch.int8
                                      if kv_int8 else torch.bfloat16)
    token = specs_lib.spec((local,), torch.int32)
    pos = shape.seq_len - 1

    def decode():
        with torch.no_grad(), tp_lib.tensor_parallel(tp_mesh):
            logits, _ = decode_lib.decode_step(cfg, params, token, pos, cache)
            return sample(logits) if with_sampler else logits

    return decode, {"params": params, "cache": cache,
                    "batch": {"token": token}}, layout


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             kv_int8: bool = False, with_sampler: bool = False,
             zero_grads: bool = False, cfg=None, mesh=None, shape=None,
             train_config=None) -> dict:
    """One cell's record (``mesh`` replaces the production mesh; ``cfg``,
    ``shape`` and ``train_config`` as ``build_cell`` takes them)."""
    mesh = mesh or production_mesh(multi_pod)
    t0 = time.time()
    fn, args, layout = build_cell(arch, shape_name, mesh, kv_int8=kv_int8,
                                  with_sampler=with_sampler,
                                  zero_grads=zero_grads, cfg=cfg,
                                  shape=shape, train_config=train_config)
    with capacity_at_bound():     # no count can be read on meta tensors
        _, mode = cost_lib.count(fn, arguments=list(args.values()))
    coll_bytes, histo, detail = mesh.collectives()
    memory = {f"{k}_bytes": _tree_bytes(v) for k, v in args.items()}
    memory["argument_bytes"] = mode.argument_bytes
    memory["peak_bytes"] = mode.peak
    limit = device_bytes()
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "n_devices": int(mesh.size),
        "ok": True,
        "layout": layout,
        "trace_s": round(time.time() - t0, 1),
        "memory": memory,
        "device_bytes": limit,
        "fits": mode.peak <= limit,
        "cost": {"flops": mode.flops, "bytes_accessed": mode.bytes,
                 "bytes_convention": "op granularity (not XLA's fusion "
                                     "boundary)"},
        "collective_bytes": coll_bytes,
        "collectives": histo,
        "collective_detail": detail,
    }
    print(f"[dryrun] {arch:22s} {shape_name:12s} mesh={result['mesh']:8s} "
          f"flops={mode.flops:.3e} bytes={mode.bytes:.3e} "
          f"coll={coll_bytes:.3e} args={mode.argument_bytes / 2**30:.2f}GiB "
          f"peak={mode.peak / 2**30:.2f}GiB fits={result['fits']} "
          f"trace={result['trace_s']:.0f}s", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--sampler", action="store_true")
    ap.add_argument("--zero-grads", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in input_shapes(arch):
                cells.append((arch, shape_name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]
    results = []
    failures = 0
    for arch, shape_name in cells:
        for mp in pods:
            try:
                results.append(run_cell(arch, shape_name, mp,
                                        kv_int8=args.kv_int8,
                                        with_sampler=args.sampler,
                                        zero_grads=args.zero_grads))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                traceback.print_exc()
                results.append({
                    "arch": arch, "shape": shape_name,
                    "mesh": "2x16x16" if mp else "16x16",
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                })
                print(f"[dryrun] FAIL {arch} {shape_name} mp={mp}: {e}",
                      flush=True)
    skips = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_name, reason in skipped_shapes(arch).items():
                skips.append({"arch": arch, "shape": shape_name,
                              "skipped": reason})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "skips": skips}, f, indent=1)
        print(f"[dryrun] wrote {args.out}", flush=True)
    print(f"[dryrun] {len(results)} cells, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
