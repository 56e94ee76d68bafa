"""The port's dry run and its helpers (``launch/specs.py``,
``launch/cost.py``, ``launch/dryrun.py``, ``launch/env.py``,
``launch/run.sh``) and JAX's two A/B switches, against the JAX package
on the CPU.  No ranks are spawned: the dry run traces one rank's program
on meta tensors under a recording stand-in of the mesh.

Contracts and tolerances:
  * ``specs.*`` equal JAX's ``specs.*`` leaf by leaf (path, shape,
    dtype) for every arch: params, the AdamW state, and the inputs of
    ``train_4k`` and ``decode_32k`` (the decode cache);
  * the dry run's argument bytes per device equal arithmetic on JAX's
    ``param_spec`` / ``zero1_spec`` / ``cache_spec`` over duck-typed
    16x16 and 2x16x16 meshes, leaf by leaf, for the leaves the port
    places as JAX does (those whose JAX spec names no ``model`` axis:
    the port pads heads where JAX's spec cuts through one);
  * the tensor-parallel cells (reduced qwen1.5 dense and qwen2-moe, and
    a padded config, on a 1x4 recording mesh): a rank's params are the
    whole tree's bytes over 4, padded heads and repeated K/V heads
    included; the ``model``-axis joins a layer adds equal a hand count;
    a rank's FLOPs are the one-rank trace's over 4 (dense, heads
    aligned: equal; MoE: within the replicated router's 3%; padded:
    above it);
  * ``cost.py``'s FLOPs of reduced internlm2 and qwen3 prefill, decode
    and train on one device equal ``hlo_cost.analyse_hlo`` of JAX's
    jitted counterparts within 1%.  Train is held to 1% too: remat on
    both sides recomputes each layer's forward once in the backward, the
    dots of forward, recompute and backward match term by term, and the
    optimizer and clip do no dots (measured: equal);
  * the collective payload of a reduced data-parallel train cell on a
    4x1 recording mesh equals the analytic gradient bytes: one
    all-reduce of every gradient, or with ``--zero-grads`` an all-reduce
    of the leaves ZeRO-1 keeps whole and a reduce-scatter of the others'
    blocks; then the all-gather of the updated params' sharded leaves;
    plus the step's small joins (4 metrics, the per-leaf sums of
    squares);
  * ``dryrun.main`` on a reduced registry entry writes its JSON record;
  * ``env.configure`` keeps exported values (``setdefault``), and
    ``run.sh`` resolves its entry points;
  * ``REPRO_DISABLE_FLASH`` and ``REPRO_SLSTM_NAIVE`` act as in JAX:
    with the switch on in both, the port's ``attend`` at S = 4096 and
    ``slstm_apply`` equal JAX's in f32 within 1e-5 (atol 1e-6).
"""
import dataclasses
import functools
import json
import math
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.launch import shardings as jshardings
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import analyse_hlo
from repro.models import attention as jattention
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import cost, dryrun, env, specs
from repro_torch.launch.shardings import zero1_dim
from repro_torch.models import attention, decode, testing, xlstm
from repro_torch.optim import schedule
from repro_torch.train import step
from repro_torch.tree import leaves, leaves_with_path
import torch_one_thread  # noqa: F401 (one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class DuckMesh:
    """What the spec functions read of a mesh: JAX's needs no devices."""
    axis_names: tuple
    shape: dict


MESHES = {"16x16": DuckMesh(("data", "model"), {"data": 16, "model": 16}),
          "2x16x16": DuckMesh(("pod", "data", "model"),
                              {"pod": 2, "data": 16, "model": 16})}


def _jax_leaves(tree) -> list:
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out.append((keys, tuple(leaf.shape), jnp.dtype(leaf.dtype).name))
    return out


def _port_leaves(tree) -> list:
    return [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert _port_leaves(specs.params_specs(cfg)) == \
        _jax_leaves(jspecs.params_specs(jcfg))
    assert _port_leaves(specs.opt_state_specs(cfg)) == \
        _jax_leaves(jspecs.opt_state_specs(jcfg))
    for shape in ("train_4k", "decode_32k"):
        got = specs.input_specs(arch, SHAPES[shape])
        assert _port_leaves(got) == _jax_leaves(
            jspecs.input_specs(arch, JSHAPES[shape]))
        assert all(t.device.type == "meta" for t in leaves(got))


# ---------------------------------------------------------------------------
# argument bytes per device against JAX's specs
# ---------------------------------------------------------------------------

def _uses_model(spec) -> bool:
    return any(s == "model" or (isinstance(s, tuple) and "model" in s)
               for s in spec)


def _jax_bytes(tree, spec_fn, mesh) -> dict:
    """{path: bytes a device holds under JAX's spec} for the leaves whose
    spec names no ``model`` axis."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(spec_fn(path, leaf))
        if _uses_model(spec):
            continue
        ways = 1
        for s in spec:
            for a in (s if isinstance(s, tuple) else (s,)):
                ways *= mesh.shape[a] if a else 1
        keys = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out[keys] = math.prod(leaf.shape) * jnp.dtype(
            leaf.dtype).itemsize // ways
    return out


def _port_bytes(tree) -> dict:
    return {path: cost.nbytes(t) for path, t in leaves_with_path(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"),
                                        ("xlstm-1.3b", "decode_32k"),
                                        ("whisper-tiny", "decode_32k")])
def test_argument_bytes_match_jax_specs(arch, shape, mesh_name):
    duck = MESHES[mesh_name]
    mesh = cost.RecordingMesh(duck.shape)
    _, args, layout = dryrun.build_cell(arch, shape, mesh)
    jcfg = jget_config(arch)
    params = jspecs.params_specs(jcfg)
    checks = [(args["params"], _jax_bytes(
        params, lambda p, l: jshardings.param_spec(p, l, duck), duck))]
    # the seven dense and MoE architectures trace the tensor-parallel
    # layout; the recurrent and enc-dec ones keep replicated weights
    tp_arch = dryrun.tp_covers(get_config(arch), mesh)
    assert tp_arch == (arch == "qwen3-4b")
    assert ("tensor-parallel" in layout) == tp_arch
    assert ("replicas" in layout or "weights replicated" in layout) \
        == (not tp_arch)
    if shape == "train_4k":
        opt = jspecs.opt_state_specs(jcfg)
        checks.append((args["opt_state"], _jax_bytes(
            opt, lambda p, l: (() if str(getattr(p[0], "name", "")) == "step"
                               else jshardings.zero1_spec(p[1:], l, duck)),
            duck)))
    else:
        cache = jspecs.input_specs(arch, JSHAPES[shape])["cache"]
        checks.append((args["cache"], _jax_bytes(
            cache, lambda p, l: jshardings.cache_spec(p, l, duck), duck)))
    compared = 0
    for tree, want in checks:
        got = _port_bytes(tree)
        for path, b in want.items():
            assert got[path] == b, (path, got[path], b)
            compared += 1
    assert compared >= 3
    if shape != "train_4k":
        return
    # ZeRO-1 cuts the state 16 ways where JAX's spec does
    opt_got = _port_bytes(args["opt_state"])
    cut = [p for p, t in leaves_with_path(args["params"])
           if zero1_dim(p, t, mesh) is not None]
    assert cut and all(opt_got[f"master/{p}"] * 16 == 2 * cost.nbytes(t)
                       for p, t in leaves_with_path(args["params"])
                       if p in cut)


# ---------------------------------------------------------------------------
# FLOPs against hlo_cost on JAX's compiled counterparts
# ---------------------------------------------------------------------------

B, S = 2, 64


@functools.cache
def _jax_flops(arch: str, kind: str) -> float:
    cfg = jtesting.reduced_config(arch)
    p = jtransformer.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tokens = jnp.zeros((B, S), jnp.int32)
    if kind == "prefill":
        fn = jax.jit(lambda p, t: jdecode.prefill(cfg, p, t, S))
        args = (p, tokens)
    elif kind == "decode":
        fn = jax.jit(lambda p, t, pos, c: jdecode.decode_step(cfg, p, t, pos,
                                                              c))
        args = (p, tokens[:, 0], jnp.int32(3), jdecode.init_cache(cfg, B, S))
    else:
        fn = jax.jit(jstep.make_train_step(
            cfg, jstep.TrainConfig(),
            jschedule.linear_warmup_cosine(3e-4, 100, 1000)))
        args = (p, jadamw.adamw_init(p), {"tokens": tokens,
                                          "targets": tokens})
    return analyse_hlo(fn.lower(*args).compile().as_text())["flops"]


def _port_flops(arch: str, kind: str) -> float:
    cfg = testing.reduced_config(arch)
    p = specs.params_specs(cfg)
    tokens = specs.spec((B, S), torch.int32)
    if kind == "prefill":
        with torch.no_grad():
            _, mode = cost.count(decode.prefill, cfg, p, tokens, S)
    elif kind == "decode":
        cache = specs.cache_specs(cfg, B, S)
        with torch.no_grad():
            _, mode = cost.count(decode.decode_step, cfg, p, tokens[:, 0], 3,
                                 cache)
    else:
        fn = step.make_train_step(
            cfg, step.TrainConfig(),
            schedule.linear_warmup_cosine(3e-4, 100, 1000))
        _, mode = cost.count(fn, p, specs.opt_state_specs(cfg),
                             {"tokens": tokens, "targets": tokens})
    return mode.flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-4b"])
def test_flops_match_hlo_cost(arch, kind):
    want = _jax_flops(arch, kind)
    got = _port_flops(arch, kind)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-2)


# ---------------------------------------------------------------------------
# collectives of a data-parallel train cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_grads", [False, True],
                         ids=["all-reduce", "reduce-scatter"])
def test_train_cell_collectives_match_gradient_bytes(zero_grads):
    cfg = testing.reduced_config("internlm2-1.8b")
    mesh = cost.RecordingMesh((4, 1), ("data", "model"))
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", False, cfg=cfg,
                          mesh=mesh, zero_grads=zero_grads)
    params = specs.params_specs(cfg)
    grads = [(cost.nbytes(t), zero1_dim(p, t, mesh))
             for p, t in leaves_with_path(params)]
    whole = sum(b for b, d in grads if d is None)
    cut = sum(b for b, d in grads if d is not None)
    small = 4 * 4 + 4 * len(grads)     # the metrics, the sums of squares
    detail = rec["collective_detail"]
    assert detail["all-gather"]["bytes"] == cut
    if zero_grads:
        assert detail["all-reduce"]["bytes"] == whole + small
        assert detail["reduce-scatter"]["bytes"] == cut // 4
    else:
        assert detail["all-reduce"]["bytes"] == whole + cut + small
        assert "reduce-scatter" not in detail
    assert rec["collective_bytes"] == sum(d["bytes"]
                                          for d in detail.values())
    assert rec["memory"]["opt_state_bytes"] < 3 * 4 * sum(
        math.prod(t.shape) for t in leaves(params))
    assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_bytes"] > 0


def test_main_writes_a_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", testing.reduced_config)
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--sampler", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["skips"] == []
    (rec,) = doc["results"]
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["fits"] is True and "8 a rank" in rec["layout"]
    assert rec["memory"]["argument_bytes"] == sum(
        rec["memory"][k] for k in ("params_bytes", "cache_bytes",
                                   "batch_bytes"))
    # the vocab-sharded sample joins over the model axis
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["cost"]["flops"] > 0


# ---------------------------------------------------------------------------
# env.py and run.sh
# ---------------------------------------------------------------------------

def test_env_configure_keeps_exported_values(monkeypatch):
    monkeypatch.setenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "123")
    monkeypatch.delenv("TORCH_CPP_LOG_LEVEL", raising=False)
    monkeypatch.setenv(env.DTYPE_ENV, "float64")
    try:
        got = env.configure()
        assert got["tcmalloc_threshold"] == "123"
        assert got["torch_cpp_log_level"] == "ERROR"
        assert torch.get_default_dtype() == torch.float64
        monkeypatch.setenv(env.DTYPE_ENV, "int8")
        with pytest.raises(ValueError, match="not a torch float dtype"):
            env.configure()
    finally:
        torch.set_default_dtype(torch.float32)
    monkeypatch.delenv(env.DTYPE_ENV)
    assert env.configure()["default_dtype"] == "torch.float32"
    info = env.describe()
    assert info["torch_version"] == torch.__version__
    assert info["kernel_build_dir"].endswith(os.path.join("build",
                                                          "repro_torch"))


def test_run_sh_resolves_entries():
    script = os.path.join(REPO, "src", "repro_torch", "launch", "run.sh")
    subprocess.run(["bash", "-n", script], check=True)

    def dry(*argv, **extra):
        e = {k: v for k, v in os.environ.items() if k != "REPRO_ENTRY"}
        e.update(REPRO_RUN_DRY="1", **extra)
        return subprocess.run(["bash", script, *argv], env=e, check=True,
                              capture_output=True, text=True).stdout.strip()

    assert dry("train", "--steps", "2") == \
        "python -m repro_torch.launch.train --steps 2"
    assert dry("serve", "--reduced") == \
        "python -m repro_torch.launch.serve --reduced"
    assert dry() == "python -m repro_torch.launch.serve"
    assert dry("--", "--x") == "python -m repro_torch.launch.serve --x"
    assert dry("--", "--y", REPRO_ENTRY="my.entry") == \
        "python -m my.entry --y"


# ---------------------------------------------------------------------------
# the A/B switches
# ---------------------------------------------------------------------------

def test_disable_flash_matches_jax(monkeypatch):
    """REPRO_DISABLE_FLASH=1 in both (``FLASH_ENABLED`` False): at S =
    4096 ``attend`` takes the full-materialisation path, which the port
    reaches without K7's wrapper."""
    monkeypatch.setattr(jattention, "FLASH_ENABLED", False)
    monkeypatch.setattr(attention, "FLASH_ENABLED", False)

    def no_flash(*a, **k):
        raise AssertionError("the flash branch ran with the switch on")

    monkeypatch.setattr(attention.ops, "flash_fwd", no_flash)
    jcfg = jtesting.reduced_config("qwen3-4b")
    cfg = testing.reduced_config("qwen3-4b")
    n = 4096
    jp = jattention.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, n, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(n, dtype=np.int32)[None]
    want = np.asarray(jattention.attend(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos)))
    got = attention.attend(params_from_jax(jax.device_get(jp), "cpu"), cfg,
                           torch.from_numpy(x), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert os.environ.get("REPRO_DISABLE_FLASH") != "1"
    assert attention.FLASH_MIN_SEQ <= n


def test_disable_flash_refused_on_the_card(monkeypatch):
    """The switch never moves K7's work to plain PyTorch: with it on,
    causal self-attention at ``FLASH_MIN_SEQ`` on CUDA operands raises;
    on the CPU and the meta device it takes the plain path, and below
    ``FLASH_MIN_SEQ`` (no flash branch) or with the switch off nothing
    raises."""
    n = attention.FLASH_MIN_SEQ
    cuda = torch.device("cuda")
    assert attention._flash_branch(n, cuda)
    assert not attention._flash_branch(n - 1, cuda)
    monkeypatch.setattr(attention, "FLASH_ENABLED", False)
    with pytest.raises(ValueError, match="REPRO_DISABLE_FLASH"):
        attention._flash_branch(n, cuda)
    assert not attention._flash_branch(n - 1, cuda)
    for dev in ("cpu", "meta"):
        assert not attention._flash_branch(n, torch.device(dev))


def test_slstm_naive_matches_jax(monkeypatch):
    monkeypatch.setenv("REPRO_SLSTM_NAIVE", "1")
    jcfg = jtesting.reduced_config("xlstm-1.3b")
    cfg = testing.reduced_config("xlstm-1.3b")
    jp = jxlstm.init_slstm(jax.random.PRNGKey(2), jcfg, jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    want, jstate = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(x),
                                      return_state=True)
    p = params_from_jax(jax.device_get(jp), "cpu")
    got, state = xlstm.slstm_apply(p, cfg, torch.from_numpy(x),
                                   return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    monkeypatch.delenv("REPRO_SLSTM_NAIVE")
    hoisted = xlstm.slstm_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(hoisted.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_moe_train_cell_traces():
    """A MoE train cell traces on meta tensors: a rank's expert buffer
    keeps its bound (the whole batch's capacity; no count can be read),
    and each routing call all-gathers the layer's assignments."""
    cfg = testing.reduced_config("granite-moe-3b-a800m")
    mesh = cost.RecordingMesh((4, 1), ("data", "model"))
    rec = dryrun.run_cell("granite-moe-3b-a800m", "train_4k", False,
                          cfg=cfg, mesh=mesh)
    params = specs.params_specs(cfg)
    cut = [1 for p, t in leaves_with_path(params)
           if zero1_dim(p, t, mesh) is not None]
    # forward and remat recompute a layer; then the params' gathers
    assert rec["collectives"]["all-gather"] >= 2 * cfg.n_layers
    assert rec["ok"] and rec["cost"]["flops"] > 0 and cut


# ---------------------------------------------------------------------------
# the tensor-parallel cells
# ---------------------------------------------------------------------------

TP_ARCHS = {"dense": ("qwen1.5-4b", {}), "moe": ("qwen2-moe-a2.7b", {}),
            "padded": ("internlm2-1.8b", {"n_heads": 6, "n_kv_heads": 2})}
# model-axis joins a layer adds: in training the stream's all-gather
# before attention and before the MLP (forward, remat recompute, and the
# backward of each reduce-scatter: 6) and its reduce-scatter after each
# (forward 2, the recompute 1: it stops once the layer's saved tensors
# are back, and the backward of each all-gather 2: 5); in a prefill the
# attention's and the MLP's all-reduce and the new K and V gathered over
# heads; in a decode step the gather of every head's query and K/V, the
# ring's MAX and SUM joins, the attention's and the MLP's all-reduce
JOINS_A_LAYER = {"train": {"all-gather": 6, "reduce-scatter": 5},
                 "prefill": {"all-reduce": 2, "all-gather": 2},
                 "decode": {"all-reduce": 4, "all-gather": 1}}


def _tp_cell(name, kind, n_layers, dims):
    arch, overrides = TP_ARCHS[name]
    cfg = dataclasses.replace(testing.reduced_config(arch),
                              n_layers=n_layers, **overrides)
    mesh = cost.RecordingMesh(dims, ("data", "model"))
    shape = dataclasses.replace(SHAPES[f"{kind}_4k" if kind == "train"
                                       else f"{kind}_32k"],
                                seq_len=64, global_batch=4)
    rec = dryrun.run_cell(arch, shape.name, False, cfg=cfg, mesh=mesh,
                          shape=shape)
    joins = {}
    for (op, _), axes in zip(mesh.calls, mesh.call_axes):
        if axes == ("model",):
            joins[op] = joins.get(op, 0) + 1
    return cfg, rec, joins


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", list(TP_ARCHS))
def test_tp_cell_params_are_whole_over_ranks(name, kind):
    from repro_torch.distributed.tp import TPLayout
    from repro_torch.launch.shardings import tp_leaf_rule

    cfg, rec, _ = _tp_cell(name, kind, 2, (1, 4))
    assert rec["ok"] and "tensor-parallel over model (4)" in rec["layout"]
    lay = TPLayout(cost.RecordingMesh((1, 4), ("data", "model")), cfg)
    want = 0
    for path, t in leaves_with_path(specs.params_specs(cfg)):
        rule, _ = tp_leaf_rule(path, t)
        n = cost.nbytes(t)
        if rule == "whole":
            want += n
        elif rule in ("q", "o"):          # heads padded to hp
            want += n * lay.hp // cfg.n_heads // 4
        elif rule == "kv":                # the K/V heads a rank reads
            want += n * lay.kv_l // cfg.n_kv_heads
        else:
            want += n // 4
    assert rec["memory"]["params_bytes"] == want
    if name == "padded":
        assert lay.hp == 8 and want > sum(
            cost.nbytes(t) for t in leaves(specs.params_specs(cfg))) // 4


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_tp_cell_joins_a_layer(name, kind):
    _, _, one = _tp_cell(name, kind, 1, (1, 4))
    _, _, two = _tp_cell(name, kind, 2, (1, 4))
    added = {op: two.get(op, 0) - one.get(op, 0) for op in two}
    assert {op: n for op, n in added.items() if n} == JOINS_A_LAYER[kind]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", list(TP_ARCHS))
def test_tp_cell_flops_are_one_rank_over_ranks(name, kind):
    _, rec, _ = _tp_cell(name, kind, 2, (1, 4))
    _, one, _ = _tp_cell(name, kind, 2, (1, 1))
    assert "tensor-parallel" not in one["layout"]
    ratio = 4 * rec["cost"]["flops"] / one["cost"]["flops"]
    if name == "dense":
        assert ratio == pytest.approx(1.0, rel=1e-9)
    elif name == "moe":                   # the router runs on every rank
        assert 1.0 < ratio < 1.03
    else:                                 # padded heads and K/V copies
        assert ratio > 1.0
