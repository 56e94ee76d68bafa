"""The port's tensor-parallel layout (``distributed/tp.py``,
``launch/shardings.py::place_params`` / ``gather_params`` /
``tp_sharding_fn``, the model code under ``tensor_parallel``, the
``local_vocab`` solves and sampler) on gloo ranks on the CPU, against
JAX's single-device functions and the single-rank port.

Every meshed run of the module shares one group of four ranks
(``tests/torch_tp_ranks.py``, no JAX), under ``1x4`` (data 1, model 4)
and ``2x2`` meshes; this process computes JAX's references while the
ranks work.  Reduced configs at 2 layers, f32 weights from JAX's
``init_params``, inputs from a numpy seed.

Contracts and tolerances:
  * ``gather_params(place_params(p))`` is ``p`` bit for bit; a rank's
    blocks equal ``local_block`` of JAX's ``param_spec`` on a duck 1x4
    mesh wherever that spec splits over ``model`` and heads align;
  * forward logits of internlm2 (GQA 4/2, K/V heads repeated at 1x4),
    qwen1.5 (MHA, QKV biases), qwen2-moe and granite (experts over
    ``model``, fifo and bisect) and a padded config (6 heads over 4
    ranks, hp 8) under 1x4 and 2x2, and under ``TRAIN_RULES``'
    sequence-parallel stream, against JAX's ``forward`` in f32: rtol
    1e-5, atol 1e-5;
  * prefill of 12 tokens and 8 decode steps on the sequence-split ring
    (f32, and int8 K/V) against JAX's ``prefill`` / ``decode_step`` at
    the same tolerance (int8: rtol 1e-3, atol 1e-3, since one f32 ulp
    can move a K/V value across a code, ``tests/test_torch_int8kv.py``);
    a rank's ring holds 1/4 of one rank's bytes and, after the prefill,
    ``place_cache`` of the one-rank prefill's ring within 1e-5 (int8:
    one code);
  * greedy and top-k tokens (one-shot and per slot) on the local vocab
    block equal the one-rank port's; the top-k bracket bit for bit;
  * two train steps with ``seq_sp``, the quantile or global clip, and
    ZeRO-1 on 2x2, against JAX's jitted step with both forwards in f32:
    loss, ce and aux rtol 1e-5, lr equal, the params' change per leaf
    l2 rel < 1e-3; MoE keep masks equal to the single-rank port's bit
    for bit; the padded heads' params and first moment exactly 0;
  * a checkpoint written whole from 1x4 restores on 2x2 and 4x1 to the
    placement of the whole tree, bit for bit, and trains on from there;
    and whole on one rank.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_ranks as tp_ranks
import torch_train_ranks as train_ranks
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch import shardings as jshardings
from repro.models import decode as jdecode
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.checkpoint.manager import restore_pytree
from repro_torch.convert import params_from_jax
from repro_torch.distributed import tp
from repro_torch.launch.mesh import spawn_local
from repro_torch.launch.shardings import local_block, place_leaf
from repro_torch.models import testing
from repro_torch.tree import leaves, leaves_with_path
import torch_one_thread  # noqa: F401 (one torch thread)

WORLD = 4
L2 = {"n_layers": 2}
CFGS = {
    "internlm2": ("internlm2-1.8b", L2),
    "qwen1.5": ("qwen1.5-4b", L2),
    "padded": ("internlm2-1.8b", {**L2, "n_heads": 6, "n_kv_heads": 2}),
    "qwen2-moe": ("qwen2-moe-a2.7b", L2),
    "granite": ("granite-moe-3b-a800m", {**L2, "capacity_factor": 0.5}),
}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# (config, capacity mode, mesh, seq_sp)
FORWARD = [(c, mode, m, False)
           for c, mode in (("internlm2", "fifo"), ("qwen1.5", "fifo"),
                           ("qwen2-moe", "fifo"), ("granite", "fifo"),
                           ("granite", "bisect"))
           for m in MESHES] + [("padded", "fifo", "1x4", False),
                               ("internlm2", "fifo", "2x2", True),
                               ("granite", "bisect", "1x4", True)]
DECODE = [("internlm2", "f32"), ("internlm2", "int8"), ("qwen1.5", "f32"),
          ("padded", "f32"), ("granite", "f32")]
PROMPT, CONTEXT, N_STEPS = 12, 32, 8
B, SEQ = 8, 16
LR = (1e-3, 0, 10)
TRAIN = {
    "internlm2-2x2-quantile": ("internlm2", "2x2",
                               dict(clip_mode="quantile")),
    "internlm2-1x4-global": ("internlm2", "1x4", dict(clip_mode="global")),
    "qwen1.5-1x4-quantile": ("qwen1.5", "1x4", dict(clip_mode="quantile")),
    "padded-1x4-quantile": ("padded", "1x4", dict(clip_mode="quantile")),
    "granite-bisect-2x2": ("granite", "2x2", dict(capacity_mode="bisect",
                                                  clip_mode="quantile")),
}
MOE_TRAIN = [c for c in TRAIN if c.startswith("granite")]


def _tc_kw(case) -> dict:
    return {**TRAIN[case][2], "param_dtype": "float32"}


@functools.cache
def _model(name):
    """(JAX config, JAX's f32 params as numpy)."""
    arch, overrides = CFGS[name]
    jcfg = dataclasses.replace(jtesting.reduced_config(arch), **overrides)
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    return jcfg, jax.device_get(jparams)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@functools.cache
def _batches(name):
    jcfg, _ = _model(name)
    data = JSyntheticTokens(vocab=jcfg.vocab, seq_len=SEQ, global_batch=B)
    return [dict(data.batch_at(i)) for i in range(2)]


def _forward_args(case):
    name, mode, mesh, seq_sp = case
    arch, overrides = CFGS[name]
    jcfg, jparams = _model(name)
    return (arch, overrides, jparams, _tokens(1, (2, SEQ), jcfg.vocab),
            MESHES[mesh], mode, seq_sp)


def _decode_args(case):
    name, kv = case
    arch, overrides = CFGS[name]
    jcfg, jparams = _model(name)
    return (arch, overrides, jparams, _tokens(2, (2, PROMPT), jcfg.vocab),
            CONTEXT, _tokens(3, (N_STEPS, 2), jcfg.vocab), kv, (1, 4))


def _sample_logits():
    rng = np.random.default_rng(4)
    z = (rng.normal(size=(4, 512)) * 3).astype(np.float32)
    z[1, 100] = z[1, 300] = z[1].max() + 1.0     # a tie across blocks
    return z


@functools.cache
def _jobs():
    jobs = [("roundtrip", (*CFGS[n], _model(n)[1], (1, 4)))
            for n in ("internlm2", "qwen1.5", "padded", "granite")]
    jobs += [("forward", _forward_args(c)) for c in FORWARD]
    jobs += [("decode", _decode_args(c)) for c in DECODE]
    jobs += [("sample", (_sample_logits(), 7, (1, 4)))]
    for case, (name, mesh, _) in TRAIN.items():
        arch, overrides = CFGS[name]
        jobs.append(("train", (arch, overrides, _model(name)[1],
                               _tc_kw(case), LR, _batches(name),
                               MESHES[mesh])))
    return jobs


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every job of the module on one group of four ranks: [per rank: the
    jobs' results in order, then the checkpoint job's].  JAX's
    references are computed here while the ranks run."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    name = "internlm2"
    jobs = list(_jobs()) + [("ckpt", (
        *CFGS[name], _model(name)[1], _tc_kw("internlm2-1x4-global"), LR,
        _batches(name)[0], ckpt))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = pool.submit(spawn_local, tp_ranks.tp_jobs, WORLD,
                          args=(jobs,), timeout=600)
        for c in FORWARD:
            _jax_forward(c)
        for c in DECODE:
            _jax_decode(c)
        for case in TRAIN:
            _jax_train(case)
        for case in MOE_TRAIN:
            _single_train(case)
        return out.result()


def _result(group, kind, index, rank=0):
    jobs = _jobs()
    at = [i for i, (k, _) in enumerate(jobs) if k == kind][index]
    return group[rank][at]


# ---------------------------------------------------------------------------
# JAX's references
# ---------------------------------------------------------------------------

def _jax_forward(case):
    return _jax_forward_of(case[0], case[1])


@functools.cache
def _jax_forward_of(name, mode):
    """JAX's f32 forward of a config (the same tokens under every mesh)."""
    jcfg, jparams = _model(name)
    tokens = _tokens(1, (2, SEQ), jcfg.vocab)
    logits, aux = jtransformer.forward(jcfg, jparams, jnp.asarray(tokens),
                                       capacity_mode=mode, remat=False,
                                       compute_dtype=jnp.float32)
    return np.asarray(logits), float(aux)


@functools.cache
def _jax_decode(case):
    """JAX's jitted f32 prefill and decode steps."""
    name, kv = case
    jcfg, jparams = _model(name)
    args = _decode_args(case)
    kvd = jnp.int8 if kv == "int8" else jnp.float32
    prefill = jax.jit(functools.partial(
        jdecode.prefill, jcfg, context=CONTEXT, compute_dtype=jnp.float32,
        kv_dtype=kvd))
    step = jax.jit(functools.partial(jdecode.decode_step, jcfg,
                                     compute_dtype=jnp.float32))
    logits, cache = prefill(jparams, jnp.asarray(args[3]))
    out = [np.asarray(logits)]
    for i, tok in enumerate(args[5]):
        logits, cache = step(jparams, jnp.asarray(tok),
                             jnp.int32(PROMPT + i), cache)
        out.append(np.asarray(logits))
    return out


@contextlib.contextmanager
def _jax_f32():
    orig = jstep.forward
    jstep.forward = functools.partial(jtransformer.forward,
                                      compute_dtype=jnp.float32)
    try:
        yield
    finally:
        jstep.forward = orig


@functools.cache
def _jax_train(case):
    """JAX's jitted single-device step, two steps: (metrics, params)."""
    jcfg, jparams = _model(TRAIN[case][0])
    tc = jstep.TrainConfig(**_tc_kw(case))
    fn = jax.jit(jstep.make_train_step(
        jcfg, tc, jschedule.linear_warmup_cosine(*LR)))
    opt = jadamw.adamw_init(jparams)
    out = []
    with _jax_f32():
        for b in _batches(TRAIN[case][0]):
            jparams, opt, m = fn(jparams, opt, jax.tree.map(jnp.asarray, b))
            out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.leaves(jax.device_get(jparams))


@functools.cache
def _single_train(case):
    """The single-rank port's two steps (keep masks included)."""
    name = TRAIN[case][0]
    arch, overrides = CFGS[name]
    cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
    return train_ranks.run_steps(cfg, params_from_jax(_model(name)[1], "cpu"),
                                 _tc_kw(case), LR, _batches(name))


def _delta_rel(got, jax_leaves, jax_0) -> float:
    out = []
    for p, j, j0 in zip(got, jax_leaves, jax_0):
        dj = np.asarray(j, np.float32) - np.asarray(j0, np.float32)
        dp = np.asarray(p, np.float32) - np.asarray(j0, np.float32)
        out.append(np.linalg.norm(dp - dj) / np.linalg.norm(dj))
    return max(out)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,name", enumerate(
    ["internlm2", "qwen1.5", "padded", "granite"]))
def test_place_gather_round_trip(group, index, name):
    for r in range(WORLD):
        assert _result(group, "roundtrip", index, r)["equal"]


class _RankMesh:
    """A duck mesh answering as model rank ``rank`` of 1x4."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": WORLD}

    def __init__(self, rank):
        self.rank = rank

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        return self.rank if axes in ("model", ("model",)) else 0


@pytest.mark.parametrize("index,name", enumerate(
    ["internlm2", "qwen1.5", "padded", "granite"]))
def test_blocks_equal_param_spec_where_heads_align(group, index, name):
    """A rank's blocks are ``local_block`` of JAX's ``param_spec`` where
    it splits a leaf over ``model`` and heads align; the padded config's
    query heads are JAX's flash-branch padding instead."""
    jcfg, jparams = _model(name)
    arch, overrides = CFGS[name]
    cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
    whole = params_from_jax(jparams, "cpu")
    jspecs = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
        tuple(jshardings.param_spec(p, l, _RankMesh(0)))
        for p, l in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    aligned = cfg.n_heads % WORLD == 0 and cfg.n_kv_heads % WORLD == 0
    compared = 0
    for r in range(WORLD):
        mesh = _RankMesh(r)
        lay = tp.TPLayout(mesh, cfg)
        got = _result(group, "roundtrip", index, r)["blocks"]
        for path, t in leaves_with_path(whole):
            np.testing.assert_array_equal(got[path],
                                          place_leaf(path, t, lay).numpy())
            spec = jspecs[path]
            heads = path.split("/")[-1] in ("wq", "wk", "wv", "wo", "bq",
                                            "bk", "bv")
            if "model" in spec and (aligned or not heads):
                np.testing.assert_array_equal(
                    got[path], local_block(t, spec, mesh).numpy())
                compared += 1
    assert compared > 0
    if name == "padded":
        lay = tp.TPLayout(_RankMesh(WORLD - 1), cfg)
        assert (lay.hp, lay.hl) == (8, 2)
        wq = _result(group, "roundtrip", index, WORLD - 1)["blocks"][
            "runs/0/attn/wq"]
        assert not wq.any()          # rank 3 holds padded heads 6 and 7


# ---------------------------------------------------------------------------
# forward, prefill and decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,case", enumerate(FORWARD),
                         ids=[f"{c[0]}-{c[1]}-{c[2]}{'-seq_sp' * c[3]}"
                              for c in FORWARD])
def test_forward_matches_jax(group, index, case):
    want, aux = _jax_forward(case)
    for r in range(WORLD):
        got = _result(group, "forward", index, r)
        np.testing.assert_allclose(got["logits"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5, atol=1e-7)
        assert got["joins"] > 0


@pytest.mark.parametrize("index,case", enumerate(DECODE),
                         ids=[f"{n}-{kv}" for n, kv in DECODE])
def test_prefill_and_decode_on_the_split_ring(group, index, case):
    want = _jax_decode(case)
    tol = 1e-3 if case[1] == "int8" else 1e-5
    for r in range(WORLD):
        got = _result(group, "decode", index, r)
        assert len(got["logits"]) == N_STEPS + 1
        for g, w in zip(got["logits"], want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        assert got["ring_bytes"] * WORLD == got["one_rank_bytes"]
        # the ring block is the one-rank ring's slots (int8: a code may
        # round across a boundary)
        assert got["ring_diff"] <= (1.0 if case[1] == "int8" else 1e-5)


def test_sample_on_the_local_vocab_block(group):
    for r in range(WORLD):
        got = _result(group, "sample", 0, r)
        for key in ("bracket", "greedy", "topk", "slots"):
            np.testing.assert_array_equal(got["got"][key], got["one"][key])
        assert got["joins"] > 0
    assert got["got"]["greedy"][1] == 100      # the lower index of a tie


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,case", enumerate(TRAIN))
def test_train_steps_match_jax(group, index, case):
    want, jparams = _jax_train(case)
    jparams0 = jax.tree.leaves(_model(TRAIN[case][0])[1])
    for r in range(WORLD):
        got = _result(group, "train", index, r)
        for m, jm in zip(got["metrics"], want):
            for key in ("loss", "ce", "aux"):
                np.testing.assert_allclose(m[key], jm[key], rtol=1e-5,
                                           atol=1e-7 if key == "aux" else 0)
            assert m["lr"] == jm["lr"]
        assert _delta_rel(got["params"], jparams, jparams0) < 1e-3
        assert got["pad"] == 0.0


@pytest.mark.parametrize("case", MOE_TRAIN)
def test_train_keep_masks_equal_single_rank(group, case):
    want = _single_train(case)["keeps"]
    index = list(TRAIN).index(case)
    assert not all(k.all() for k in want[0])    # the capacity binds
    for r in range(WORLD):
        got = _result(group, "train", index, r)["keeps"]
        assert [len(k) for k in got] == [len(k) for k in want]
        for g_step, w_step in zip(got, want):
            for g, w in zip(g_step, w_step):
                np.testing.assert_array_equal(g, w)


def test_padded_heads_stay_zero(group):
    index = list(TRAIN).index("padded-1x4-quantile")
    lay = tp.TPLayout(_RankMesh(WORLD - 1), dataclasses.replace(
        testing.reduced_config("internlm2-1.8b"), **CFGS["padded"][1]))
    assert lay.hp > lay.cfg.n_heads
    # rank 3 holds only padded heads; its wq, wo and mu there are 0
    assert _result(group, "train", index, WORLD - 1)["pad"] == 0.0
    metrics = _result(group, "train", index, 0)["metrics"]
    assert metrics[0]["loss"] != metrics[1]["loss"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_checkpoint_restores_on_another_placement(group, dims):
    for r in range(WORLD):
        got = group[r][-1][dims]
        assert got["equal"]
        if dims == (2, 2):
            assert np.isfinite(got["loss"])


def test_checkpoint_restores_on_one_rank(group):
    """The whole checkpoint restores on one rank without a mesh: the
    params the four ranks gathered, bit for bit, one step from JAX's
    weights within the train tolerance of JAX's step."""
    ckpt = group[0][-1]
    template = {"params": params_from_jax(_model("internlm2")[1], "cpu")}
    got = restore_pytree(ckpt["path"], template)
    for a, b in zip(leaves(got["params"]), ckpt["params"]):
        np.testing.assert_array_equal(a.numpy(), b)
    case = "internlm2-1x4-global"
    jcfg, jparams = _model("internlm2")
    tc = jstep.TrainConfig(**_tc_kw(case))
    fn = jax.jit(jstep.make_train_step(
        jcfg, tc, jschedule.linear_warmup_cosine(*LR)))
    with _jax_f32():
        want, _, _ = fn(jparams, jadamw.adamw_init(jparams),
                        jax.tree.map(jnp.asarray, _batches("internlm2")[0]))
    assert _delta_rel([a.numpy() for a in leaves(got["params"])],
                      jax.tree.leaves(jax.device_get(want)),
                      jax.tree.leaves(jparams)) < 1e-3
