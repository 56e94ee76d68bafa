"""Data-parallel training across ranks in the port (``train/step.py``'s
``make_train_step(mesh=)``, ``models/moe.py``'s routing under a batch
split, ``launch/train.py --mesh elastic --host-devices N``, the mesh's
checkpoints) on gloo ranks on the CPU, against JAX's jitted
single-device ``make_train_step`` and the single-rank port.

JAX's launcher trains data-parallel only (``make_elastic_mesh(
model_parallel=1)``, no gradient constraint): GSPMD makes the step
compute the single-device function, so the port's meshed step is held
to that function.  Every meshed run of the module shares one group of
four ranks (``tests/torch_train_ranks.py``, no JAX); the launcher's
kill-and-resume spawns its own two ranks.

Reduced internlm2-1.8b, granite-moe-3b-a800m (its capacity factor cut
to 0.5, so that the cut drops assignments and couples the ranks' rows),
xlstm-1.3b and hymba-1.5b, f32 params, both packages' ``forward``
wrapped to f32 as ``tests/test_torch_moe.py`` does, a global batch of 8
x 16 tokens of ``SyntheticTokens``, two steps (no warm-up: both move the
params).

Tolerances:
  * every step's loss, ce and aux within rtol 1e-5 of JAX's, the lr
    equal; the params' change per leaf at l2 rel < 1e-3 of JAX's (as
    ``tests/test_torch_train_families_f32.py``);
  * the four ranks' params and optimizer state bit-identical after every
    step (their ``replica_digest``s equal);
  * every capacity cut's keep mask (each group of each forward and remat
    recompute) equal to the single-rank port's bit for bit;
  * xlstm and hymba, one step each, against the single-rank port: loss
    rtol 1e-5, params within 1e-5;
  * the split MoE layer on each of four blocks of a batch against the
    layer on the whole batch, in one process: keep masks bit for bit,
    outputs within 1e-6, a rank's expert buffer its own kept tokens only;
  * ZeRO-1 (``adamw_init(params, mesh=)``, ``make_train_step(...,
    grad_constraint=zero1_grad_constraint(mesh))``): internlm2 with the
    quantile clip in 2 microbatches and granite under bisect with the
    global clip, each without and with the gradient constraint, held to
    JAX's jitted step as above; each rank's master, mu and nu the blocks
    of JAX's ``zero1_spec`` on a duck-typed 4x1 mesh, the ranks' master
    blocks together the params (f32 params: bit for bit); the quantile
    clip's cuts equal to the single-rank port's bit for bit; a ZeRO-1
    state written whole on the four ranks restores cut to each rank's
    blocks, and whole on one rank, where the all-reduce step goes on
    from it;
  * the launcher (bf16 params, as on the card): the meshed run's losses
    within rtol 1e-3 of ``--mesh single``'s (a data split sums the
    bf16-rounded gradients in another order), its ranks' params and
    state bit-identical after every step (``check_replicas`` from
    ``on_state``), a resume on one rank of a checkpoint saved by two
    within the same.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import testing as jtesting
from repro.models import transformer as jtransformer
from repro.launch import shardings as jshardings
from repro.launch.specs import params_specs as jparams_specs
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_pytree,
    save_pytree,
)
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, spawn_local
from repro_torch.models import moe, testing
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import derive_mesh_shape, make_elastic_mesh
from repro_torch.train import step
from repro_torch.tree import leaves
import torch_one_thread  # noqa: F401 (one torch thread)

GRANITE = "granite-moe-3b-a800m"
WORLD, B, SEQ, N_STEPS = 4, 8, 16, 2
LR = (1e-3, 0, 10)            # no warm-up: both steps update
MOE = dict(capacity_factor=0.5)
# (arch, config overrides, TrainConfig kwargs)
CASES = {
    "dense-global": ("internlm2-1.8b", {}, dict(clip_mode="global")),
    "dense-quantile-mb2": ("internlm2-1.8b", {},
                           dict(clip_mode="quantile", n_microbatches=2)),
    "moe-fifo-quantile": (GRANITE, MOE, dict(capacity_mode="fifo",
                                             clip_mode="quantile")),
    "moe-bisect-global-mb2": (GRANITE, MOE, dict(capacity_mode="bisect",
                                                 clip_mode="global",
                                                 n_microbatches=2)),
    "moe-bisect-groups2": (GRANITE, MOE, dict(capacity_mode="bisect",
                                              clip_mode="quantile",
                                              moe_groups=2)),
    "xlstm": ("xlstm-1.3b", {}, dict(clip_mode="quantile")),
    "hymba": ("hymba-1.5b", {}, dict(clip_mode="global")),
}
# the recurrent families are held to the single-rank port
RECURRENT = ["xlstm", "hymba"]
JAX_CASES = [c for c in CASES if c not in RECURRENT]
MOE_CASES = [c for c in CASES if c.startswith("moe")]
# the ZeRO-1 cases: both clips, both capacity-free and bisect routing
ZERO1_CASES = ["dense-quantile-mb2", "moe-bisect-global-mb2"]
LAUNCH = ["--device", "cpu", "--reduced", "--steps", "4", "--batch", "8",
          "--seq", "32", "--clip-mode", "quantile", "--lr", "3e-3",
          "--log-every", "1"]


def _tc_kw(case) -> dict:
    return {**CASES[case][2], "param_dtype": "float32"}


def _inputs(case):
    """(JAX config, JAX's f32 params, the batches as numpy)."""
    arch, overrides, _ = CASES[case]
    return _model(arch, tuple(sorted(overrides.items())))


@functools.cache
def _model(arch, overrides: tuple):
    """``_inputs`` of every case of one model, drawn once: N_STEPS
    batches (one for a recurrent family, held to the single-rank port
    a step)."""
    jcfg = dataclasses.replace(jtesting.reduced_config(arch),
                               **dict(overrides))
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
    data = JSyntheticTokens(vocab=jcfg.vocab, seq_len=SEQ, global_batch=B)
    steps = 1 if jcfg.family in ("ssm", "hybrid") else N_STEPS
    return jcfg, jax.device_get(jparams), [dict(data.batch_at(i))
                                           for i in range(steps)]


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
def _jax_run(case):
    """JAX's jitted single-device step, two steps: (metrics, params)."""
    jcfg, jparams, batches = _inputs(case)
    tc = jstep.TrainConfig(**_tc_kw(case))
    fn = jax.jit(jstep.make_train_step(
        jcfg, tc, jschedule.linear_warmup_cosine(*LR)))
    opt = jadamw.adamw_init(jparams)
    out = []
    with _jax_f32():
        for b in batches:
            jparams, opt, m = fn(jparams, opt, jax.tree.map(jnp.asarray, b))
            out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.leaves(jax.device_get(jparams))


@functools.cache
def _single(case):
    """The single-rank port's two steps (``torch_train_ranks.run_steps``)."""
    arch, overrides, _ = CASES[case]
    cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
    _, jparams, batches = _inputs(case)
    return ranks.run_steps(cfg, params_from_jax(jparams, "cpu"),
                           _tc_kw(case), LR, batches)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every meshed run of the module on one group of four ranks: [per
    rank: ``torch_train_ranks.train_jobs``' result].  This process
    computes JAX's and the single-rank port's references while the ranks
    run."""
    jobs = []
    for case, (arch, overrides, _) in CASES.items():
        _, jparams, batches = _inputs(case)
        jobs.append((arch, overrides, jparams, _tc_kw(case), LR, batches))
    zero1 = [jobs[list(CASES).index(case)] for case in ZERO1_CASES]
    ckpt = str(tmp_path_factory.mktemp("train_mesh") / "ckpt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_out = pool.submit(spawn_local, ranks.train_jobs, WORLD,
                                args=(jobs, LAUNCH, ckpt, zero1),
                                timeout=600)
        for case in JAX_CASES:
            _jax_run(case)
        for case in MOE_CASES + RECURRENT + ZERO1_CASES:
            _single(case)
        out = ranks_out.result()
    out[0]["zero1_ckpt"] = f"{ckpt}_zero1/step_2"
    return out


def _job(group, case, rank=0):
    return group[rank]["jobs"][list(CASES).index(case)]


def _delta_rel(got, jax_leaves, jax_0) -> float:
    """Per leaf, |(p - p0) - (j - j0)| / |j - j0| in the l2 norm; the
    largest over the leaves."""
    out = []
    for p, j, j0 in zip(got, jax_leaves, jax_0):
        dj = np.asarray(j, np.float32) - np.asarray(j0, np.float32)
        dp = np.asarray(p, np.float32) - np.asarray(j0, np.float32)
        out.append(np.linalg.norm(dp - dj) / np.linalg.norm(dj))
    return max(out)


@pytest.mark.parametrize("case", JAX_CASES)
def test_meshed_steps_match_jax(group, case):
    want, jparams = _jax_run(case)
    got = _job(group, case)
    for m, jm in zip(got["metrics"], want):
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5,
                                       atol=1e-7 if key == "aux" else 0)
        assert m["lr"] == jm["lr"]
        if "grad_norm" in jm:
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                       rtol=1e-4)
    jparams0 = jax.tree.leaves(_inputs(case)[1])
    assert _delta_rel(got["params"], jparams, jparams0) < 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_replicas_stay_bit_identical(group, case):
    digests = [_job(group, case, r)["digests"] for r in range(WORLD)]
    assert len(digests[0]) == len(_inputs(case)[2])
    assert all(d == digests[0] for d in digests)
    metrics = [_job(group, case, r)["metrics"] for r in range(WORLD)]
    assert all(m == metrics[0] for m in metrics)


@pytest.mark.parametrize("case", MOE_CASES)
def test_keep_masks_equal_single_rank(group, case):
    want = _single(case)["keeps"]
    arch, overrides, tc = CASES[case]
    n_layers = testing.reduced_config(arch).n_layers
    # a cut a group in a layer's forward and its remat recompute, each
    # microbatch
    calls = (2 * n_layers * tc.get("n_microbatches", 1)
             * tc.get("moe_groups", 1))
    for r in range(WORLD):
        got = _job(group, case, r)["keeps"]
        assert [len(k) for k in got] == [len(k) for k in want] == \
            [calls] * N_STEPS
        for g_step, w_step in zip(got, want):
            for g, w in zip(g_step, w_step):
                np.testing.assert_array_equal(g, w)
    # the capacity binds: some assignments drop
    assert not all(k.all() for k in want[0])


class _GatherMesh:
    """A one-process stand-in for the mesh of a split MoE layer: its
    all_gather returns the whole batch's (expert id, gate) rows."""

    def __init__(self, whole: torch.Tensor):
        self.whole = whole

    def all_gather(self, t, axes):
        return self.whole


@pytest.mark.parametrize("n_groups", [1, 2, 8])
@pytest.mark.parametrize("mode", ["fifo", "bisect"])
def test_split_layer_packs_only_its_own_tokens(mode, n_groups):
    """Each of WORLD ranks runs the layer on its block of the batch's rows
    (``BatchSplit``): its keep mask is its slice of the whole batch's bit
    for bit, its expert buffer holds its own kept assignments only (as
    many slots a (group, expert) as it keeps in the fullest one, one where
    it keeps none: fewer
    than the capacity where the group spans the ranks), and its outputs,
    the ranks' mean aux loss and the dropped fraction are the whole
    batch's layer's.  With 8 groups a rank's rows span two of them."""
    cfg = dataclasses.replace(testing.reduced_config(GRANITE), **MOE)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32)
    x = torch.randn((B, SEQ, cfg.d_model), generator=gen)
    k, e_pad = cfg.moe_top_k, moe.padded_experts(cfg.n_experts)
    whole, whole_st = moe.moe_apply(p, cfg, x, capacity_mode=mode,
                                    n_groups=n_groups)
    wd = moe._dispatch(p, cfg, x, mode, n_groups, "hopper", moe.NO_SPLIT)
    blocks = x.chunk(WORLD)
    rows = []
    for b in blocks:
        _, idx, vals = moe._route(p, cfg, b.reshape(-1, cfg.d_model))
        rows.append(torch.stack([idx.reshape(-1).float(),
                                 vals.reshape(-1)], dim=1))
    mesh = _GatherMesh(torch.cat(rows))
    a_l = B * SEQ * k // WORLD
    tg = B * SEQ // n_groups
    cap = wd.expert_in.shape[2]
    outs, aux = [], []
    for r, b in enumerate(blocks):
        split = moe.BatchSplit(mesh, ("data",), WORLD, r)
        d = moe._dispatch(p, cfg, b, mode, n_groups, "hopper", split)
        part = slice(r * a_l, (r + 1) * a_l)
        torch.testing.assert_close(d.keep, wd.keep[part], rtol=0, atol=0)
        keys = ((torch.arange(a_l) // k + r * a_l // k) // tg
                - r * a_l // k // tg) * e_pad + wd.g_expert.reshape(-1)[part]
        counts = torch.bincount(keys[d.keep], minlength=1)
        assert d.expert_in.shape[:3] == (keys.max() // e_pad + 1, e_pad,
                                         max(1, int(counts.max())))
        assert d.expert_in.shape[2] <= cap
        if n_groups == 1:
            assert d.expert_in.shape[2] < cap
        out, st = moe.moe_apply(p, cfg, b, capacity_mode=mode,
                                n_groups=n_groups, split=split)
        assert float(st.dropped_frac) == float(whole_st.dropped_frac)
        outs.append(out)
        aux.append(float(st.aux_loss))
    assert float(whole_st.dropped_frac) > 0
    np.testing.assert_allclose(torch.cat(outs).numpy(), whole.numpy(),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.mean(aux), float(whole_st.aux_loss),
                               rtol=1e-6)


@pytest.mark.parametrize("case", RECURRENT)
def test_recurrent_steps_match_single_rank(group, case):
    want = _single(case)
    got = _job(group, case)
    for m, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
    for p, w in zip(got["params"], leaves(want["params"])):
        np.testing.assert_allclose(p, w.numpy(), rtol=0, atol=1e-5)


@dataclasses.dataclass
class DuckMesh:
    """What JAX's spec functions read of a mesh (no devices)."""
    axis_names: tuple
    shape: dict


def _zero1(group, case, constraint, rank=0, disabled=False):
    return group[rank]["zero1"][ZERO1_CASES.index(case)][(constraint,
                                                          disabled)]


@pytest.mark.parametrize("constraint", [False, True],
                         ids=["all-reduce", "reduce-scatter"])
@pytest.mark.parametrize("case", ZERO1_CASES)
def test_zero1_steps_match_jax(group, case, constraint):
    want, jparams = _jax_run(case)
    got = _zero1(group, case, constraint)
    for m, jm in zip(got["metrics"], want):
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5,
                                       atol=1e-7 if key == "aux" else 0)
        assert m["lr"] == jm["lr"]
        if "grad_norm" in jm:
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                       rtol=1e-4)
    jparams0 = jax.tree.leaves(_inputs(case)[1])
    assert _delta_rel(got["params"], jparams, jparams0) < 1e-3
    runs = [_zero1(group, case, constraint, r) for r in range(WORLD)]
    assert all(r["metrics"] == runs[0]["metrics"] for r in runs)
    # after every step's all-gather the ranks hold the same params bit for
    # bit (the digests of params and state also cover each rank's blocks)
    assert len(runs[0]["param_digests"]) == len(runs[0]["digests"]) == N_STEPS
    assert all(r["param_digests"] == runs[0]["param_digests"] for r in runs)
    forms = {_zero1(group, case, constraint, r)["form"]
             for r in range(WORLD)}
    assert forms == ({"reduce_scatter_tensor"} if constraint else {None})


@pytest.mark.parametrize("case", ZERO1_CASES)
def test_zero1_blocks_are_jax_zero1_spec_blocks(group, case):
    """Each rank holds only its block of ``zero1_spec`` (JAX's, on a
    duck-typed 4x1 mesh) of master, mu and nu, and the four ranks' master
    blocks, put together on their ``data`` dim, are the final params."""
    duck = DuckMesh(("data", "model"), {"data": WORLD, "model": 1})
    jcfg = _inputs(case)[0]
    leaves_j = jax.tree_util.tree_flatten_with_path(jparams_specs(jcfg))[0]
    want, dims = [], []
    for path, leaf in leaves_j:
        spec = tuple(jshardings.zero1_spec(path, leaf, duck))
        spec += (None,) * (len(leaf.shape) - len(spec))
        want.append(tuple(n // (WORLD if s == "data" else 1)
                          for n, s in zip(leaf.shape, spec)))
        dims.append(spec.index("data") if "data" in spec else None)
    assert any(d is not None for d in dims)
    for constraint in (False, True):
        runs = [_zero1(group, case, constraint, r) for r in range(WORLD)]
        for got in runs:
            for field in ("master", "mu", "nu"):
                assert got["shapes"][field] == want, field
        params = runs[0]["params"]
        for i, d in enumerate(dims):
            blocks = [r["master"][i] for r in runs]
            whole = (blocks[0] if d is None
                     else np.concatenate(blocks, axis=d))
            np.testing.assert_array_equal(whole, params[i])


@pytest.mark.parametrize("disabled", [False, True],
                         ids=["default", "tuning-disabled"])
def test_zero1_quantile_clip_counts_equal_single_rank(group, disabled):
    """Each meshed quantile clip's cut equals the single-rank solve's on
    the same norms bit for bit (its counts are exact), the ranks agree,
    and the norms are the single-rank port's within f32 rounding.  Under
    ``tuning.disabled()`` the solve splits the norms over the four
    ranks ("vocab" on the ``data`` axis: K2 on the card counts each
    rank's share, the counts summed), which the leaf count of reduced
    internlm2 allows."""
    from repro_torch.core import tuning
    from repro_torch.core.applications import quantile

    case = "dense-quantile-mb2"
    want = _single(case)["clip_cuts"]
    assert [len(c) for c in want] == [1] * N_STEPS
    for constraint in (False, True):
        runs = [_zero1(group, case, constraint, r, disabled)
                for r in range(WORLD)]
        for got in runs:
            assert [[c[1] for c in s] for s in got["clip_cuts"]] == \
                [[c[1] for c in s] for s in runs[0]["clip_cuts"]]
        for got_s, want_s in zip(runs[0]["clip_cuts"], want):
            (norms, cut, placements), = got_s
            np.testing.assert_allclose(norms, want_s[0][0], rtol=1e-4)
            with tuning.disabled():
                single = quantile(torch.from_numpy(norms), 0.95, spec_k=4,
                                  rounds=8, backend="hopper")
            assert float(single) == cut
            if disabled:
                assert placements == ["vocab"]


def test_zero1_checkpoint_restores_on_one_rank(group):
    """The ZeRO-1 state written whole on four ranks: each rank restored
    its blocks (``zero1_sharding_fn``), and one rank restores it whole
    and trains on from it with the all-reduce (single-rank) step."""
    case = ZERO1_CASES[0]
    assert all(_zero1(group, case, True, r)["restored"]
               for r in range(WORLD))
    arch, overrides, _ = CASES[case]
    cfg = dataclasses.replace(testing.reduced_config(arch), **overrides)
    jcfg, jparams, batches = _inputs(case)
    params = params_from_jax(jparams, "cpu")
    template = {"params": params, "opt": adamw.adamw_init(params)}
    back = restore_pytree(group[0]["zero1_ckpt"], template)
    got = [_zero1(group, case, True, r) for r in range(WORLD)]
    for i, (p, m) in enumerate(zip(leaves(back["params"]),
                                   leaves(back["opt"].master))):
        np.testing.assert_array_equal(p.numpy(), got[0]["params"][i])
        np.testing.assert_array_equal(m.numpy(), got[0]["params"][i])
    assert int(back["opt"].step) == N_STEPS
    fn = step.make_train_step(cfg, step.TrainConfig(**_tc_kw(case)),
                              ranks.lr_fn(*LR))
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with ranks.f32_forward():
        _, opt, m = fn(back["params"], back["opt"], batch)
    assert np.isfinite(float(m["loss"])) and int(opt.step) == N_STEPS + 1


class _FakeMesh:
    """The axis queries ``rank_rows`` makes, for one rank of a D-way data
    axis (no process group)."""

    def __init__(self, d, r):
        self.d, self.r, self.axis_names = d, r, ("data", "model")

    def axis_size(self, axes):
        return self.d if axes else 1

    def axis_index(self, axes):
        return self.r if axes else 0


@pytest.mark.parametrize("n", [1, 2])
def test_rank_rows_concatenate_to_jax_microbatches(n):
    x = torch.arange(8 * 3).reshape(8, 3)
    per_rank = [step.rank_rows({"t": x}, n, _FakeMesh(4, r))["t"]
                for r in range(4)]
    for i, mb in enumerate(x.reshape(n, 8 // n, 3)):
        got = torch.cat([p.reshape(n, -1, 3)[i] for p in per_rank])
        assert torch.equal(got, mb)
    with pytest.raises(ValueError, match="does not split"):
        step.rank_rows({"t": x}, 3, _FakeMesh(4, 0))


def test_elastic_mesh_is_data_parallel(group):
    for n in range(1, 9):
        assert derive_mesh_shape(n, model_parallel=1) == (
            {"data": n, "model": 1}, 0)
    assert all(out["shape"] == {"data": WORLD, "model": 1} for out in group)
    one = make_elastic_mesh(model_parallel=1)     # no process group: 1x1
    assert one.shape == {"data": 1, "model": 1} and one.size == 1


@functools.cache
def _launcher_single() -> dict:
    return launch_train.main(LAUNCH + ["--mesh", "single"])


def test_launcher_meshed_losses_equal_single(group):
    want = _launcher_single()["losses"]
    for out in group:
        got = out["launcher"]
        assert got["world"] == WORLD and len(got["join_seconds"]) == 4
        np.testing.assert_allclose(got["losses"], want, rtol=1e-3)
        # every rank's params and state bit-identical after every step
        assert len(got["digests"]) == 4
        assert got["digests"] == group[0]["launcher"]["digests"]
    assert np.isfinite(want).all() and want[-1] < want[0]


def test_launcher_kill_on_two_ranks_resume_on_one(tmp_path, caplog):
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    with pytest.raises(SystemExit) as died:
        launch_train.main(LAUNCH + ckpt + ["--host-devices", "2",
                                           "--die-at-step", "1"])
    assert died.value.code == 42
    assert CheckpointManager(str(tmp_path)).latest_valid() == 2
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        out = launch_train.main(LAUNCH + ckpt + ["--mesh", "single"])
    assert "resumed from checkpoint step 2" in caplog.text
    np.testing.assert_allclose(out["losses"], _launcher_single()["losses"][2:],
                               rtol=1e-3)
    with pytest.raises(SystemExit):
        launch_train.parse_args(LAUNCH + ["--mesh", "single",
                                          "--host-devices", "2"])


def test_restore_with_sharding_fn(tmp_path):
    """Elastic restore: leaves re-placed through a callback (JAX's
    ``tests/test_checkpoint.py::test_restore_with_sharding_fn``)."""
    t = {"w": torch.randn(4, 3), "b": torch.arange(5, dtype=torch.int32),
         "h": torch.randn(2, dtype=torch.float32).to(torch.bfloat16)}
    path = save_pytree(str(tmp_path), 1, t)
    calls = []

    def sharding_fn(name, arr):
        calls.append((name, arr.shape))
        return torch.device("cpu")

    out = restore_pytree(path, t, sharding_fn)
    assert all(torch.equal(out[k], t[k]) for k in t)
    assert sorted(calls) == [("b", (5,)), ("h", (2,)), ("w", (4, 3))]
    # the default placement stays device=
    assert restore_pytree(path, t, device="cpu")["w"].device.type == "cpu"


def test_checkpoint_under_the_mesh(group):
    """Rank 0 wrote, every rank restored it whole through ``sharding_fn``
    and cut to its block of a ``("data",)`` spec."""
    w = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(group):
        got = out["restore"]
        assert got["equal"] and sorted(got["names"]) == ["b", "w"]
        assert got["steps"] == [1]
        np.testing.assert_array_equal(got["block"], w[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["b"], np.arange(4))


def test_mesh_barrier_of_one_rank():
    mesh = Mesh((1, 1), ("data", "model"))
    mesh.barrier()                   # one rank: nothing to wait for
    assert mesh.stats.count == 0
    assert make_elastic_mesh(model_parallel=1).size == 1
