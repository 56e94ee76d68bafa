#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 is switched off for matmuls and cuDNN.
  2. the kernel build: every csrc/*.cu through nvcc, in parallel, timed;
     ptxas's registers, shared memory and spills for every kernel, and the
     SASS of K1's library counted for IEEE division (FCHK, MUFU.RCP,
     CALL) kernel by kernel.
  3. each kernel against its plain PyTorch version on the card, at its
     path's shapes: K2-K5 at the sampler's (B=4, V=151936, M=31 and M=1)
     and at ragged V (1000, 257): K2 and K3 bit for bit (K3 also against
     the generic engine loop over K2, and on rows holding NaN, whose
     bracket is (NaN, NaN)), K4 and K5 within rtol 1e-5 / atol 1e-6 (K5 at
     the engine's extreme temperatures 0.05 and 20 too), bit for bit run
     to run and between an eager call and CUDA-graph replay, one kernel
     launch a call (profiled), with K5's bound restated for its
     exponentials on the SFU and the stage clock of K4 and K5 (where a
     call's time goes, csrc/row_reduce.cuh); K1 at M in {1, 7, 31} and
     terms in {10, 10**4}, bit for bit, timed against a latency bound
     (2 (terms - 1) dependent steps of 4 FMA latencies at the card's top
     SM clock, the FMA latency measured beside it) and beside the first
     version's division (an __fdiv_rn a step, also with a zero numerator
     skipping it); K3 with its cluster geometry, and with the other
     cluster size;
     K6 at the served decode shape (B=4, n_kv=8,
     n_rep=4, head_dim 128, page 16, the chain of a 544-token context,
     L=1), at that shape with short positions (splits of the chain that
     hold only masked pages) and at L=3 with a page size that does not
     divide the context and a wrapped row, f32 within 1e-5 and bf16
     within 1e-2 (compared in f32), bit for bit run to run.  Each row:
     device time per call (CUDA-graph replay between CUDA events,
     L2-warm), time per eager call, the plain version's time, the least
     time the card could take and, where one PyTorch call computes the
     same function, its time.
  4. one solve per kind on the "hopper" backend under
     torch.cuda.set_sync_debug_mode("error") (the round loop never syncs),
     including count_above with a (B,) k tensor, which runs K2 through the
     engine; brackets against the "torch" backend.
  5. the one-shot serving path: repro_torch.launch.serve (setup, then run,
     as its main does) for qwen3-4b at full width (36 layers, d_model
     2560, vocab 151936; random bf16 weights from a seed), 4 x 16 tokens
     sampled with top-k 40, top-p 0.9 and target entropy 3.0 on the
     "hopper" backend; the launch counters must show K3 once per token and
     K4, K5 nine times per token.
  6. a reference check: the sampler's masked logits on both backends, and
     greedy generate on reduced qwen3-4b, "hopper" against "torch".
  7. phase 5's serve.run on its session again, warm, timed, and once more
     under torch.profiler (device busy time, idle share, top kernels, and
     the sampler kernels K3-K5 each).
  8. the paper path: repro_torch.launch.paper (its main, in-process): the
     Fig. 4 sweep (terms 10**4, n=24, k=1..5) and the Fig. 7 sweep (n=6,
     k=3, terms 10..5000) through K1, every runahead root equal to the
     serial root bit for bit; then one serial and one runahead solve per
     k under set_sync_debug_mode("error"), with K1 launched n + 1 and
     ceil(n/k) + 1 times.
  9. the continuous path: repro_torch.launch.serve --continuous for
     qwen3-4b at full width, 8 requests (prompt 512, up to 32 new tokens)
     over 4 slots on a paged cache (page 16) through K6 and the sampler
     kernels: every request served, K6 launched 36 times per decode step,
     K3 once and K4, K5 nine times per sample; tok/s, latency, host syncs
     per step; a second run under torch.profiler (K6 and K3-K5 each);
     three decode steps of a fresh server under
     set_sync_debug_mode("error") with the once-per-step token read
     outside that window.
 10. a reference check of the continuous path on reduced qwen3-4b (f32,
     prompts screened for greedy ties): paged K6 streams equal paged
     gather streams and the one-shot stream of every request.
 11. the training path: repro_torch.launch.train (its main, in-process)
     for internlm2-1.8b at full width and depth (24 layers, d_model 2048,
     GQA 16/8, head_dim 128, d_ff 8192, vocab 92544; random bf16 weights
     from seed 0), batch 2 x seq 4096 of SyntheticTokens, remat on, the
     quantile clip, AdamW: 1 warm-up step, 4 timed steps and 1 step under
     torch.profiler.  Every loss finite; K7 launched exactly 48 times per
     step (24 layers forward, 24 remat recomputes) and K2 on every step
     (the quantile clip's solve); ms per step, tokens per second, peak
     memory, device busy time, idle share and K7's share of it.
 12. checkpoint and fault injection on the card: reduced internlm2-1.8b
     in a subprocess (--ckpt-every 5 --die-at-step 7) exits 42 with
     step_5 on disk; the rerun resumes from step 5, and its losses and
     final checkpoint equal an uninterrupted run's, bit for bit.

Phase 3 also holds K7 (flash_fwd) at the training shape (B=2, S=4096,
16 q heads, 8 kv heads, head_dim 128) against its plain version in f32
at JAX's K7 tolerance (atol 2e-5 / rtol 1e-4) and, in bf16 (tensor
cores, p rounded to bf16 before P.V), by accuracy: its largest |diff|
from the f32 reference on the same inputs at most the bf16 plain
version's plus one bf16 ulp, and every element within one bf16 ulp of
itself plus one of its row's largest of the bf16 plain version at the
kernel's key tile (``flash_fwd.bf16_check``); and at a ragged banded
shape (S=1000,
window 128, f32, atol 2e-5 / rtol 1e-4); bit for bit run to run.  Its
bound counts the causal half of the score matrix at the bf16 tensor-core
rate (989 TFLOP/s); the achieved TFLOP/s is printed beside it.

The line before the last is a JSON object listing the kernels, each with
the path its launch count was read on ("serve": phase 5; "solves": phase
4, for K2, which the static-k serve does not launch; "paper": phase 8;
"continuous": phase 9; "train": phase 11, for K7).  Each entry's
bound_ms is the larger of its bytes and operations bounds; K1's chain of
dependent steps is bounded by latency instead, which its entry carries
as latency_bound_ms beside the operations bound.  The last line is
{"ok": true, "device": {...}}.
Nothing is printed as a result when torch sees no CUDA device or the
port's sources are not beside this file.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
SFU_PER_CLOCK = 16              # exponentials an SM issues a clock (cc 9.0)
FP32_LANES = 128                # FP32 lanes of an SM: one instruction each
TOL = dict(rtol=1e-5, atol=1e-6)
PATH_B, PATH_V, PATH_M = 4, 151936, 31
SAMPLER_ARGV = ["--top-k", "40", "--top-p", "0.9", "--target-entropy", "3.0",
                "--backend", "hopper"]
SERVE_ARGV = ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "64",
              "--new-tokens", "16"] + SAMPLER_ARGV
NEW_TOKENS = 16
CONT_ARGV = ["--arch", "qwen3-4b", "--continuous", "--requests", "8",
             "--slots", "4", "--arrival-burst", "2", "--prompt-len", "512",
             "--new-tokens", "32", "--page-size", "16", "--page-impl",
             "hopper"] + SAMPLER_ARGV
K1_TERMS = 10_000                 # the paper's term count
# K1's latency bound: a bit-exact step is 4 dependent operations (the
# numerator's multiply, q0, rho, q: csrc/taylor_eval.cu) of 4 cycles each
# (an f32 FMA's dependent-issue latency)
K1_CHAIN_DEPTH, FMA_LATENCY = 4, 4
# K6 at the served decode shape: B=4 slots, n_kv=8, n_rep=4, head_dim 128,
# page 16, the 34-page chain of a 512 + 32 token context
K6_PATH = dict(B=4, nkv=8, nq=32, hd=128, P=16, C=544, L=1,
               pos=[520, 529, 537, 543])
# L=3, a page size that does not divide the context, the last row wrapped
K6_EDGE = dict(B=3, nkv=8, nq=32, hd=128, P=16, C=100, L=3,
               pos=[40, 96, 130])
# the served shape with short positions: slot 0 sees page 0 only, so 8 of
# its 9 chain splits hold only masked pages and must weigh exactly 0
K6_MASKED = dict(K6_PATH, pos=[5, 100, 300, 543])
# K7 at the training shape (internlm2-1.8b, batch 2 x 4096) and a ragged
# banded shape at JAX's own K7 tolerance
K7_PATH = dict(B=2, S=4096, H=16, Hk=8, D=128, window=0)
K7_EDGE = dict(B=1, S=1000, H=2, Hk=2, D=128, window=128)
TRAIN_ARGV = ["--arch", "internlm2-1.8b", "--steps", "6", "--batch", "2",
              "--seq", "4096", "--clip-mode", "quantile", "--log-every",
              "1", "--seed", "0"]
TRAIN_PROFILED_STEP = 5         # step 0 warms up, steps 1-4 are timed
FAULT_ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cuda",
              "--steps", "10", "--batch", "4", "--seq", "64", "--clip-mode",
              "quantile", "--ckpt-every", "5", "--log-every", "1"]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(run) -> float:
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call in ms, without the host's launch cost:
    ``calls`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events; the median replay over ``calls``.  Inputs stay
    in the 50 MB L2 between calls, as the sampler's logits do."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = [_event_ms(graph.replay) / calls for _ in range(reps)]
    del graph
    return statistics.median(times)


def call_ms(fn, reps: int = 20) -> float:
    """Median time of one fn() call between CUDA events, host launch cost
    included: what an eager caller such as the sampler pays."""
    fn()
    return statistics.median(_event_ms(fn) for _ in range(reps))


def replay_equals_eager(fn) -> bool:
    """fn()'s outputs from a CUDA-graph replay of one call equal an eager
    call's, bit for bit."""
    import torch

    def bits(out):
        return [t.view(torch.int32) for t in
                (out if isinstance(out, tuple) else (out,))]

    want = bits(fn())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = bits(fn())
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return all(torch.equal(g, w) for g, w in zip(got, want))


def kernels_per_call(fn) -> dict:
    """The device kernels one eager fn() call launches, by name, counted
    under torch.profiler after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _stage_note(stages: dict) -> str:
    """The stage clock (csrc/row_reduce.cuh): us since a call's first
    block started, the median over blocks, then over 9 calls (min-max)."""
    return ("stage clock, us since the first block's start (median over "
            "blocks, then over 9 calls, min-max): " + ", ".join(
                f"{stage} {med:.2f} ({lo:.2f}-{hi:.2f})"
                for stage, (lo, med, hi) in stages.items()))


def _one_kernel(fn, name: str) -> str:
    """Checks that one eager fn() call launches the one device kernel
    ``name`` and nothing else; says so."""
    kernels = kernels_per_call(fn)
    check(len(kernels) == 1 and all(name in k and n == 1
                                    for k, n in kernels.items()),
          f"a call launched {kernels}, not one {name}")
    return f"1 {name} a call, profiled"


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(smi)
    say(f"phase 1 card: {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | TF32 off (matmul and cuDNN)")
    return smi


def phase_build():
    from repro_torch.kernels import build, row_reduce

    seconds = build.build_all(build.SOURCES + row_reduce.STAGE_BUILDS)
    say(f"phase 2 build: {len(build.SOURCES)} kernels and "
        f"{len(row_reduce.STAGE_BUILDS)} stage-clock variants in "
        f"{seconds:.1f}s (parallel nvcc, sm_90a)")
    for name in build.SOURCES:
        kernel = ""
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                say(f"  ptxas {name} {_short(kernel)}: {line.strip()}")
    say(f"  sass taylor_eval: {_sass_division_sites('taylor_eval')}")


def _short(symbol: str) -> str:
    """A kernel's name from its mangled symbol (the last name of a nested
    one), with a bool template argument as <true> / <false>."""
    i = 3 if symbol.startswith("_ZN") else 2 if symbol.startswith("_Z") else 0
    name = ""
    while i and i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
        if not symbol.startswith("_ZN"):
            break
    rest = symbol[i:]
    return (name or symbol[:40]) + ("<true>" if rest.startswith("ILb1E") else
                                    "<false>" if rest.startswith("ILb0E")
                                    else "")


def _sass_division_sites(name: str) -> str:
    """Per kernel of a built library, the SASS instructions of IEEE f32
    division: FCHK (the range check that sends an operand to the slow
    path), MUFU.RCP and CALL (the slow path's subroutine); "not measured"
    where the toolkit has no cuobjdump."""
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured (no cuobjdump)"
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _short(line.split("Function :")[1].strip())
            counts[fn] = {"FCHK": 0, "MUFU.RCP": 0, "CALL": 0}
        elif fn is not None:
            for op in counts[fn]:
                if op in line:
                    counts[fn][op] += 1
    return "; ".join(f"{fn} " + " ".join(f"{op} {n}" for op, n in c.items())
                     for fn, c in counts.items())


def phase_kernels(gen):
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import row_reduce
    from repro_torch.kernels import runahead_threshold as rt

    dev = torch.device("cuda")
    rows = {}

    def logits(B, V):
        return torch.randn((B, V), generator=gen, device=dev) * 2.0

    def between(x, M):
        """Candidates as the engine passes them: the interior columns of a
        (B, M + 2) grid, a row-strided view."""
        lo, hi = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
        grid = lo + (hi - lo) * torch.rand((x.shape[0], M + 2), generator=gen,
                                           device=dev)
        grid[:, 1] = x[:, 7]              # a candidate equal to an element
        return grid[:, 1:-1]

    shapes = [(PATH_B, PATH_V, PATH_M), (PATH_B, PATH_V, 1), (3, 1000, 31),
              (3, 257, 31), (3, 1000, 1)]

    # K2: multi_count, exact
    err = 0.0
    for B, V, M in shapes:
        x = logits(B, V)
        taus = between(x, M)
        got, want = mc.multi_count_cuda(x, taus), mc.multi_count_plain(x, taus)
        check(torch.equal(got, want), f"K2 differs at {(B, V, M)}")
        err = max(err, (got - want).abs().max().item())
    x = logits(PATH_B, PATH_V)
    taus = between(x, PATH_M)
    n_bytes = 4 * (x.numel() + 2 * taus.numel())
    rows["multi_count"] = dict(
        source="src/repro_torch/kernels/csrc/multi_count.cu",
        replaces="src/repro/kernels/multi_count.py:69", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_count(x, taus)),
        call_ms=call_ms(lambda: ops.multi_count(x, taus)),
        plain_ms=device_ms(lambda: mc.multi_count_plain(x, taus)),
        probe_ms=device_ms(lambda: ops.multi_count(x, taus[:, :1])),
        bound=bound_ms(n_bytes, 2 * x.numel() * PATH_M), library_ms=None)

    # K3: runahead_topk_threshold, exact against plain and the generic loop
    kw = dict(k_target=40, rounds=8, spec_k=5)
    err = 0.0
    for B, V, _ in shapes:
        x = logits(B, V)
        got = rt.runahead_topk_threshold_cuda(x, **kw)
        want = rt.runahead_topk_threshold_plain(x, **kw)
        prob = solver.problem("count_above", x, backend="hopper", k=40)
        loop = solver._solve_rounds(prob.multi_eval, prob.lo0, prob.hi0,
                                    rounds=8, spec_k=5, sign_lo=prob.sign_lo)
        for g, w, l in zip(got, want, loop):
            check(torch.equal(g, w), f"K3 differs from plain at {(B, V)}")
            check(torch.equal(g, l), f"K3 differs from the loop at {(B, V)}")
            err = max(err, (g - w).abs().max().item())
    # rows holding NaN (one lane; every lane): (NaN, NaN), as the plain
    # version and the reference give
    x = logits(PATH_B, PATH_V)
    x[1, 40] = float("nan")
    x[2] = float("nan")
    got = rt.runahead_topk_threshold_cuda(x, **kw)
    want = rt.runahead_topk_threshold_plain(x, **kw)
    for g, w in zip(got, want):
        check(torch.equal(g.isnan(), w.isnan())
              and torch.equal(g[~g.isnan()].view(torch.int32),
                              w[~w.isnan()].view(torch.int32))
              and bool(g[1:3].isnan().all()),
              f"K3 differs from plain on NaN rows: {g.tolist()} vs "
              f"{w.tolist()}")
    x = logits(PATH_B, PATH_V)
    # the work the bracket needs: min, max, the sign at lo0, and one count
    # per step of the serial bisection it equals bit for bit (the other
    # 2**spec_k - 1 - spec_k candidates of a round are runahead's spare work)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    clusters, size = rt.cluster_geometry(PATH_B, PATH_V)
    k3_ms = device_ms(lambda: ops.runahead_topk_threshold(x, **kw))
    topk_ms = device_ms(lambda: torch.topk(x, 40, dim=-1))
    other = 8 if clusters == 16 else 16
    ms_other = device_ms(lambda: rt.runahead_topk_threshold_cuda(
        x, clusters=other, **kw))
    rows["runahead_topk_threshold"] = dict(
        source="src/repro_torch/kernels/csrc/runahead_threshold.cu",
        replaces="src/repro/kernels/runahead_threshold.py:123",
        max_abs_err=err, ms=k3_ms,
        call_ms=call_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
        plain_ms=device_ms(
            lambda: rt.runahead_topk_threshold_plain(x, **kw), calls=2),
        bound=bound_ms(4 * (x.numel() + 2 * PATH_B), 2 * x.numel() * n_cmp),
        library_ms=topk_ms,
        note=f"a cluster of {clusters} CTAs per row, {size} elements "
             f"({size * 4 / 1024:.1f} KiB) of shared memory each: "
             f"{PATH_B * clusters} CTAs of the card's 132 SMs for "
             f"B={PATH_B}; {k3_ms / topk_ms:.3f}x torch.topk; {other} CTAs "
             f"a row {ms_other:.4f} ms; rows holding NaN (one lane, a whole "
             f"row) give (NaN, NaN) as the plain version")

    # K4: multi_mass, tolerance and bit-stable run to run
    err = 0.0
    for B, V, M in shapes:
        p = torch.softmax(logits(B, V), dim=-1)
        taus = between(p, M)
        taus[:, -1] = 0.0                 # the engine's probe point (tau = 0)
        got = mm.multi_mass_cuda(p, taus)
        check(torch.equal(got, mm.multi_mass_cuda(p, taus)),
              f"K4 not bit-stable at {(B, V, M)}")
        want = mm.multi_mass_plain(p, taus)
        check(torch.allclose(got, want, **TOL), f"K4 differs at {(B, V, M)}")
        err = max(err, (got - want).abs().max().item())
    p = torch.softmax(logits(PATH_B, PATH_V), dim=-1)
    taus = between(p, PATH_M)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = max_sm_clock_hz()
    nb = row_reduce.blocks_per_row(PATH_B, PATH_V, sms)
    one = _one_kernel(lambda: ops.multi_mass(p, taus), "multi_mass_kernel")
    grid = (f"one launch per call ({one}); grid {PATH_B * nb} blocks of "
            f"{row_reduce.THREADS} ({nb} a row) on {sms} SMs")
    check(replay_equals_eager(lambda: mm.multi_mass_cuda(p, taus)),
          "K4 differs between eager and CUDA-graph replay")
    pairs = p.numel() * PATH_M
    # a compare, a select and an add a pair, one FP32 lane each
    issue_ms = 3 * pairs / (sms * FP32_LANES * f_sm) * 1e3
    rows["multi_mass"] = dict(
        source="src/repro_torch/kernels/csrc/multi_mass.cu",
        replaces="src/repro/kernels/multi_mass.py:65", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_mass(p, taus)),
        call_ms=call_ms(lambda: ops.multi_mass(p, taus)),
        plain_ms=device_ms(lambda: mm.multi_mass_plain(p, taus)),
        probe_ms=device_ms(lambda: ops.multi_mass(p, taus[:, :1])),
        bound=bound_ms(4 * (p.numel() + 2 * taus.numel()), 3 * pairs),
        library_ms=None,
        note=f"{grid}; eager == graph replay bit for bit; instruction "
             f"issue of 3 a pair {issue_ms:.6f} ms ({FP32_LANES} FP32 lanes "
             f"x {sms} SMs at {f_sm / 1e9:.3f} GHz); " + _stage_note(
                 row_reduce.stage_times("multi_mass", p, taus, 1)))

    # K5: multi_entropy_moments, tolerance and bit-stable run to run
    err = 0.0
    for B, V, M in shapes:
        x = logits(B, V)
        z = x - x.amax(-1, keepdim=True)
        grid = torch.exp(torch.empty((B, M + 2), device=dev).uniform_(
            -3.0, 3.0, generator=gen))
        grid[:, -2] = 20.0                # the engine's bracket (t_hi)
        grid[:, 1] = 0.05                 # (t_lo)
        ts = grid[:, 1:-1]
        got = me.multi_entropy_moments_cuda(z, ts)
        again = me.multi_entropy_moments_cuda(z, ts)
        want = me.multi_entropy_moments_plain(z, ts)
        for g, a, w in zip(got, again, want):
            check(torch.equal(g, a), f"K5 not bit-stable at {(B, V, M)}")
            check(torch.allclose(g, w, **TOL), f"K5 differs at {(B, V, M)}")
            err = max(err, (g - w).abs().max().item())
    x = logits(PATH_B, PATH_V)
    z = x - x.amax(-1, keepdim=True)
    ts = torch.exp(torch.empty((PATH_B, PATH_M + 2), device=dev).uniform_(
        -3.0, 3.0, generator=gen))[:, 1:-1]
    check(replay_equals_eager(lambda: me.multi_entropy_moments_cuda(z, ts)),
          "K5 differs between eager and CUDA-graph replay")
    pairs = z.numel() * PATH_M
    # one exponential a pair on the SFU, and 4 FP32 flops (a multiply, an
    # add, an FMA); the larger bounds
    sfu_ms = pairs / (sms * SFU_PER_CLOCK * f_sm) * 1e3
    fp32 = bound_ms(4 * (z.numel() + 3 * ts.numel()), 4 * pairs)
    one = _one_kernel(lambda: ops.multi_entropy_moments(z, ts),
                      "multi_entropy_kernel")
    grid = (f"one launch per call ({one}); grid {PATH_B * nb} blocks of "
            f"{row_reduce.THREADS} ({nb} a row) on {sms} SMs")
    rows["multi_entropy_moments"] = dict(
        source="src/repro_torch/kernels/csrc/multi_entropy.cu",
        replaces="src/repro/kernels/multi_entropy.py:84", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_entropy_moments(z, ts)),
        call_ms=call_ms(lambda: ops.multi_entropy_moments(z, ts)),
        plain_ms=device_ms(lambda: me.multi_entropy_moments_plain(z, ts)),
        probe_ms=device_ms(lambda: ops.multi_entropy_moments(z, ts[:, :1])),
        bound=max((sfu_ms, "operations"), fp32), library_ms=None,
        note=f"{grid}; eager == graph replay bit for bit; bound: one "
             f"exponential a pair at the SFU's {SFU_PER_CLOCK} a clock per "
             f"SM ({sms} SMs at {f_sm / 1e9:.3f} GHz) {sfu_ms:.6f} ms, "
             f"beside 4 FP32 flops a pair and the bytes {fp32[0]:.6f} ms "
             f"({fp32[1]}); " + _stage_note(
                 row_reduce.stage_times("multi_entropy", z, ts, 2)))

    rows["runahead_topk_threshold"]["library"] = "torch.topk"
    rows.update(_rows_k1(gen))
    rows.update(_rows_k6(gen))
    rows.update(_rows_k7(gen))
    for name, r in rows.items():
        say(f"phase 3 {name}: parity ok (max_abs_err {r['max_abs_err']:.3g}) "
            f"| device {r['ms']:.4f} ms per call ({r['call_ms']:.4f} ms with "
            f"the host's launch), plain {r['plain_ms']:.4f} ms, bound "
            + (f"{r['latency_bound'][0]:.6f} ms (latency; the operations "
               f"bound {r['bound'][0]:.6f} ms)" if "latency_bound" in r else
               f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
            + (f", {r['library']} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + (f" | M=1 probe device {r['probe_ms']:.4f} ms"
               if "probe_ms" in r else "")
            + (f" | {r['note']}" if "note" in r else ""))
    return rows


def _rows_k1(gen):
    """K1 against its plain version, bit for bit, at every point count a
    runahead round of the paper path uses (1 serial, up to 31 at k=5)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import taylor_eval as te

    for M in (1, 7, 31):
        for terms in (10, K1_TERMS):
            x = torch.rand((M,), generator=gen, device="cuda") + 1.0
            got = te.taylor_sincos_cuda(x, terms=terms)
            check(torch.equal(got, te.taylor_sincos_plain(x, terms=terms)),
                  f"K1 differs from its plain version at M={M}, "
                  f"terms={terms}")
    x = torch.rand((31,), generator=gen, device="cuda") + 1.0
    x1 = x[:1].clone()
    steps = 2 * (K1_TERMS - 1)
    # operations: per term and recurrence a multiply, a division, an add
    # and the two-operation denominator
    n_ops = 5 * steps * x.numel()
    # latency: each point is one chain of `steps` steps of K1_CHAIN_DEPTH
    # dependent operations of FMA_LATENCY cycles at the card's top SM clock
    f_sm = max_sm_clock_hz()
    lat_ms = steps * K1_CHAIN_DEPTH * FMA_LATENCY / f_sm * 1e3
    ms = device_ms(lambda: ops.taylor_sincos_eval(x, terms=K1_TERMS), calls=5)
    ms1 = device_ms(lambda: ops.taylor_sincos_eval(x1, terms=K1_TERMS),
                    calls=5)
    old_ms = [device_ms(lambda z=z: te.taylor_sincos_reference_cuda(
        x, terms=K1_TERMS, zero_shortcut=z), calls=2, reps=3)
        for z in (False, True)]
    fma = te.fma_latency_cycles()
    return {"taylor_sincos_eval": dict(
        source="src/repro_torch/kernels/csrc/taylor_eval.cu",
        replaces="src/repro/kernels/taylor_eval.py:61", max_abs_err=0.0,
        ms=ms, call_ms=call_ms(
            lambda: ops.taylor_sincos_eval(x, terms=K1_TERMS), reps=5),
        plain_ms=device_ms(lambda: te.taylor_sincos_plain(x, terms=K1_TERMS),
                           calls=1, reps=3),
        bound=bound_ms(8 * x.numel(), n_ops), library_ms=None,
        latency_bound=(lat_ms, "latency"),
        note=f"M=31, terms={K1_TERMS}: {ms / steps * 1e6:.2f} ns per "
             f"dependent term against the latency bound's "
             f"{lat_ms / steps * 1e6:.2f} ({K1_CHAIN_DEPTH} x {FMA_LATENCY} "
             f"cycles at {f_sm / 1e9:.3f} GHz; measured FMA latency "
             f"{fma:.2f} cycles); M=1 (a serial step) device {ms1:.4f} ms; "
             f"the first version's division (an __fdiv_rn a step) "
             f"{old_ms[0]:.4f} ms, with a zero numerator skipping it "
             f"{old_ms[1]:.4f} ms")}


def _k6_inputs(gen, shape, dtype):
    """Random pools, a table of distinct page ids (0 is the null page and
    is never named), positions and roped-like queries for K6."""
    import torch

    B, P, C, L = shape["B"], shape["P"], shape["C"], shape["L"]
    chain = -(-C // P)
    n_pages = B * chain + 1
    pool = [torch.randn((n_pages, P, shape["nkv"], shape["hd"]),
                        generator=gen, device="cuda").to(dtype)
            for _ in range(2)]
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:B * chain].reshape(B, chain).int()
    pos = torch.tensor(shape["pos"], dtype=torch.int32, device="cuda")
    q = torch.randn((B, L, shape["nq"], shape["hd"]), generator=gen,
                    device="cuda").to(dtype)
    return pool[0], pool[1], table, pos, q


def _rows_k6(gen):
    """K6 against its plain version at the served decode shape and at the
    edge shape, f32 and bf16 pools; timed at the served shape in bf16."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attend as pa
    from repro_torch.models.attention import _paged_slot_mask, paged_view

    err = 0.0
    for shape in (K6_PATH, K6_MASKED, K6_EDGE):
        for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                           (torch.bfloat16, dict(rtol=1e-2, atol=1e-2))):
            args = _k6_inputs(gen, shape, dtype)
            got = pa.paged_attend_cuda(*args, context=shape["C"])
            check(torch.equal(got, pa.paged_attend_cuda(
                *args, context=shape["C"])),
                  f"K6 not bit-stable at {shape}, {dtype}")
            want = pa.paged_attend_plain(*args, context=shape["C"])
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"K6 differs from its plain version at {shape}, {dtype}")
            err = max(err, (got.float() - want.float()).abs().max().item())
    sh = K6_PATH
    pk, pv, table, pos, q = args = _k6_inputs(gen, sh, torch.bfloat16)
    C, P = sh["C"], sh["P"]
    # the pages this run's data needs: those holding positions <= pos + L-1
    pages = sum(min(table.shape[1], -(-(p + sh["L"]) // P))
                for p in sh["pos"])
    page_bytes = P * sh["nkv"] * sh["hd"] * 2 * 2           # K and V, bf16
    n_bytes = 2 * q.numel() * 2 + pages * page_bytes
    n_ops = 4 * sh["L"] * sh["nq"] * sh["hd"] * sum(
        min(C, p + sh["L"]) for p in sh["pos"])
    # the yardstick: SDPA over the already-gathered dense view, same mask
    # (the gather is not timed)
    k = paged_view(pk, table, C).transpose(1, 2)            # (B,nkv,C,hd)
    v = paged_view(pv, table, C).transpose(1, 2)
    pgrid = pos.long()[:, None] + torch.arange(sh["L"], device="cuda")
    mask = _paged_slot_mask(pgrid, C)[:, None]              # (B,1,L,C)
    qs = q.transpose(1, 2)                                  # (B,nq,L,hd)
    rep = sh["nq"] // sh["nkv"]
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, kr, vr, attn_mask=mask, scale=1.0 / math.sqrt(sh["hd"]))
    return {"paged_attend": dict(
        source="src/repro_torch/kernels/csrc/paged_attend.cu",
        replaces="src/repro/kernels/paged_attend.py:131", max_abs_err=err,
        ms=device_ms(lambda: ops.paged_attend(*args, context=C)),
        call_ms=call_ms(lambda: ops.paged_attend(*args, context=C)),
        plain_ms=device_ms(lambda: pa.paged_attend_plain(*args, context=C),
                           calls=2),
        bound=bound_ms(n_bytes, n_ops), library_ms=device_ms(sdpa),
        library="F.scaled_dot_product_attention (gathered view, gather "
                "not timed)",
        note=f"{pages} pages read, {n_bytes / 1e6:.2f} MB")}


def _k7_inputs(gen, shape, dtype):
    import torch

    B, S, D = shape["B"], shape["S"], shape["D"]
    return [torch.randn((B, S, h, D), generator=gen, device="cuda").to(dtype)
            for h in (shape["H"], shape["Hk"], shape["Hk"])]


def _rows_k7(gen):
    """K7 against its plain version at the training shape in f32 at JAX's
    own K7 tolerance and at the ragged banded shape in f32; in bf16 at the
    training shape by ``flash_fwd.bf16_check`` (its largest |diff| from
    the f32 reference on the same inputs at most the bf16 plain version's
    plus one bf16 ulp, and element by element against the bf16 plain
    version at the kernel's key tile); bit-stable run to run; timed at
    the training shape, with SDPA on the same inputs as the yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_fwd as ff
    from repro_torch.kernels import ops

    errs = {}
    for name, shape, dtype in (("path f32", K7_PATH, torch.float32),
                               ("path bf16", K7_PATH, torch.bfloat16),
                               ("edge f32", K7_EDGE, torch.float32)):
        q, k, v = _k7_inputs(gen, shape, dtype)
        kw = dict(window=shape["window"], n_rep=shape["H"] // shape["Hk"])
        got = ff.flash_fwd_cuda(q, k, v, **kw)
        check(torch.equal(got, ff.flash_fwd_cuda(q, k, v, **kw)),
              f"K7 not bit-stable at {shape}, {dtype}")
        want = ff.flash_fwd_plain(q, k, v, **kw)
        errs[name] = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            check(torch.allclose(got, want, rtol=1e-4, atol=2e-5),
                  f"K7 differs from its plain version at {shape}: max "
                  f"|diff| {errs[name]:.3g}")
            continue
        accuracy = ff.bf16_check(got, q, k, v, **kw)
        check(accuracy.ok,
              f"K7 bf16 less accurate than its plain version at {shape}: "
              f"{accuracy}")
    sh = K7_PATH
    q, k, v = _k7_inputs(gen, sh, torch.bfloat16)
    n_rep = sh["H"] // sh["Hk"]
    B, S, H, Hk, D = sh["B"], sh["S"], sh["H"], sh["Hk"], sh["D"]
    # the causal half of QK^T and of PV: 4 flops per (query, key <= query,
    # dim); Q, K, V read once and O written once, in bf16
    n_ops = 4 * B * H * D * S * (S + 1) / 2
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hk * D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    ms = device_ms(lambda: ops.flash_fwd(q, k, v, n_rep=n_rep), calls=5,
                   reps=3)
    return {"flash_fwd": dict(
        source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_fwd.py:82",
        max_abs_err=max(errs.values()),
        ms=ms, call_ms=call_ms(lambda: ops.flash_fwd(q, k, v, n_rep=n_rep),
                               reps=5),
        plain_ms=device_ms(lambda: ff.flash_fwd_plain(q, k, v, n_rep=n_rep),
                           calls=1, reps=3),
        bound=bound_ms(n_bytes, n_ops, BF16_OPS_PER_S),
        library_ms=device_ms(sdpa, calls=5, reps=3),
        library="F.scaled_dot_product_attention(is_causal, enable_gqa)",
        note=f"B={B} S={S} H={H}/{Hk} D={D} bf16: {n_ops / 1e9:.1f} GFLOP, "
             f"{n_ops / ms / 1e9:.1f} TFLOP/s achieved; bf16 {accuracy}; "
             f"max |diff| from the plain version "
             + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))}


def phase_solves(gen):
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = torch.randn((PATH_B, PATH_V), generator=gen, device=dev) * 2.0
    probs = torch.softmax(x, dim=-1)
    k_rows = torch.tensor([1, 40, 300, 5000], device=dev)
    cases = [("count_above", x, dict(k=40)),
             ("count_above", x, dict(k=k_rows)),
             ("mass_at_or_above", probs, dict(p=0.9)),
             ("entropy_at_temperature", x, dict(target=3.0)),
             ("count_below", x, dict(q=0.3))]
    torch.cuda.synchronize()
    ops.reset_launches()
    out = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kind, operand, params in cases:
            out.append(solver.solve_kind(kind, operand, backend="hopper",
                                         rounds=8, spec_k=5, **params))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(ops.LAUNCHES)
    for (kind, operand, params), (lo, hi) in zip(cases, out):
        rlo, rhi = solver.solve_kind(kind, operand, backend="torch",
                                     rounds=8, spec_k=5, **params)
        if kind.startswith("count"):
            check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
                  f"{kind} bracket differs from the torch backend")
        else:
            check(torch.allclose(lo, rlo, rtol=1e-4, atol=1e-6)
                  and torch.allclose(hi, rhi, rtol=1e-4, atol=1e-6),
                  f"{kind} bracket differs from the torch backend")
    solver_kernels = ("multi_count", "runahead_topk_threshold", "multi_mass",
                      "multi_entropy_moments")
    check(all(launches[name] > 0 for name in solver_kernels),
          f"a solver kernel did not run in the solves: {launches}")
    say(f"phase 4 solves: {len(cases)} hopper solves with no host sync, "
        f"brackets match the torch backend | launches {launches}")
    return launches


def phase_serve():
    """serve.main's two steps, kept apart so that phase 7 can run the same
    session again: setup (flags, weights on the card), then run (prompts
    and generate, timed)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    session = serve.setup(SERVE_ARGV)
    torch.cuda.synchronize()
    ops.reset_launches()
    served = serve.run(session)
    launches = dict(ops.LAUNCHES)
    toks = served.tokens
    check(tuple(toks.shape) == (4, NEW_TOKENS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < 151936)).all()), "token out of range")
    check(launches["runahead_topk_threshold"] >= NEW_TOKENS
          and launches["multi_mass"] >= 9 * NEW_TOKENS
          and launches["multi_entropy_moments"] >= 9 * NEW_TOKENS,
          f"main path did not go through K3-K5: {launches}")
    n_tok = toks.numel()
    say(f"phase 5 serve: qwen3-4b full width, {n_tok} tokens in "
        f"{served.seconds:.3f}s = {n_tok / served.seconds:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)} (first call incl.) | launches "
        f"{launches} | row 0: {toks[0].tolist()}")
    return launches, session


def phase_reference(gen):
    import dataclasses

    import torch

    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import generate
    from repro_torch.serving.sampler import SamplerConfig, masked_logits

    dev = torch.device("cuda")
    x = torch.randn((PATH_B, PATH_V), generator=gen, device=dev) * 3.0
    sc = SamplerConfig(top_k=40, top_p=0.9, target_entropy=3.0)
    zh = masked_logits(x, dataclasses.replace(sc, backend="hopper"))
    zt = masked_logits(x, sc)
    check(torch.equal(zh > -1e29, zt > -1e29), "sampler masks differ")
    check(torch.allclose(zh, zt, rtol=1e-4, atol=1e-5),
          "masked logits differ")

    cfg = reduced_config("qwen3-4b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, torch.float32)
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=dev)
    streams = [generate(cfg, params, prompt, 8, None,
                        sampler=SamplerConfig(greedy=True, top_k=8,
                                              backend=be),
                        compute_dtype=torch.float32)
               for be in ("hopper", "torch")]
    check(torch.equal(*streams), "greedy streams differ between backends")
    say(f"phase 6 reference: masked logits (4, {PATH_V}) hopper == torch "
        f"(masks equal, max |diff| "
        f"{(zh - zt).abs().max().item():.3g}); reduced qwen3-4b greedy "
        f"streams equal")


def profiled(run):
    """run() under torch.profiler: (its result, device busy ms, wall ms
    traced, the device kernels' key averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return out, busy_ms, wall_ms, kernels


def say_profile(phase: str, busy_ms: float, wall_ms: float, kernels,
                per: str = "") -> None:
    if not kernels:
        say(f"{phase} profile: the profiler recorded no device time "
            "(not measured)")
        return
    say(f"{phase} profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"traced wall (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{sum(e.count for e in kernels)} kernel launches{per}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


SAMPLER_KERNELS = (("K3", "runahead_topk"), ("K4", "multi_mass_kernel"),
                   ("K5", "multi_entropy_kernel"))


def say_kernel_times(phase: str, kernels, busy_ms: float) -> None:
    """Each sampler kernel's device time under the profiler, its share of
    the device's busy time, and its time a call."""
    for label, key in SAMPLER_KERNELS:
        sel = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        n = sum(e.count for e in sel)
        say(f"{phase} profile: {label} {ms:.2f} ms of {busy_ms:.1f} ms device "
            f"busy ({ms / busy_ms:.4f}), {ms / max(1, n):.4f} ms per call "
            f"({n} calls)")


def phase_warm(session):
    """The one-shot serve.run on phase 5's session again, warm (nothing
    built or loaded for the first time), then once more under
    torch.profiler: device busy time and idle share, and the kernels that
    take the most device time."""
    import torch

    from repro_torch.launch import serve

    warm_s = serve.run(session).seconds
    _, busy_ms, wall_ms, kernels = profiled(lambda: serve.run(session))
    n_tok = session.args.batch * session.args.new_tokens
    say(f"phase 7 warm serve: {n_tok} tokens in {warm_s:.3f}s = "
        f"{n_tok / warm_s:.1f} tok/s on {torch.cuda.get_device_name(0)}")
    say_profile("phase 7", busy_ms, wall_ms, kernels)
    if kernels:
        say_kernel_times("phase 7", kernels, busy_ms)


def phase_paper():
    """launch.paper's main on the card, then one serial and one runahead
    solve per k with host syncs forbidden, counting K1's launches."""
    import torch

    from repro_torch.core.bisect import find_root_serial
    from repro_torch.core.runahead import find_root_runahead
    from repro_torch.kernels import ops
    from repro_torch.launch import paper

    torch.cuda.synchronize()
    ops.reset_launches()
    rows = paper.main([])
    launches = dict(ops.LAUNCHES)
    check(launches["taylor_sincos_eval"] > 0 and sum(launches.values())
          == launches["taylor_sincos_eval"],
          f"the paper path did not run through K1 alone: {launches}")
    for fig in ("fig4", "fig7"):
        say(f"phase 8 paper {fig}: terms, n, k, threads, rounds, serial ms, "
            f"runahead ms, speed-up (round-count ideal)")
        for r in rows:
            if r.fig == fig:
                say(f"  {r.terms:6d} {r.n:3d} {r.k:2d} {2 ** r.k - 1:3d} "
                    f"{r.rounds:3d} {r.serial_ms:9.3f} {r.runahead_ms:9.3f} "
                    f"{r.speedup:6.2f}x ({r.n / r.rounds:.2f}x)")
    f = paper.evaluator(K1_TERMS)
    a, b = paper.interval("cuda")
    n = paper.FIG4_N
    counts = []
    for k in (None,) + paper.FIG4_KS:
        torch.cuda.synchronize()
        ops.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            root = (find_root_serial(f, a, b, n, "signbit") if k is None
                    else find_root_runahead(f, a, b, n, k))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = ops.LAUNCHES["taylor_sincos_eval"]
        want = n + 1 if k is None else -(-n // k) + 1
        check(got == want, f"K1 launched {got} times in a solve at k={k}, "
                           f"expected {want}")
        check(root.item() == rows[0].root, f"root differs at k={k}")
        counts.append(got)
    say(f"phase 8 paper: runahead == serial bit for bit at every (terms, k); "
        f"no host sync in the solves; K1 launches per solve, serial then "
        f"k=1..5: {counts} | launches {launches}")
    return launches


def phase_continuous():
    """launch.serve --continuous at full width on a paged cache through
    K6: counts, timings, a profiled second run, and sync-free steps."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    session = serve.setup(CONT_ARGV)
    torch.cuda.synchronize()
    ops.reset_launches()
    served = serve.run_continuous(session)
    launches = dict(ops.LAUNCHES)
    s = served.scheduler
    n_layers = session.cfg.n_layers
    n_samples = s.n_decode_steps + s.n_admissions
    check(len(served.completions) == 8, "not every request was served")
    check(launches["paged_attend"] == n_layers * s.n_decode_steps,
          f"K6 launched {launches['paged_attend']} times for "
          f"{s.n_decode_steps} decode steps of {n_layers} layers")
    check(launches["runahead_topk_threshold"] == n_samples
          and launches["multi_mass"] == 9 * n_samples
          and launches["multi_entropy_moments"] == 9 * n_samples,
          f"the samples did not go through K3-K5 as expected "
          f"({n_samples} samples): {launches}")
    n_tok = sum(len(c.tokens) for c in served.completions)
    lat = sorted(c.latency_s for c in served.completions)
    say(f"phase 9 continuous: qwen3-4b full width, 8 requests / {n_tok} "
        f"tokens in {served.seconds:.3f}s = {n_tok / served.seconds:.1f} "
        f"tok/s on {torch.cuda.get_device_name(0)} (first run) | "
        f"{s.n_decode_steps} decode steps, {s.n_admissions} admissions, "
        f"{s.n_host_syncs} host syncs ({s.n_host_syncs / s.n_decode_steps:.2f}"
        f" per step) | latency p50 {lat[len(lat) // 2] * 1e3:.0f} ms, max "
        f"{lat[-1] * 1e3:.0f} ms | peak {s.peak_pages} pages | launches "
        f"{launches}")

    warm = serve.run_continuous(session)
    n_tok = sum(len(c.tokens) for c in warm.completions)
    lat = sorted(c.latency_s for c in warm.completions)
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    say(f"phase 9 continuous warm: {n_tok} tokens in {warm.seconds:.3f}s = "
        f"{n_tok / warm.seconds:.1f} tok/s, {warm.scheduler.n_decode_steps} "
        f"steps ({warm.seconds / warm.scheduler.n_decode_steps * 1e3:.1f} ms "
        f"per step incl. admissions), latency p50 "
        f"{lat[len(lat) // 2] * 1e3:.0f} ms p99 {p99 * 1e3:.0f} ms")
    traced, busy_ms, wall_ms, kernels = profiled(
        lambda: serve.run_continuous(session))
    say_profile("phase 9", busy_ms, wall_ms, kernels,
                f"; {traced.scheduler.n_decode_steps} decode steps")
    k6 = [e for e in kernels if "paged_" in e.key]
    if kernels:
        k6_ms = sum(e.self_device_time_total for e in k6) / 1e3
        n_k6 = n_layers * traced.scheduler.n_decode_steps
        say(f"phase 9 profile: K6 (split and combine kernels) {k6_ms:.1f} ms "
            f"of {busy_ms:.1f} ms device busy ({k6_ms / busy_ms:.3f}), "
            f"{k6_ms / max(1, n_k6):.4f} ms per call ({n_k6} calls)")
        say_kernel_times("phase 9", kernels, busy_ms)

    # the device part of a step never syncs; the token read stays outside
    server = serve.server_for(session)
    for r in serve.continuous_requests(session.cfg, session.args,
                                       session.sampler)[:4]:
        server.submit(r)
    server._admit_pending()
    sched = server.scheduler
    for _ in range(3):
        sched._ensure_step_args()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            nxt = sched.step_device()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sched.commit(nxt)
    say("phase 9 continuous: 3 paged decode steps (K6, sample_slots) ran "
        "under set_sync_debug_mode('error'); one token read per step")
    return launches


def _screened_prompts(cfg, params, n: int, S: int, n_new: int, gen):
    """n prompts of S tokens whose greedy one-shot streams keep a top-1 /
    top-2 logit gap above 1e-2 at every step (f32: far above the 1e-5 by
    which the paged paths may differ)."""
    import torch

    from repro_torch.models.decode import decode_step, prefill

    cand = torch.randint(0, cfg.vocab, (4 * n, S), generator=gen,
                         device="cuda")
    logits, cache = prefill(cfg, params, cand, S + n_new,
                            compute_dtype=torch.float32)
    ok = torch.ones(cand.shape[0], dtype=torch.bool, device="cuda")
    for i in range(n_new):
        top2 = logits.topk(2, dim=-1).values
        ok &= top2[:, 0] - top2[:, 1] > 1e-2
        if i < n_new - 1:
            logits, cache = decode_step(cfg, params, logits.argmax(-1), S + i,
                                        cache, compute_dtype=torch.float32)
    rows = ok.nonzero()[:, 0].tolist()[:n]
    check(len(rows) == n, f"only {len(rows)} screened prompts")
    return cand[rows].tolist()


def phase_continuous_reference(gen):
    """On reduced qwen3-4b (f32, the unembedding sharpened toward a fixed
    successor token to widen greedy margins, prompts screened for ties):
    paged continuous streams through K6 equal those through the gather,
    and each equals its request's one-shot stream."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import (
        Request,
        RunaheadServer,
        generate_oneshot_reference,
    )

    cfg = reduced_config("qwen3-4b")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, torch.float32)
    perm = torch.randperm(cfg.vocab_padded, generator=g, device="cuda")
    params["unembed"] = params["unembed"] + 2.0 * params["embed"][perm].T
    context, n_new = 24, [5, 3, 1, 7, 4, 6]
    prompts = _screened_prompts(cfg, params, len(n_new), 6, max(n_new), g)
    reqs = [Request(i, p, n_new[i], seed=i,
                    sampler=SamplerConfig(greedy=True), arrival=i // 2)
            for i, p in enumerate(prompts)]
    streams = {}
    for impl in ("hopper", "gather"):
        ops.reset_launches()
        srv = RunaheadServer(cfg, params, n_slots=2, context=context,
                             page_size=5, page_impl=impl,
                             cache_dtype=torch.float32,
                             compute_dtype=torch.float32)
        streams[impl] = {c.rid: c.tokens for c in srv.run(reqs)}
        check((ops.LAUNCHES["paged_attend"] > 0) == (impl == "hopper"),
              f"K6 launches with impl {impl}: {ops.LAUNCHES}")
    check(streams["hopper"] == streams["gather"],
          "paged K6 streams differ from the gather's")
    for r in reqs:
        one = generate_oneshot_reference(cfg, params, r, context=context,
                                         compute_dtype=torch.float32)
        check(streams["hopper"][r.rid] == one,
              f"request {r.rid}: continuous {streams['hopper'][r.rid]} != "
              f"one-shot {one}")
    say(f"phase 10 continuous reference: reduced qwen3-4b, {len(reqs)} "
        f"screened greedy requests on 2 slots, page 5: K6 streams == gather "
        f"streams == one-shot per request; first tokens "
        f"{[streams['hopper'][r.rid][:3] for r in reqs]}")


def phase_train():
    """launch.train's main in-process at internlm2-1.8b's full width:
    losses, K7 and K2 launches per step, step time, tokens per second,
    peak memory, and the last step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    per_step, prof = [], {}

    def on_step(step, metrics):
        # launches of this step; the profiler brackets TRAIN_PROFILED_STEP
        per_step.append(dict(ops.LAUNCHES))
        if step == TRAIN_PROFILED_STEP - 1:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == TRAIN_PROFILED_STEP:
            torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    out = train.main(TRAIN_ARGV, on_step=on_step)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    check(len(losses) == 6 and all(map(math.isfinite, losses)),
          f"training losses not all finite: {losses}")
    n_layers = 24
    prev = {name: 0 for name in launches}
    for i, snap in enumerate(per_step):
        k7 = snap["flash_fwd"] - prev["flash_fwd"]
        k2 = snap["multi_count"] - prev["multi_count"]
        check(k7 == 2 * n_layers, f"step {i}: K7 launched {k7} times, "
                                  f"expected {2 * n_layers}")
        check(k2 > 0, f"step {i}: the quantile clip did not launch K2")
        prev = snap
    timed = out["step_seconds"][1:TRAIN_PROFILED_STEP]
    ms = statistics.median(timed) * 1e3
    n_tok = 2 * 4096
    say(f"phase 11 train: internlm2-1.8b full width (24 layers, d_model "
        f"2048, GQA 16/8, vocab 92544), batch 2 x 4096, remat, quantile "
        f"clip | losses {[round(x, 4) for x in losses]} | warm-up step "
        f"{out['step_seconds'][0] * 1e3:.0f} ms, steps 1-4 "
        f"{[round(t * 1e3, 1) for t in timed]} ms, median {ms:.1f} ms = "
        f"{n_tok / ms * 1e3:.0f} tok/s | peak memory {peak_gb:.2f} GB | "
        f"K7 {2 * n_layers} and K2 {per_step[0]['multi_count']} launches per "
        f"step | launches {launches}")
    p = prof["p"]
    kernels = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    say_profile("phase 11", busy_ms, prof["wall_ms"], kernels,
                f"; one step (step {TRAIN_PROFILED_STEP})")
    k7_ms = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_" in e.key) / 1e3
    if kernels:
        say(f"phase 11 profile: K7 {k7_ms:.1f} ms of {busy_ms:.1f} ms device "
            f"busy ({k7_ms / busy_ms:.3f}), {k7_ms / (2 * n_layers):.3f} ms "
            f"per call | by group: "
            + ", ".join(f"{g} {ms_:.1f} ms ({n_} launches)" for g, (ms_, n_)
                        in _kernel_groups(kernels).items()))
    return launches


def _kernel_groups(kernels) -> dict:
    """Device time and launches by kind of kernel: the hand-written ones,
    f32 GEMMs (the chunked flash_attend's einsums in the attention
    backward), the other GEMMs (the model's bf16 matmuls), elementwise
    and copy kernels, reductions, the rest."""
    groups = {}
    for e in kernels:
        key = e.key
        if "flash_fwd_" in key:
            g = "K7"
        elif "multi_count" in key:
            g = "K2"
        elif "sgemm" in key:
            g = "f32 GEMM"
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "cublas")):
            g = "other GEMM"
        elif any(w in key for w in ("elementwise", "copy", "Copy")):
            g = "elementwise"
        elif "reduce" in key.lower():
            g = "reduction"
        else:
            g = "other"
        ms_, n_ = groups.get(g, (0.0, 0))
        groups[g] = (ms_ + e.self_device_time_total / 1e3, n_ + e.count)
    return dict(sorted(groups.items(), key=lambda kv: -kv[1][0]))


def _capture_log(name: str):
    import logging

    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Handler()
    logging.getLogger(name).addHandler(handler)
    return lines, handler


def phase_fault():
    """Reduced internlm2-1.8b on the card: killed at step 7 in a
    subprocess, resumed from step_5 in-process; the resumed losses and
    final checkpoint equal an uninterrupted run's."""
    import json as _json
    import logging
    import os
    import tempfile

    from repro_torch.launch import train

    src = Path(__file__).resolve().parent / "src"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        killed, straight = os.path.join(tmp, "killed"), os.path.join(
            tmp, "straight")
        env = dict(os.environ, PYTHONPATH=str(src))
        died = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *FAULT_ARGV,
             "--ckpt-dir", killed, "--die-at-step", "7"],
            capture_output=True, text=True, env=env, timeout=600)
        check(died.returncode == 42, f"the killed run exited "
              f"{died.returncode}, not 42: {died.stderr[-2000:]}")
        check("step_5" in os.listdir(killed), f"no step_5 after the kill: "
              f"{os.listdir(killed)}")
        lines, handler = _capture_log("repro_torch.train")
        try:
            resumed = train.main(FAULT_ARGV + ["--ckpt-dir", killed])
        finally:
            logging.getLogger("repro_torch.train").removeHandler(handler)
        check("resumed from checkpoint step 5" in lines,
              f"the rerun did not resume from step 5: {lines[:3]}")
        check("step_10" in os.listdir(killed), "no final step_10")
        whole = train.main(FAULT_ARGV + ["--ckpt-dir", straight])

        def hashes(d):
            with open(os.path.join(d, "step_10", "manifest.json")) as f:
                return {k: v["sha256"] for k, v in
                        _json.load(f)["leaves"].items()}

        same_state = hashes(killed) == hashes(straight)
        check(resumed["losses"] == whole["losses"][5:],
              f"resumed losses {resumed['losses']} != uninterrupted "
              f"{whole['losses'][5:]}")
        check(same_state, "the resumed run's final checkpoint differs from "
                          "the uninterrupted run's")
    say(f"phase 12 fault: reduced internlm2-1.8b killed at step 7 (exit 42, "
        f"step_5 on disk), resumed from step 5; losses 5-9 "
        f"{resumed['losses']} equal the uninterrupted run's bit for bit, and "
        f"so does the final step_10 checkpoint (every leaf's sha256)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = phase_kernels(gen)
    solve_launches = phase_solves(gen)
    serve_launches, session = phase_serve()
    phase_reference(gen)
    phase_warm(session)
    del session
    launches_by_path = {"solves": solve_launches, "serve": serve_launches,
                        "paper": phase_paper(),
                        "continuous": phase_continuous()}
    phase_continuous_reference(gen)
    launches_by_path["train"] = phase_train()
    phase_fault()

    # the path whose run each kernel's launch count is read on: K2 is not
    # on the static-k serving path (phase 4's engine solves launch it)
    paths = {"taylor_sincos_eval": "paper", "multi_count": "solves",
             "paged_attend": "continuous", "flash_fwd": "train"}
    kernels = []
    for name, r in rows.items():
        path = paths.get(name, "serve")
        launches = launches_by_path[path][name]
        check(launches > 0, f"{name} was not launched on its path {path}")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], path=path, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
        if "latency_bound" in r:
            kernels[-1]["latency_bound_ms"] = r["latency_bound"][0]
    say(f"total {time.perf_counter() - t0:.1f}s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
