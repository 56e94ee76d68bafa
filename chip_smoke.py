#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 is switched off for matmuls and cuDNN.
  2. the kernel build: every csrc/*.cu through nvcc, in parallel, timed.
  3. each kernel (K2-K5) against its plain PyTorch version on the card, at
     the sampler's shapes (B=4, V=151936, M=31 and M=1) and at ragged V
     (1000, 257): K2 and K3 bit for bit (K3 also against the generic
     engine loop over K2), K4 and K5 within rtol 1e-5 / atol 1e-6 and bit
     for bit run to run; device time per call (CUDA-graph replay between
     CUDA events, L2-warm) and time per eager call, beside the least time
     the card could take and, for K3, torch.topk's time; K2, K4 and K5 also
     at M=1, the engine's bracket-sign probe.
  4. one solve per kind on the "hopper" backend under
     torch.cuda.set_sync_debug_mode("error") (the round loop never syncs),
     including count_above with a (B,) k tensor, which runs K2 through the
     engine; brackets against the "torch" backend.
  5. the main path: repro_torch.launch.serve (setup, then run, as its
     main does) for qwen3-4b at full width (36 layers, d_model 2560, vocab
     151936; random bf16 weights from a seed), 4 x 16 tokens sampled with
     top-k 40, top-p 0.9 and target entropy 3.0 on the "hopper" backend;
     the launch counters must show K3 once per token and K4, K5 nine times
     per token.
  6. a reference check: the sampler's masked logits on both backends, and
     greedy generate on reduced qwen3-4b, "hopper" against "torch".
  7. the main path's serve.run on phase 5's session again, warm, timed,
     and once more under torch.profiler (device busy time, idle share, top
     kernels).

The line before the last is a JSON object listing the kernels, each with
the path its launch count was read on ("serve": phase 5; "solves": phase
4, for K2, which the static-k serve does not launch); the last
line is {"ok": true, "device": {...}}.  Nothing is printed as a result when
torch sees no CUDA device or the port's sources are not beside this file.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-6)
PATH_B, PATH_V, PATH_M = 4, 151936, 31
SERVE_ARGV = ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "64",
              "--new-tokens", "16", "--top-k", "40", "--top-p", "0.9",
              "--target-entropy", "3.0", "--backend", "hopper"]
NEW_TOKENS = 16


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.kernels import build

    seconds = build.build_all()
    say(f"phase 2 build: {len(build.SOURCES)} kernels in {seconds:.1f}s "
        f"(parallel nvcc, sm_90a)")
    for name in build.SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")


def phase_kernels(gen):
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import ops
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
    x = logits(PATH_B, PATH_V)
    # the work the bracket needs: min, max, the sign at lo0, and one count
    # per step of the serial bisection it equals bit for bit (the other
    # 2**spec_k - 1 - spec_k candidates of a round are runahead's spare work)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    rows["runahead_topk_threshold"] = dict(
        source="src/repro_torch/kernels/csrc/runahead_threshold.cu",
        replaces="src/repro/kernels/runahead_threshold.py:123",
        max_abs_err=err,
        ms=device_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
        call_ms=call_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
        plain_ms=device_ms(
            lambda: rt.runahead_topk_threshold_plain(x, **kw), calls=2),
        bound=bound_ms(4 * (x.numel() + 2 * PATH_B), 2 * x.numel() * n_cmp),
        library_ms=device_ms(lambda: torch.topk(x, 40, dim=-1)))

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
    rows["multi_mass"] = dict(
        source="src/repro_torch/kernels/csrc/multi_mass.cu",
        replaces="src/repro/kernels/multi_mass.py:65", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_mass(p, taus)),
        call_ms=call_ms(lambda: ops.multi_mass(p, taus)),
        plain_ms=device_ms(lambda: mm.multi_mass_plain(p, taus)),
        probe_ms=device_ms(lambda: ops.multi_mass(p, taus[:, :1])),
        bound=bound_ms(4 * (p.numel() + 2 * taus.numel()),
                       2 * p.numel() * PATH_M), library_ms=None)

    # K5: multi_entropy_moments, tolerance and bit-stable run to run
    err = 0.0
    for B, V, M in shapes:
        x = logits(B, V)
        z = x - x.amax(-1, keepdim=True)
        ts = torch.exp(torch.empty((B, M + 2), device=dev).uniform_(
            -3.0, 3.0, generator=gen))[:, 1:-1]
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
    rows["multi_entropy_moments"] = dict(
        source="src/repro_torch/kernels/csrc/multi_entropy.cu",
        replaces="src/repro/kernels/multi_entropy.py:84", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_entropy_moments(z, ts)),
        call_ms=call_ms(lambda: ops.multi_entropy_moments(z, ts)),
        plain_ms=device_ms(lambda: me.multi_entropy_moments_plain(z, ts)),
        probe_ms=device_ms(lambda: ops.multi_entropy_moments(z, ts[:, :1])),
        bound=bound_ms(4 * (z.numel() + 3 * ts.numel()),
                       5 * z.numel() * PATH_M), library_ms=None)

    for name, r in rows.items():
        say(f"phase 3 {name}: parity ok (max_abs_err {r['max_abs_err']:.3g}) "
            f"| device {r['ms']:.4f} ms per call ({r['call_ms']:.4f} ms with "
            f"the host's launch), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]})"
            + (f", torch.topk {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + (f" | M=1 probe device {r['probe_ms']:.4f} ms"
               if "probe_ms" in r else ""))
    return rows


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
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not run in the solves: {launches}")
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


def phase_warm(session):
    """The main path's serve.run on phase 5's session again, warm (nothing
    built or loaded for the first time), then once more under
    torch.profiler: device busy time and idle share, and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    warm_s = serve.run(session).seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = serve.run(session).seconds
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_tok = session.args.batch * session.args.new_tokens
    say(f"phase 7 warm serve: {n_tok} tokens in {warm_s:.3f}s = "
        f"{n_tok / warm_s:.1f} tok/s on {torch.cuda.get_device_name(0)}")
    if not kernels:
        say("phase 7 profile: the profiler recorded no device time "
            "(not measured)")
        return
    say(f"phase 7 profile: device busy {busy_ms:.1f} ms of {traced_s * 1e3:.1f}"
        f" ms traced wall (idle share {1 - busy_ms / (traced_s * 1e3):.3f}); "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


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

    kernels = []
    for name, r in rows.items():
        # K2 is not on the static-k serving path; its launches are the
        # engine solves' of phase 4
        path = "solves" if name == "multi_count" else "serve"
        launches = (solve_launches if path == "solves"
                    else serve_launches)[name]
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], path=path, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    say(f"total {time.perf_counter() - t0:.1f}s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
