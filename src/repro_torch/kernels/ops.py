"""Public wrappers of the hand-written kernels.

A wrapper takes the kernel's plain PyTorch version for tensors on the CPU
and launches the CUDA kernel for tensors on a CUDA device; anything else
raises.  There is no fallback: a CUDA tensor that the kernel cannot take
raises in the launcher.  ``LAUNCHES`` counts each wrapper's kernel
launches (plain integers, one per wrapper call that launched), so a run
can show that it went through the kernels; ``reset_launches`` zeroes them.

On the card every launch of K2-K6 takes its geometry from the tuner's
kernel tier (``core/tuning.py``, as JAX's ``kernels/ops.py`` does): a
``KernelKey`` of the call's shape, dtype and device resolves to a
``KernelDecision`` (blocks a row, CTAs a cluster, chain splits): today's
fixed geometry under ``tuning.disabled()`` and by default, unless the
tuning cache holds a winner for the key, which is replayed; a measured
winner under ``tuning.autotune()``.  The plain versions take no geometry,
so on the CPU nothing is decided.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tuning
from repro_torch.kernels import blocks
from repro_torch.kernels import flash_fwd as _ff
from repro_torch.kernels import multi_count as _mc
from repro_torch.kernels import multi_entropy as _me
from repro_torch.kernels import multi_mass as _mm
from repro_torch.kernels import paged_attend as _pa
from repro_torch.kernels import row_reduce as _rr
from repro_torch.kernels import runahead_threshold as _rt
from repro_torch.kernels import taylor_eval as _te

LAUNCHES: dict[str, int] = {
    "taylor_sincos_eval": 0,
    "multi_count": 0,
    "runahead_topk_threshold": 0,
    "multi_mass": 0,
    "multi_entropy_moments": 0,
    "paged_attend": 0,
    "flash_fwd": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU operands, False for CUDA ones; raises otherwise.
    Meta operands (shapes only: the dry run's trace, ``launch/cost.py``)
    count as CPU ones, so the trace runs the plain versions."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}):
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


# ---------------------------------------------------------------------------
# the kernel tier: KernelKey -> geometry of each launch on the card
# ---------------------------------------------------------------------------

# the row-reduction families' CUDA launchers, which take ``nb``
_ROW_REDUCE = {"multi_count": _mc.multi_count_cuda,
               "multi_mass": _mm.multi_mass_cuda,
               "multi_entropy_moments": _me.multi_entropy_moments_cuda}


def _decide(kernel: str, shape: tuple[int, ...], x: torch.Tensor,
            fixed: dict[str, int]) -> dict[str, int]:
    """The geometry of one launch on ``x``'s card (see the module
    docstring)."""
    key = tuning.KernelKey(
        kernel=kernel, shape=tuple(int(s) for s in shape),
        dtype=tuning.dtype_name(x.dtype),
        device_kind=tuning.device_kind(x.device))
    return tuning.decide_kernel(
        key, fixed=fixed,
        measure=lambda cands: _measure_kernel(key, cands, x.device)).params


def _kernel_operands(key: tuning.KernelKey, device: torch.device):
    """Synthetic operands of a kernel key's shape (seed 0) and the call of
    its launcher at given params: what the measured tier times."""
    rng = np.random.default_rng(0)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    if key.kernel in _ROW_REDUCE:
        B, V, M = key.shape
        x = rng.normal(size=(B, V)).astype(np.float32) * 2.0
        if key.kernel == "multi_mass":
            x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        if key.kernel == "multi_entropy_moments":
            x = x - x.max(-1, keepdims=True)
        second = np.tile(np.linspace(0.2, 2.0, M, dtype=np.float32),
                         (B, 1))
        x, second = dev(x), dev(second)
        launch = _ROW_REDUCE[key.kernel]
        return lambda p: launch(x, second, nb=p["nb"])
    if key.kernel == "runahead_topk":
        B, V = key.shape
        x = dev(rng.normal(size=(B, V)).astype(np.float32))
        return lambda p: _rt.runahead_topk_threshold_cuda(
            x, k_target=max(1, V // 8), rounds=8, spec_k=5,
            clusters=p["clusters"])
    B, nkv, n_chain, P, L, R, D = key.shape
    dtype = getattr(torch, key.dtype)
    n_pages = B * n_chain + 1
    pool_k = dev(rng.normal(size=(n_pages, P, nkv, D)), dtype)
    pool_v = dev(rng.normal(size=(n_pages, P, nkv, D)), dtype)
    table = dev(rng.permutation(n_pages - 1)[:B * n_chain].reshape(
        B, n_chain), torch.int32)
    context = n_chain * P
    pos = torch.full((B,), context - L, dtype=torch.int32, device=device)
    q = dev(rng.normal(size=(B, L, nkv * R, D)), dtype)
    return lambda p: _pa.paged_attend_cuda(
        pool_k, pool_v, table, pos, q, context=context,
        n_split=p["n_split"])


def _measure_kernel(key: tuning.KernelKey, candidates, device
                    ) -> list[float]:
    """Seconds of one launch at each candidate geometry on the live card:
    ``tuning.time_call`` (a CUDA graph of launches after an eager one,
    between CUDA events, the median of 5).  The candidates come from the
    tier's legal set; one that fails to launch raises.  Not counted in
    ``LAUNCHES``: the launchers are called directly."""
    tuning.check_not_capturing(f"kernel geometries for {key.cache_key()}")
    call = _kernel_operands(key, device)
    return [tuning.time_call(lambda p=dict(p): call(p), device)
            for p in candidates]


def multi_count(logits: torch.Tensor, taus: torch.Tensor,
                below: bool = False) -> torch.Tensor:
    """counts[b, m] = #{v : logits[b, v] > taus[b, m]} (f32); with
    ``below``, #{v : logits[b, v] < taus[b, m]}."""
    if _on_cpu(logits, taus):
        return _mc.multi_count_plain(logits, taus, below)
    B, V = logits.shape
    p = _decide("multi_count", (B, V, taus.shape[1]), logits,
                {"nb": _rr.blocks_per_row(B, V, _rr.sm_count(
                    logits.device.index))})
    out = _mc.multi_count_cuda(logits, taus, below, nb=p["nb"])
    LAUNCHES["multi_count"] += 1
    return out


def multi_mass(probs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[b, m] = sum of probs[b, v] where probs[b, v] >= taus[b, m]."""
    if _on_cpu(probs, taus):
        return _mm.multi_mass_plain(probs, taus)
    B, V = probs.shape
    p = _decide("multi_mass", (B, V, taus.shape[1]), probs,
                {"nb": _rr.blocks_per_row(B, V, _rr.sm_count(
                    probs.device.index))})
    out = _mm.multi_mass_cuda(probs, taus, nb=p["nb"])
    LAUNCHES["multi_mass"] += 1
    return out


def multi_entropy_moments(z_shifted: torch.Tensor, ts: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, w) accumulator pair for logits already shifted to max 0."""
    if _on_cpu(z_shifted, ts):
        return _me.multi_entropy_moments_plain(z_shifted, ts)
    B, V = z_shifted.shape
    p = _decide("multi_entropy_moments", (B, V, ts.shape[1]), z_shifted,
                {"nb": _rr.blocks_per_row(B, V, _rr.sm_count(
                    z_shifted.device.index))})
    out = _me.multi_entropy_moments_cuda(z_shifted, ts, nb=p["nb"])
    LAUNCHES["multi_entropy_moments"] += 1
    return out


def multi_entropy(logits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """H[b, m] = entropy of softmax(logits[b] / ts[b, m])."""
    z = logits.float()
    z = z - z.amax(dim=-1, keepdim=True)
    s, w = multi_entropy_moments(z, ts)
    return _me.entropy_from_moments(s, w)


def runahead_topk_threshold(logits: torch.Tensor, *, k_target: int,
                            rounds: int = 8, spec_k: int = 5
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-round runahead top-k bracket, one launch per call."""
    if _on_cpu(logits):
        return _rt.runahead_topk_threshold_plain(
            logits, k_target=k_target, rounds=rounds, spec_k=spec_k)
    B, V = logits.shape
    p = _decide("runahead_topk", (B, V), logits,
                {"clusters": _rt.cluster_geometry(B, V)[0]})
    out = _rt.runahead_topk_threshold_cuda(
        logits, k_target=k_target, rounds=rounds, spec_k=spec_k,
        clusters=p["clusters"])
    LAUNCHES["runahead_topk_threshold"] += 1
    return out


def taylor_sincos_eval(x: torch.Tensor, *, terms: int) -> torch.Tensor:
    """sin(cos(x)) by ``terms``-term Taylor series at every point of a
    (M,) vector, in float32: the paper's f, one launch per call."""
    if _on_cpu(x):
        return _te.taylor_sincos_plain(x, terms=terms)
    out = _te.taylor_sincos_cuda(x, terms=terms)
    LAUNCHES["taylor_sincos_eval"] += 1
    return out


def paged_attend(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 table: torch.Tensor, pos: torch.Tensor, q: torch.Tensor, *,
                 context: int) -> torch.Tensor:
    """Paged decode/verify attention, (B, L, n_heads, hd) in q's dtype."""
    if _on_cpu(pool_k, pool_v, table, pos, q):
        return _pa.paged_attend_plain(pool_k, pool_v, table, pos, q,
                                      context=context)
    nkv, D = pool_k.shape[2:]
    B, L, nq, _ = q.shape
    n_chain = table.shape[1]
    p = _decide("paged_attend",
                (B, nkv, n_chain, pool_k.shape[1], L, nq // nkv, D), q,
                {"n_split": _pa.split_geometry(B, nkv, n_chain)[0]})
    out = _pa.paged_attend_cuda(pool_k, pool_v, table, pos, q,
                                context=context, n_split=p["n_split"])
    LAUNCHES["paged_attend"] += 1
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, n_rep: int = 1) -> torch.Tensor:
    """Causal flash attention, (B, S, H, D) in q's dtype; k, v carry
    H // n_rep heads.  Differentiable: the backward is the chunked
    ``flash_attend``'s vjp at the JAX wrapper's fixed geometry, q chunk
    ``divisor_chunk(S, Q_CHUNK)`` and kv chunk ``divisor_chunk(S,
    KV_CHUNK)`` (the plain version's tiles too)."""
    on_cpu = _on_cpu(q, k, v)
    S = q.shape[1]
    out = _ff.FlashFwd.apply(q, k, v, window, n_rep,
                             blocks.divisor_chunk(S, blocks.Q_CHUNK),
                             blocks.divisor_chunk(S, blocks.KV_CHUNK))
    if not on_cpu:
        LAUNCHES["flash_fwd"] += 1
    return out
