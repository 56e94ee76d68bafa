"""K3: fused multi-round runahead top-k threshold, by hand in CUDA.

Replaces the Pallas kernel ``runahead_topk_threshold`` (``src/repro/
kernels/runahead_threshold.py:123``): per row, the ``(lo, hi)`` bracket of
the k-th largest value after ``rounds`` rounds of ``2**spec_k``-way
runahead bisection, all rounds in one launch.  The kernel is
``csrc/runahead_threshold.cu``: one thread-block cluster per row, each CTA
holding a slice of the row in shared memory (``cluster_geometry``); it
equals the generic engine loop over K2 bit for bit.
``runahead_topk_threshold_plain`` is the plain PyTorch version, a
step-for-step transcription of the TPU kernel's body;
``runahead_topk_threshold_clustered`` emulates the kernel's counting (per
slice, by binary search over the grid and a suffix sum of bins) on any
device, so the CPU tests hold that scheme against the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_SPEC_K = 8        # the kernel's shared-memory grid holds 2**8 + 1 points
MAX_CLUSTERS = 16     # CTAs of one cluster (above 8: non-portable size)
PORTABLE_CLUSTERS = 8
SLICE_MAX = 44032     # elements one CTA holds (227 KB of shared memory)
MIN_SLICE = 4096      # fewer elements a CTA are not worth a cluster
CARD_SMS = 132        # the H100's SMs: B * 16 CTAs up to this take 16 a row


def _slice(V: int, clusters: int) -> int:
    """Elements of each CTA's slice: ceil(V / clusters), rounded up to a
    multiple of 4 (so every slice of an aligned row starts aligned)."""
    return (-(-V // clusters) + 3) // 4 * 4


def cluster_geometry(B: int, V: int) -> tuple[int, int]:
    """(clusters, slice) for K3 on a (B, V) operand: a pure function of the
    shape.  A row is spread over CTAs of at least ``MIN_SLICE`` elements,
    up to 16 while the B rows' clusters fit the card's SMs one CTA each,
    else up to 8 (a round's fixed cost is paid per CTA, so at large B
    fewer, fuller CTAs win); and over more where a slice would not fit one
    CTA's shared memory."""
    if not 1 <= B <= 65535 or V < 1:
        raise ValueError(f"K3 takes 1..65535 rows of at least one element, "
                         f"got ({B}, {V})")
    spread = MAX_CLUSTERS if B * MAX_CLUSTERS <= CARD_SMS else PORTABLE_CLUSTERS
    clusters = 1
    while clusters < spread and clusters * MIN_SLICE < V:
        clusters *= 2
    while _slice(V, clusters) > SLICE_MAX:
        if clusters == MAX_CLUSTERS:
            raise ValueError(
                f"V = {V} does not fit K3's cluster: {MAX_CLUSTERS} CTAs of "
                f"{SLICE_MAX} elements (227 KB of shared memory each) hold "
                f"V <= {MAX_CLUSTERS * SLICE_MAX}")
        clusters *= 2
    return clusters, _slice(V, clusters)


def _grid(lo: torch.Tensor, hi: torch.Tensor, spec_k: int) -> torch.Tensor:
    """(B, n + 1) midpoint grid, level by level as the TPU kernel builds it."""
    n = 1 << spec_k
    pts = [None] * (n + 1)
    pts[0], pts[n] = lo, hi
    for level in range(1, spec_k + 1):
        d = 1 << (spec_k - level)
        for m in range(d, n, 2 * d):
            pts[m] = (pts[m - d] + pts[m + d]) / 2
    return torch.stack(pts, dim=1)


def runahead_topk_threshold_plain(x: torch.Tensor, *, k_target: int,
                                  rounds: int = 8, spec_k: int = 5
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each (B,), bracketing the k-th largest value of each row."""
    x = x.float()
    n = 1 << spec_k
    kf = torch.full((), k_target, dtype=torch.float32, device=x.device)

    def sign(tau):                   # bit of f(tau) = k - count(row > tau)
        return (kf - (x > tau[:, None]).sum(dim=-1).float()) < 0

    lo = x.amin(dim=-1) - 1.0
    hi = x.amax(dim=-1) + 1.0
    sl = sign(lo)
    for _ in range(rounds):
        pts_vec = _grid(lo, hi, spec_k)                      # (B, n + 1)
        sign_vec = torch.stack(
            [sl] + [sign(pts_vec[:, m]) for m in range(1, n)], dim=1)
        li = torch.zeros_like(lo, dtype=torch.int64)
        hi_i = torch.full_like(li, n)
        s_cur = sign_vec[:, 0]
        for _ in range(spec_k):
            mid = (li + hi_i) // 2
            s_m = torch.gather(sign_vec, 1, mid[:, None])[:, 0]
            go_left = s_cur != s_m
            hi_i = torch.where(go_left, mid, hi_i)
            li = torch.where(go_left, li, mid)
            s_cur = torch.where(go_left, s_cur, s_m)
        lo = torch.gather(pts_vec, 1, li[:, None])[:, 0]
        hi = torch.gather(pts_vec, 1, hi_i[:, None])[:, 0]
        sl = torch.gather(sign_vec, 1, li[:, None])[:, 0]
    return lo, hi


def runahead_topk_threshold_clustered(x: torch.Tensor, *, k_target: int,
                                      rounds: int = 8, spec_k: int = 5,
                                      clusters: int | None = None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's scheme in PyTorch: each row split into the
    kernel's ``clusters`` slices; per slice, min and max (NaN if the slice
    holds one, as the kernel's NaN flag makes them), and per round the bin
    b'(x) = #{m < n : x > pts[m]} of every element (0 if not above lo, n
    if above hi, else 1 + a spec_k-step binary search over pts[1..n-1]), a
    histogram of the bins and its suffix sum; the slices' counts summed,
    then the serial-exact walk.  Rows whose grid is not non-decreasing
    (NaN midpoints, and every point of a row holding NaN) are counted
    directly, as the kernel counts them.  Equals
    ``runahead_topk_threshold_plain`` bit for bit, NaN payloads apart: a
    row holding a NaN gets (NaN, NaN) from both."""
    x = x.float()
    B, V = x.shape
    if clusters is None:
        clusters, size = cluster_geometry(B, V)
    else:
        size = _slice(V, clusters)
    n = 1 << spec_k
    kf = torch.full((), k_target, dtype=torch.float32, device=x.device)
    slices = [x[:, q * size:(q + 1) * size] for q in range(clusters)]
    inf = torch.tensor(float("inf"), device=x.device)
    mins = [seg.amin(-1) if seg.shape[1] else inf.expand(B)
            for seg in slices]
    maxs = [seg.amax(-1) if seg.shape[1] else (-inf).expand(B)
            for seg in slices]
    lo = torch.stack(mins).amin(0) - 1.0
    hi = torch.stack(maxs).amax(0) + 1.0
    rows = torch.arange(B, device=x.device)[:, None]
    sl = None
    for r in range(rounds):
        pts = _grid(lo, hi, spec_k)                             # (B, n + 1)
        monotone = (pts[:, :-1] <= pts[:, 1:]).all(dim=1)
        counts = torch.zeros((B, n), dtype=torch.int64, device=x.device)
        for seg in slices:
            pos = torch.zeros(seg.shape, dtype=torch.int64, device=x.device)
            step = n >> 1
            while step:
                pos += (seg > pts[rows, pos + step]).long() * step
                step >>= 1
            above_lo = seg > lo[:, None]
            b = torch.where(above_lo & (seg > hi[:, None]), n, pos + 1)
            b = torch.where(above_lo, b, 0)
            hist = torch.zeros((B, n + 1), dtype=torch.int64, device=x.device)
            hist.scatter_add_(1, b, torch.ones_like(b))
            suffix = hist.flip(1).cumsum(1).flip(1)           # sum of bins >= j
            counts += suffix[:, 1:]
        if not monotone.all():
            direct = (x[:, None, :] > pts[:, :n, None]).sum(dim=-1)
            counts = torch.where(monotone[:, None], counts, direct)
        signs = (kf - counts.float()) < 0                       # (B, n)
        if r == 0:
            sl = signs[:, 0]
        sign_vec = torch.cat([sl[:, None], signs[:, 1:]], dim=1)
        li = torch.zeros_like(lo, dtype=torch.int64)
        hi_i = torch.full_like(li, n)
        s_cur = sign_vec[:, 0]
        for _ in range(spec_k):
            mid = (li + hi_i) // 2
            s_m = torch.gather(sign_vec, 1, mid[:, None])[:, 0]
            go_left = s_cur != s_m
            hi_i = torch.where(go_left, mid, hi_i)
            li = torch.where(go_left, li, mid)
            s_cur = torch.where(go_left, s_cur, s_m)
        lo = torch.gather(pts, 1, li[:, None])[:, 0]
        hi = torch.gather(pts, 1, hi_i[:, None])[:, 0]
        sl = torch.gather(sign_vec, 1, li[:, None])[:, 0]
    return lo, hi


@functools.cache
def _entry():
    lib = build.library("runahead_threshold")
    fn = lib.runahead_topk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.runahead_topk_failed_step.restype = ctypes.c_char_p
    if (lib.runahead_topk_max_spec_k(), lib.runahead_topk_max_clusters(),
            lib.runahead_topk_slice_max()) != (MAX_SPEC_K, MAX_CLUSTERS,
                                               SLICE_MAX):
        raise RuntimeError("csrc/runahead_threshold.cu and the geometry "
                           "constants of runahead_threshold.py disagree")
    return lib, fn


def runahead_topk_threshold_cuda(x: torch.Tensor, *, k_target: int,
                                 rounds: int = 8, spec_k: int = 5,
                                 clusters: int | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on a CUDA tensor x (B, V) f32 -> (lo, hi), each (B,) f32.
    ``clusters`` (CTAs per row) defaults to ``cluster_geometry``'s; the
    tests set it to reach ragged and empty slices."""
    build.check_rows(x, "x")
    if not 1 <= spec_k <= MAX_SPEC_K:
        raise ValueError(f"spec_k must be in [1, {MAX_SPEC_K}] (the kernel's "
                         f"shared grid holds 2**{MAX_SPEC_K} + 1 points), "
                         f"got {spec_k}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    B, V = x.shape
    if clusters is None:
        clusters, size = cluster_geometry(B, V)
    elif not 1 <= clusters <= MAX_CLUSTERS or _slice(V, clusters) > SLICE_MAX:
        raise ValueError(f"clusters must be in [1, {MAX_CLUSTERS}] with "
                         f"slices of at most {SLICE_MAX} elements, got "
                         f"{clusters} for V = {V}")
    else:
        size = _slice(V, clusters)
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        out = torch.empty((2, B), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), x.stride(0), out[0].data_ptr(),
                 out[1].data_ptr(), B, V, int(k_target), rounds, spec_k,
                 clusters, size, build.stream_ptr(x))
        if err != 0:
            step = lib.runahead_topk_failed_step().decode()
            build.check_launch(lib, err, f"runahead_topk_threshold ({step}, "
                                         f"{clusters} CTAs of {size})")
        return out[0], out[1]
