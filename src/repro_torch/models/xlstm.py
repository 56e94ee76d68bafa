"""xLSTM blocks, sLSTM and mLSTM, for the xlstm-1.3b architecture (port of
``repro.models.xlstm``).

The xLSTM paper's 7:1 residual stack: one sLSTM block per ``slstm_every``
blocks (xlstm-1.3b: 48 blocks, every 8th an sLSTM).  ``d_ff = 0``: the
up/down projection lives inside each mixer (factor 2), there is no FFN.

mLSTM, matrix memory with exponential gating:
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (B, H, dk, dv)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))
with the log-space stabiliser m_t = max(log f_t + m_{t-1}, log i_t).  The
full sequence runs in CHUNK-sized blocks: a Python loop over chunks
carries the state (JAX's ``lax.scan``), and each chunk is the parallel
form over its own positions.  Padded steps past the sequence are identity
transitions (log f = 0, log i = -1e30), so the carried-out state is the
state after the last real step.

sLSTM, scalar memory per channel: a strictly serial recurrence, a loop
over time on gates whose projections are computed for the whole sequence
up front.  ``REPRO_SLSTM_NAIVE=1`` (JAX's A/B switch, read at each call)
keeps the projections inside the recurrence instead: per step (B, D) @
(D, D) matmuls, the same function.

Decode is an O(1) state update for both.  States are f32 whatever the
compute dtype; ``m`` starts at -1e30.
"""
from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.solver import true_div
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = dict
CHUNK = 64
M_INIT = -1e30       # the stabiliser before any step


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> Params:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim       # 4 heads x 512 for xlstm-1.3b
    d_in = h * hd
    return {
        "w_up": dense_init(gen, d, 2 * d_in, dtype, lead=lead),
        "w_q": dense_init(gen, d_in, d_in, dtype, lead=lead),
        "w_k": dense_init(gen, d_in, d_in, dtype, lead=lead),
        "w_v": dense_init(gen, d_in, d_in, dtype, lead=lead),
        "w_i": dense_init(gen, d_in, h, dtype, lead=lead),
        "w_f": dense_init(gen, d_in, h, dtype, lead=lead),
        "w_o": dense_init(gen, d_in, d_in, dtype, lead=lead),
        "w_down": dense_init(gen, d_in, d, dtype, lead=lead),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, dk, dv)
    n: torch.Tensor   # (B, H, dk)
    m: torch.Tensor   # (B, H) log-space stabiliser


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()) -> MLSTMState:
    h, hd = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros(lead + (batch, h, hd, hd), **f32),
        n=torch.zeros(lead + (batch, h, hd), **f32),
        m=torch.full(lead + (batch, h), M_INIT, **f32),
    )


def _mlstm_gates(p: Params, xm: torch.Tensor, H: int):
    """q, k, v, o: (B, S, H, hd); log i / log f gates: (B, S, H) f32."""
    B, S, d_in = xm.shape
    hd = d_in // H
    dt = xm.dtype
    q = (xm @ p["w_q"].to(dt)).reshape(B, S, H, hd)
    # JAX divides by sqrt(hd) rounded to the compute dtype
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt).item()
    k = true_div((xm @ p["w_k"].to(dt)).reshape(B, S, H, hd), root)
    v = (xm @ p["w_v"].to(dt)).reshape(B, S, H, hd)
    log_i = (xm @ p["w_i"].to(dt)).float()
    log_f = F.logsigmoid((xm @ p["w_f"].to(dt)).float())
    o = torch.sigmoid(xm @ p["w_o"].to(dt)).reshape(B, S, H, hd)
    return q, k, v, log_i, log_f, o


def _mlstm_chunk(state: MLSTMState, q, k, v, log_i, log_f, o):
    """One chunk: the intra-chunk parallel form plus the carried state.

    h_t = o_t * (sum_{s<=t} w_{t,s} v_s (k_s . q_t) + w0_t C0^T q_t) / den
    with w_{t,s} = exp(logF_t - logF_s + log i_s - m_t), the carry-in
    weight w0_t = exp(logF_t + m0 - m_t), logF the cumulative log forget
    gate within the chunk and m_t the running stabiliser (a ``cummax``).
    Returns (the state after the chunk, h (B, C, H, hd) in q's dtype).
    """
    c0, n0, m0 = state
    C = q.shape[1]
    logF = torch.cumsum(log_f, dim=1)                         # (B, C, H)
    a_s = log_i - logF                                        # source term
    run_max = torch.cummax(a_s, dim=1).values
    m_t = torch.maximum(logF + m0[:, None], logF + run_max)   # (B, C, H)
    w0 = torch.exp(logF + m0[:, None] - m_t)                  # carry-in
    src = torch.exp(a_s[:, None, :, :] + (logF - m_t)[:, :, None, :])
    tril = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    src = torch.where(tril[None, :, :, None], src, 0.0)       # (B, t, s, H)

    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bthd,bshd->btsh", qf, kf)
    num_intra = torch.einsum("btsh,bshd->bthd", scores * src, vf)
    num_carry = w0[..., None] * torch.einsum("bhkd,bthk->bthd", c0, qf)
    # the denominator's n_t = sum_s w_{t,s} k_s + w0 n0
    n_t = (torch.einsum("bshd,btsh->bthd", kf, src)
           + w0[..., None] * n0[:, None])
    denom = torch.maximum(torch.einsum("bthd,bthd->bth", n_t, qf).abs(),
                          torch.exp(-m_t))
    h = o.float() * ((num_intra + num_carry) / denom[..., None])

    # the chunk-final state, stabilised by m at the chunk's last step
    m_T = m_t[:, -1]
    wi = torch.exp(log_i + logF[:, -1:] - logF - m_T[:, None])  # (B, C, H)
    decay = torch.exp(logF[:, -1] + m0 - m_T)                   # (B, H)
    c_T = decay[..., None, None] * c0 + torch.einsum(
        "bshk,bshd->bhkd", wi[..., None] * kf, vf)
    n_T = decay[..., None] * n0 + torch.einsum("bsh,bshk->bhk", wi, kf)
    return MLSTMState(c=c_T, n=n_T, m=m_T), h.to(q.dtype)


def mlstm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence mLSTM block.  x: (B, S, D) -> (B, S, D) (and the
    state after the last step with ``return_state``)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    up = x @ p["w_up"].to(x.dtype)
    xm, z = up.chunk(2, dim=-1)
    pad = (-S) % CHUNK
    xm_p = F.pad(xm, (0, 0, 0, pad)) if pad else xm
    q, k, v, log_i, log_f, o = _mlstm_gates(p, xm_p, H)
    if pad:
        # padded steps: identity transitions (f = 1, i = 0)
        valid = (torch.arange(S + pad, device=x.device) < S)[None, :, None]
        log_f = torch.where(valid, log_f, 0.0)
        log_i = torch.where(valid, log_i, M_INIT)
    state = init_mlstm_state(cfg, B, x.device)
    hs = []
    for c0 in range(0, S + pad, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                log_i[:, sl], log_f[:, sl], o[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S + pad, H * cfg.head_dim)[:, :S]
    out = (h * F.silu(z)) @ p["w_down"].to(x.dtype)
    return (out, state) if return_state else out


def mlstm_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
               state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """One decode step (O(1) state update).  x: (B, 1, D).  Returns (out,
    the new state: fresh tensors, ``state`` is not written)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    up = x @ p["w_up"].to(x.dtype)
    xm, z = up.chunk(2, dim=-1)
    q, k, v, log_i, log_f, o = _mlstm_gates(p, xm, H)
    q, k, v, o = (t[:, 0] for t in (q, k, v, o))            # (B, H, hd)
    log_i, log_f = log_i[:, 0], log_f[:, 0]                 # (B, H)
    m_new = torch.maximum(log_f + state.m, log_i)
    fw = torch.exp(log_f + state.m - m_new)
    iw = torch.exp(log_i - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c = fw[..., None, None] * state.c + iw[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = fw[..., None] * state.n + iw[..., None] * kf
    num = torch.einsum("bhkd,bhk->bhd", c, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
    h = (o.float() * num / den[..., None]).to(x.dtype)
    h = h.reshape(B, 1, H * hd) * F.silu(z)
    return h @ p["w_down"].to(x.dtype), MLSTMState(c=c, n=n, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> Params:
    d = cfg.d_model
    return {
        "w_up": dense_init(gen, d, 2 * d, dtype, lead=lead),
        "w_z": dense_init(gen, d, d, dtype, lead=lead),
        "w_i": dense_init(gen, d, d, dtype, lead=lead),
        "w_f": dense_init(gen, d, d, dtype, lead=lead),
        "w_o": dense_init(gen, d, d, dtype, lead=lead),
        "w_down": dense_init(gen, d, d, dtype, lead=lead),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()) -> SLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    shape = lead + (batch, cfg.d_model)
    return SLSTMState(c=torch.zeros(shape, **f32),
                      n=torch.zeros(shape, **f32),
                      m=torch.full(shape, M_INIT, **f32))


def _slstm_gates(p: Params, xm: torch.Tensor):
    """Pre-activations (f32) for every position at once: the projections
    depend on the input only, so the recurrence itself is elementwise."""
    dt = xm.dtype
    z = torch.tanh((xm @ p["w_z"].to(dt)).float())
    log_i = (xm @ p["w_i"].to(dt)).float()
    log_f = F.logsigmoid((xm @ p["w_f"].to(dt)).float())
    o = torch.sigmoid((xm @ p["w_o"].to(dt)).float())
    return z, log_i, log_f, o


def _slstm_recurrence(z, log_i, log_f, o, state: SLSTMState):
    """One elementwise recurrence step on precomputed gates."""
    m_new = torch.maximum(log_f + state.m, log_i)
    fw = torch.exp(log_f + state.m - m_new)
    iw = torch.exp(log_i - m_new)
    c = fw * state.c + iw * z
    n = torch.maximum(fw * state.n + iw, torch.exp(-m_new))
    return o * c / n, SLSTMState(c=c, n=n, m=m_new)


def slstm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence sLSTM: gates for the whole sequence, then a loop over
    time (the serial part speculation cannot remove); with
    ``REPRO_SLSTM_NAIVE=1`` each step projects its own input."""
    up = x @ p["w_up"].to(x.dtype)
    xm, zg = up.chunk(2, dim=-1)
    state = init_slstm_state(cfg, x.shape[0], x.device)
    naive = os.environ.get("REPRO_SLSTM_NAIVE") == "1"
    gates = None if naive else _slstm_gates(p, xm)  # (B, S, D) each
    hs = []
    for t in range(x.shape[1]):
        g_t = (_slstm_gates(p, xm[:, t]) if naive
               else [g[:, t] for g in gates])
        h, state = _slstm_recurrence(*g_t, state)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype) * F.silu(zg)
    out = h @ p["w_down"].to(x.dtype)
    return (out, state) if return_state else out


def slstm_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
               state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """One decode step.  x: (B, 1, D).  Returns (out, the new state)."""
    up = x @ p["w_up"].to(x.dtype)
    xm, zg = up.chunk(2, dim=-1)
    h, state = _slstm_recurrence(*_slstm_gates(p, xm[:, 0]), state)
    h = h[:, None].to(x.dtype) * F.silu(zg)
    return h @ p["w_down"].to(x.dtype), state


class Mixer(NamedTuple):
    """An xLSTM block kind's functions: parameter init, full-sequence
    apply, decode step and state init."""
    init: Callable
    apply: Callable
    step: Callable
    init_state: Callable


MIXERS = {
    "mlstm": Mixer(init_mlstm, mlstm_apply, mlstm_step, init_mlstm_state),
    "slstm": Mixer(init_slstm, slstm_apply, slstm_step, init_slstm_state),
}
