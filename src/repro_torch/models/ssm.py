"""Selective SSM (Mamba-style) mixer, hymba's parallel head beside
attention (port of ``repro.models.ssm``).

The discretised selective state space:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D_skip * x_t
with input-dependent B_t, C_t and dt_t.

The full sequence runs in CHUNK-sized blocks: a Python loop over chunks
carries the (d_in, N) state (JAX's ``lax.scan``), and within a chunk the
linear recurrence composes as a scan over (decay, increment) pairs.  JAX
runs ``lax.associative_scan`` there; the port runs a Hillis-Steele scan,
log2(CHUNK) levels each combining every position with the one 2**l
before it.  Both compose the same pairs in another grouping, so the two
agree within float rounding, not bit for bit.  The decay's cumulative
product is never formed on its own (it underflows over a long chunk):
every level multiplies the running increment by the decay as it goes.
The selective terms are computed inside each chunk, never for the whole
sequence: (B, S, d_in, N) would not fit at a long prompt.  Padded steps
get decay 1 and increment 0, so the carried-out state is the state after
the last real step.

Decode is the O(1) recurrent step on the carried state.  The state holds
``h`` in f32 and the causal convolution's last ``ssm_conv - 1`` inputs
(``conv_buf``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = dict
CHUNK = 128


def init_ssm(gen, cfg: ModelConfig, dtype, d_in: int | None = None,
             lead: tuple = ()) -> Params:
    d = cfg.d_model
    d_in = d_in or cfg.n_heads * cfg.head_dim
    n = cfg.ssm_state
    device = gen.device
    # S4D-real initialisation for A (negative reals)
    a_init = torch.arange(1, n + 1, dtype=torch.float32,
                          device=device).expand(lead + (d_in, n))
    return {
        "w_x": dense_init(gen, d, d_in, dtype, lead=lead),
        "w_z": dense_init(gen, d, d_in, dtype, lead=lead),
        "conv": dense_init(gen, cfg.ssm_conv, d_in, dtype, lead=lead),
        "w_b": dense_init(gen, d_in, n, dtype, lead=lead),
        "w_c": dense_init(gen, d_in, n, dtype, lead=lead),
        "w_dt": dense_init(gen, d_in, 1, dtype, lead=lead),
        "dt_bias": torch.zeros(lead + (d_in,), dtype=dtype, device=device),
        "log_a": torch.log(a_init).to(dtype),
        "d_skip": torch.ones(lead + (d_in,), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_in, d, dtype, lead=lead),
    }


class SSMState(NamedTuple):
    h: torch.Tensor           # (B, d_in, N) recurrent state, f32
    conv_buf: torch.Tensor    # (B, ssm_conv - 1, d_in) causal conv tail


def init_ssm_state(cfg: ModelConfig, batch: int, d_in: int, dtype, device,
                   lead: tuple = ()) -> SSMState:
    return SSMState(
        h=torch.zeros(lead + (batch, d_in, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv_buf=torch.zeros(lead + (batch, cfg.ssm_conv - 1, d_in),
                             dtype=dtype, device=device),
    )


def _causal_conv(p: Params, xs: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv along time.  xs: (B, S, d_in); ``tail`` the
    previous ``W - 1`` inputs (zeros when None).  Returns (out, the new
    tail), in the promoted dtype of the two, as JAX's concatenate."""
    w = p["conv"].to(xs.dtype)                    # (W, d_in)
    W = w.shape[0]
    if tail is None:
        tail = xs.new_zeros((xs.shape[0], W - 1, xs.shape[2]))
    dt = torch.promote_types(tail.dtype, xs.dtype)
    xp = torch.cat([tail.to(dt), xs.to(dt)], dim=1)   # (B, S + W - 1, d_in)
    out = sum(xp[:, i:i + xs.shape[1]] * w[i] for i in range(W))
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return out, new_tail


def _selective_terms(p: Params, xc: torch.Tensor):
    """Per-step decay and increment, (B, S, d_in, N) f32 each, and C_t
    (B, S, N) in xc's dtype."""
    dt_ = xc.dtype
    bsel = xc @ p["w_b"].to(dt_)                  # (B, S, N)
    csel = xc @ p["w_c"].to(dt_)
    dt = F.softplus(xc @ p["w_dt"].to(dt_) + p["dt_bias"].to(dt_)).float()
    a = -torch.exp(p["log_a"].float())            # (d_in, N)
    decay = torch.exp(dt[..., None] * a)
    incr = (dt * xc.float())[..., None] * bsel.float()[:, :, None, :]
    return decay, incr, csel


def _chunk_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h -> a h + b, the
    earlier map applied first: (a, b) o (a', b') = (a a', a' b + b').
    Hillis-Steele: at offset d every position composes with the running
    map d positions before it."""
    n = a.shape[1]
    d = 1
    while d < n:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return a, b


def ssm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence (train / prefill) selective SSM.  x: (B, S, D)."""
    B, S, _ = x.shape
    xin = x @ p["w_x"].to(x.dtype)                # (B, S, d_in)
    z = x @ p["w_z"].to(x.dtype)
    xc, conv_tail = _causal_conv(p, xin, None)
    xc = F.silu(xc)
    d_in = xc.shape[2]
    h = torch.zeros((B, d_in, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        xc_c = xc[:, c0:c0 + CHUNK]
        n_valid = xc_c.shape[1]
        if n_valid < CHUNK:
            xc_c = F.pad(xc_c, (0, 0, 0, CHUNK - n_valid))
        dec, inc, cs = _selective_terms(p, xc_c)
        if n_valid < CHUNK:
            # padded steps are identity transitions (decay 1, increment
            # 0), or the carried-out state would decay past position S
            valid = (torch.arange(CHUNK, device=x.device)
                     < n_valid)[None, :, None, None]
            dec = torch.where(valid, dec, 1.0)
            inc = torch.where(valid, inc, 0.0)
        a_cum, b_cum = _chunk_scan(dec, inc)
        hs = a_cum * h[:, None] + b_cum             # (B, CHUNK, d_in, N)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cs.float()))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        return out, SSMState(h=h, conv_buf=conv_tail)
    return out


def ssm_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
             state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """One decode step.  x: (B, 1, D) -> (B, 1, D).  Returns (out, the new
    state: fresh tensors, ``state`` is not written)."""
    xin = x @ p["w_x"].to(x.dtype)                # (B, 1, d_in)
    z = x @ p["w_z"].to(x.dtype)
    xc, new_tail = _causal_conv(p, xin, state.conv_buf)
    xc = F.silu(xc)
    decay, incr, csel = _selective_terms(p, xc)   # (B, 1, d_in, N)
    h = state.h * decay[:, 0] + incr[:, 0]        # (B, d_in, N)
    y = torch.einsum("bdn,bn->bd", h, csel[:, 0].float())[:, None]
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["w_out"].to(x.dtype), SSMState(h=h, conv_buf=new_tail)
