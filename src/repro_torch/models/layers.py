"""Shared layers: norms, RoPE, MLPs, embeddings (port of ``repro.models.layers``).

Conventions kept from the JAX package:
  * params are nested dicts of tensors; weights are ``(d_in, d_out)``, and
    ``lead`` prepends stacking axes (a run's leading layer axis);
  * compute runs in the activations' dtype, norms and logits in f32.

Initialisation draws from an explicit ``torch.Generator`` on the target
device with the JAX shapes and scale; it does not reproduce JAX's numbers
(tests carry JAX weights across with ``repro_torch.convert``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict
DEFAULT_INIT_SCALE = 0.02
NEG_INF = -1e30


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, lead: tuple = ()) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32, then cast (as ``layers.py:20``)."""
    scale = DEFAULT_INIT_SCALE if scale is None else scale
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def init_norm(kind: str, d: int, dtype, device, lead: tuple = ()) -> Params:
    return (init_rmsnorm(d, dtype, device, lead) if kind == "rmsnorm"
            else init_layernorm(d, dtype, device, lead))


def apply_norm(kind: str, params: Params, x: torch.Tensor, eps: float
               ) -> torch.Tensor:
    return rmsnorm(params, x, eps) if kind == "rmsnorm" else layernorm(params, x, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen, d: int, d_ff: int, dtype, lead: tuple = ()) -> Params:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, lead=lead),
        "w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
        "w_down": dense_init(gen, d_ff, d, dtype, lead=lead),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU.  On a rank's column blocks of ``w_gate`` / ``w_up`` and row
    block of ``w_down`` (the tensor-parallel layout) it returns that
    rank's partial sum of the output, which the caller joins over
    ``model``."""
    gate = x @ params["w_gate"].to(x.dtype)
    up = x @ params["w_up"].to(x.dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(x.dtype)


def init_gelu_mlp(gen, d: int, d_ff: int, dtype, lead: tuple = ()) -> Params:
    device = gen.device
    return {
        "w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
        "b_up": torch.zeros(lead + (d_ff,), dtype=dtype, device=device),
        "w_down": dense_init(gen, d_ff, d, dtype, lead=lead),
        "b_down": torch.zeros(lead + (d,), dtype=dtype, device=device),
    }


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ params["w_up"].to(x.dtype) + params["b_up"].to(x.dtype),
               approximate="tanh")
    return h @ params["w_down"].to(x.dtype) + params["b_down"].to(x.dtype)


def init_mlp(act: str, gen, d: int, d_ff: int, dtype, lead: tuple = ()
             ) -> Params:
    return (init_swiglu(gen, d, d_ff, dtype, lead) if act == "swiglu"
            else init_gelu_mlp(gen, d, d_ff, dtype, lead))


def apply_mlp(act: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(params, x) if act == "swiglu" else gelu_mlp(params, x)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, dtype) -> torch.Tensor:
    return dense_init(gen, vocab, d, dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, compute_dtype,
          tp=None) -> torch.Tensor:
    """The rows of ``tokens``.  Under the tensor-parallel layout (``tp``,
    a ``distributed/tp.py::TPRun``) ``table`` is this rank's block of
    vocab rows: a masked lookup of the tokens it holds (the others
    zero), joined over ``model`` by one sum, which leaves each row the
    one rank's exact value (under ``seq_sp`` a reduce-scatter: this
    rank's positions)."""
    if tp is None:
        return table.to(compute_dtype)[tokens]
    local = tokens - tp.layout.vocab_offset
    inside = (local >= 0) & (local < table.shape[0])
    rows = table.to(compute_dtype)[torch.where(inside, local, 0)]
    return tp.join(torch.where(inside[..., None], rows, 0))


def unembed(table: torch.Tensor, x: torch.Tensor, real_vocab: int | None = None,
            offset: int = 0) -> torch.Tensor:
    """Final projection to vocab logits in f32.

    When the table is lane-padded past `real_vocab`, the phantom columns
    are masked to NEG_INF so softmax and the sampler's solves never see
    them.  Under the tensor-parallel layout ``table`` is this rank's
    block of vocab columns, the first at global column ``offset``: the
    logits are that block, its phantom columns masked at their global
    index.
    """
    logits = (x @ table.to(x.dtype)).float()
    v = logits.shape[-1]
    if real_vocab is not None and real_vocab < offset + v:
        mask = offset + torch.arange(v, device=logits.device) < real_vocab
        logits = torch.where(mask, logits, NEG_INF)
    return logits
