"""Model assembly (port of ``repro.models.transformer``).

The layer stack is described by a LAYER PLAN: an ordered list of
``(block_kind, n_layers)`` runs, each run's parameters stacked along a
leading layer axis as in the JAX package.  A Python loop over that axis
replaces ``lax.scan``.  ``layer_plan`` covers every family (it is data);
``init_params`` and ``forward`` build and run the kinds of
``PORTED_KINDS`` (``ported_plan``) and raise ``ValueError`` for any
other.  Block kinds:

  dense          GQA attention + MLP
  moe            GQA attention + MoE FFN (``models/moe.py::moe_apply``);
                 ``forward`` sums its layers' load-balance losses as the
                 JAX scan carries them
  hymba_global   (full attention || SSM) + SwiGLU      (hymba, 3 layers)
  hymba_swa      (sliding-window attention || SSM) + SwiGLU  (the rest)
  mlstm / slstm  xLSTM mixers, no FFN                  (xlstm)
  whisper_dec    self-attention + cross-attention over the encoder
                 output + GELU MLP                     (whisper decoder)

whisper's encoder is ``params["encoder"]``: a stack of ``whisper_enc``
blocks (non-causal self-attention + GELU MLP) over the frames plus its
own learned positions, run by ``encode``; the decoder adds its learned
``pos_embed`` to the token embeddings (``cfg.learned_pos``: no RoPE).

A hymba block adds ``0.5 * (norm(attention) + norm(ssm))`` of the same
normed input (``models/ssm.py``); the xLSTM mixers are
``models/xlstm.py``'s.

``forward(remat=True)`` checkpoints each layer (non-reentrant
``torch.utils.checkpoint``, where JAX wraps the scan body in
``jax.checkpoint``): backward recomputes the layer from its input.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    dense_init,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    unembed,
)

Params = dict


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def hymba_global_layers(cfg: ModelConfig) -> tuple[int, ...]:
    if cfg.global_layers:
        return tuple(cfg.global_layers)
    return (0, cfg.n_layers // 2, cfg.n_layers - 1)


def layer_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Ordered (kind, count) runs covering all cfg.n_layers layers."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [("dense", L)]
    if cfg.family == "moe":
        return [("moe", L)]
    if cfg.family == "encdec":
        return [("whisper_dec", L)]
    if cfg.family == "hybrid":
        globs = set(hymba_global_layers(cfg))
        runs: list[tuple[str, int]] = []
        for i in range(L):
            kind = "hymba_global" if i in globs else "hymba_swa"
            if runs and runs[-1][0] == kind:
                runs[-1] = (kind, runs[-1][1] + 1)
            else:
                runs.append((kind, 1))
        return runs
    if cfg.family == "ssm":
        e = cfg.slstm_every or 8
        runs = []
        for i in range(L):
            kind = "slstm" if i % e == 0 else "mlstm"
            if runs and runs[-1][0] == kind:
                runs[-1] = (kind, runs[-1][1] + 1)
            else:
                runs.append((kind, 1))
        return runs
    raise ValueError(f"unknown family {cfg.family!r}")


PORTED_KINDS = ("dense", "moe", "hymba_global", "hymba_swa", "mlstm",
                "slstm", "whisper_dec")
HYMBA_KINDS = ("hymba_global", "hymba_swa")
XLSTM_KINDS = tuple(xlstm_lib.MIXERS)


def ported_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The layer plan, checked to hold only block kinds the port runs."""
    plan = layer_plan(cfg)
    for kind, _ in plan:
        if kind not in PORTED_KINDS:
            raise ValueError(
                f"block kind {kind!r} (family {cfg.family!r}) is not ported "
                f"yet; only {', '.join(map(repr, PORTED_KINDS))} runs are")
    return plan


def layer_unbind(tree, count: int) -> list:
    """Every layer of a run's stacked parameter (or cache) tree at once, as
    views: one ``unbind`` per leaf, so backward stacks the layers'
    gradients once instead of scattering each into a zeroed copy of the
    whole stack.  Dicts and (named) tuples keep their type per layer; a
    None field (an unquantized cache's scales) stays None."""
    if tree is None:
        return [None] * count
    if isinstance(tree, dict):
        per_key = {k: layer_unbind(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(count)]
    if isinstance(tree, tuple):
        per_field = [layer_unbind(v, count) for v in tree]
        return [type(tree)(*(f[i] for f in per_field)) for i in range(count)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_run(kind: str, cfg: ModelConfig, gen, dtype, count: int
              ) -> Params:
    """A run's parameters, the JAX ``_init_block`` tree of ``kind`` with
    the run's layer axis in front."""
    d, lead, dev = cfg.d_model, (count,), gen.device
    if kind in XLSTM_KINDS:
        return {"ln": init_norm(cfg.norm, d, dtype, dev, lead),
                kind: xlstm_lib.MIXERS[kind].init(gen, cfg, dtype, lead)}
    p = {
        "ln1": init_norm(cfg.norm, d, dtype, dev, lead),
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead),
    }
    if kind in HYMBA_KINDS:
        p["ssm"] = ssm_lib.init_ssm(gen, cfg, dtype, lead=lead)
        p["attn_norm"] = init_norm(cfg.norm, d, dtype, dev, lead)
        p["ssm_norm"] = init_norm(cfg.norm, d, dtype, dev, lead)
    p["ln2"] = init_norm(cfg.norm, d, dtype, dev, lead)
    if kind == "whisper_dec":
        p["xattn"] = attn_lib.init_attention(gen, cfg, dtype, lead,
                                             cross=True)
        p["ln3"] = init_norm(cfg.norm, d, dtype, dev, lead)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(cfg.act, gen, d, cfg.d_ff, dtype, lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                param_dtype=torch.float32) -> Params:
    """Full parameter tree on ``generator.device``; runs stacked along a
    leading layer axis.  Shapes and scale are the JAX package's
    (``unembed`` is ``(d_model, vocab_padded)``)."""
    runs = [_init_run(kind, cfg, generator, param_dtype, count)
            for kind, count in ported_plan(cfg)]
    p: Params = {
        "embed": init_embedding(generator, cfg.vocab_padded, cfg.d_model,
                                param_dtype),
        "runs": runs,
        "final_norm": init_norm(cfg.norm, cfg.d_model, param_dtype,
                                generator.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                  param_dtype)
    if cfg.learned_pos:
        p["pos_embed"] = init_embedding(generator, 32_768, cfg.d_model,
                                        param_dtype)
    if cfg.is_encdec:
        p["encoder"] = {
            "blocks": _init_run("whisper_enc", cfg, generator, param_dtype,
                                cfg.n_encoder_layers),
            "final_norm": init_norm(cfg.norm, cfg.d_model, param_dtype,
                                    generator.device),
            "pos_embed": init_embedding(generator, cfg.encoder_len,
                                        cfg.d_model, param_dtype),
        }
    return p


def unembed_table(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def apply_ffn(cfg: ModelConfig, p: Params, h: torch.Tensor, *,
              capacity_mode: str = "fifo", moe_groups: int = 1):
    """A block's MLP or MoE on its normed input: (out, MoEStats or None)."""
    if "moe" not in p:
        return apply_mlp(cfg.act, p["mlp"], h), None
    return moe_lib.moe_apply(p["moe"], cfg, h, capacity_mode=capacity_mode,
                             n_groups=moe_groups)


def hymba_window(kind: str, cfg: ModelConfig) -> int:
    """The attention window of a hymba block: 0 (full) for a global
    layer, ``cfg.sliding_window`` for the others."""
    return 0 if kind == "hymba_global" else cfg.sliding_window


def hymba_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
              a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x + 0.5 (norm(a) + norm(s)), then the block's MLP: the rest of a
    hymba block once its attention ``a`` and SSM ``s`` outputs exist."""
    eps = cfg.norm_eps
    a = apply_norm(cfg.norm, p["attn_norm"], a, eps)
    s = apply_norm(cfg.norm, p["ssm_norm"], s, eps)
    x = x + 0.5 * (a + s)
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    return x + apply_mlp(cfg.act, p["mlp"], h)


def _apply_block(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, capacity_mode: str = "fifo",
                 moe_groups: int = 1,
                 encoder_out: torch.Tensor | None = None):
    """One block of ``kind`` over the full sequence: (x, the MoE layer's
    aux loss, a 0-d f32 tensor; None for any other block).
    ``encoder_out`` is what a ``whisper_dec`` block cross-attends to."""
    eps = cfg.norm_eps
    if kind in XLSTM_KINDS:
        h = apply_norm(cfg.norm, p["ln"], x, eps)
        return x + xlstm_lib.MIXERS[kind].apply(p[kind], cfg, h), None
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    if kind in HYMBA_KINDS:
        a = attn_lib.attend(p["attn"], cfg, h, positions,
                            window=hymba_window(kind, cfg))
        s = ssm_lib.ssm_apply(p["ssm"], cfg, h)
        return hymba_mix(cfg, p, x, a, s), None
    x = x + attn_lib.attend(p["attn"], cfg, h, positions,
                            causal=kind != "whisper_enc")
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    if kind == "whisper_dec":
        x = x + attn_lib.attend(p["xattn"], cfg, h, positions, causal=False,
                                kv_src=encoder_out)
        h = apply_norm(cfg.norm, p["ln3"], x, eps)
    out, stats = apply_ffn(cfg, p, h, capacity_mode=capacity_mode,
                           moe_groups=moe_groups)
    return x + out, None if stats is None else stats.aux_loss


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """whisper's encoder over precomputed frame embeddings (B, T_enc, D)
    (the convolutional front end is a stub, as in the JAX package), in
    the frames' dtype."""
    enc = params["encoder"]
    T = frames.shape[1]
    x = frames + enc["pos_embed"][:T].to(frames.dtype)[None]
    positions = torch.arange(T, dtype=torch.int32,
                             device=frames.device).expand(frames.shape[:2])
    for p_l in layer_unbind(enc["blocks"], cfg.n_encoder_layers):
        x, _ = _apply_block("whisper_enc", cfg, p_l, x, positions)
    return apply_norm(cfg.norm, enc["final_norm"], x, cfg.norm_eps)


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 compute_dtype, start: int = 0) -> torch.Tensor:
    """The token embeddings of positions ``start..start + S`` (B, S, D),
    plus the learned positions where ``cfg.learned_pos``."""
    x = embed(params["embed"], tokens, compute_dtype)
    if cfg.learned_pos:
        S = tokens.shape[1]
        x = x + params["pos_embed"][start:start + S].to(compute_dtype)[None]
    return x


def encoder_output(cfg: ModelConfig, params: Params, encoder_frames,
                   compute_dtype) -> torch.Tensor | None:
    """``encode`` of the frames in the compute dtype for an enc-dec arch
    (which must be given them), None for any other."""
    if not cfg.is_encdec:
        return None
    if encoder_frames is None:
        raise ValueError(f"enc-dec arch {cfg.name!r} needs encoder_frames")
    return encode(cfg, params, encoder_frames.to(compute_dtype))


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) integer
    *,
    encoder_frames: torch.Tensor | None = None,
    capacity_mode: str = "fifo",
    moe_groups: int = 1,
    remat: bool = True,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V) f32, aux_loss: the
    MoE layers' load-balance losses summed, 0 for a dense stack).

    ``remat`` checkpoints every layer when autograd records the forward;
    without gradients it changes nothing.  A checkpointed MoE layer routes
    again in its recompute (the same assignments: routing is
    deterministic), so a ``"bisect"`` layer solves its capacity twice a
    training step.  An enc-dec arch (whisper) takes its encoder's input
    frames (B, T_enc, D) as ``encoder_frames``.
    """
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    encoder_out = encoder_output(cfg, params, encoder_frames, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    remat = remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for run_params, (kind, count) in zip(params["runs"], ported_plan(cfg)):
        aux_run = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for p_l in layer_unbind(run_params, count):
            args = (kind, cfg, p_l, x, positions, capacity_mode, moe_groups,
                    encoder_out)
            if remat:
                x, aux = checkpoint(_apply_block, *args, use_reentrant=False)
            else:
                x, aux = _apply_block(*args)
            if aux is not None:
                aux_run = aux_run + aux
        aux_total = aux_total + aux_run
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x, cfg.vocab)
    return logits, aux_total
