"""Model assembly, dense and MoE families (port of
``repro.models.transformer``).

The layer stack is described by a LAYER PLAN: an ordered list of
``(block_kind, n_layers)`` runs, each run's parameters stacked along a
leading layer axis as in the JAX package.  A Python loop over that axis
replaces ``lax.scan``.  ``layer_plan`` covers every family (it is data);
``init_params`` and ``forward`` build and run ``"dense"`` and ``"moe"``
runs (``ported_plan``) and raise ``ValueError`` for the other block
kinds.  A ``"moe"`` block is a dense block whose MLP is
``models/moe.py::moe_apply``; ``forward`` sums its layers' load-balance
losses as the JAX scan carries them.

``forward(remat=True)`` checkpoints each layer (non-reentrant
``torch.utils.checkpoint``, where JAX wraps the scan body in
``jax.checkpoint``): backward recomputes the layer from its input.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
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


PORTED_KINDS = ("dense", "moe")


def ported_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The layer plan, checked to hold only block kinds the port runs."""
    plan = layer_plan(cfg)
    for kind, _ in plan:
        if kind not in PORTED_KINDS:
            raise ValueError(
                f"block kind {kind!r} (family {cfg.family!r}) is not ported "
                f"yet; only {' and '.join(map(repr, PORTED_KINDS))} runs are")
    return plan


def layer_unbind(tree, count: int) -> list:
    """Every layer of a run's stacked parameter (or cache) tree at once, as
    views: one ``unbind`` per leaf, so backward stacks the layers'
    gradients once instead of scattering each into a zeroed copy of the
    whole stack.  Dicts and (named) tuples keep their type per layer."""
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
    d, lead = cfg.d_model, (count,)
    p = {
        "ln1": init_norm(cfg.norm, d, dtype, gen.device, lead),
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead),
        "ln2": init_norm(cfg.norm, d, dtype, gen.device, lead),
    }
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


def _apply_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, capacity_mode: str,
                 moe_groups: int):
    """One dense or MoE block over the full sequence: (x, the MoE layer's
    aux loss, a 0-d f32 tensor; None for a dense block)."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    x = x + attn_lib.attend(p["attn"], cfg, h, positions)
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    out, stats = apply_ffn(cfg, p, h, capacity_mode=capacity_mode,
                           moe_groups=moe_groups)
    return x + out, None if stats is None else stats.aux_loss


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) integer
    *,
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
    training step.
    """
    B, S = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    remat = remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for run_params, (_, count) in zip(params["runs"], ported_plan(cfg)):
        aux_run = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for p_l in layer_unbind(run_params, count):
            args = (cfg, p_l, x, positions, capacity_mode, moe_groups)
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
