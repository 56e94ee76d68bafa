"""Model assembly, dense family (port of ``repro.models.transformer``).

The layer stack is described by a LAYER PLAN: an ordered list of
``(block_kind, n_layers)`` runs, each run's parameters stacked along a
leading layer axis as in the JAX package.  A Python loop over that axis
replaces ``lax.scan``.  ``layer_plan`` covers every family (it is data);
``init_params`` and ``forward`` build and run ``"dense"`` runs only and
raise ``ValueError`` for the other block kinds.

``forward(remat=True)`` checkpoints each layer (non-reentrant
``torch.utils.checkpoint``, where JAX wraps the scan body in
``jax.checkpoint``): backward recomputes the layer from its input.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
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


def dense_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The layer plan, checked to hold only block kinds the port runs."""
    plan = layer_plan(cfg)
    for kind, _ in plan:
        if kind != "dense":
            raise ValueError(
                f"block kind {kind!r} (family {cfg.family!r}) is not ported "
                "yet; only 'dense' runs are")
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

def _init_dense_run(cfg: ModelConfig, gen, dtype, count: int) -> Params:
    d, lead = cfg.d_model, (count,)
    return {
        "ln1": init_norm(cfg.norm, d, dtype, gen.device, lead),
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead),
        "ln2": init_norm(cfg.norm, d, dtype, gen.device, lead),
        "mlp": init_mlp(cfg.act, gen, d, cfg.d_ff, dtype, lead),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                param_dtype=torch.float32) -> Params:
    """Full parameter tree on ``generator.device``; runs stacked along a
    leading layer axis.  Shapes and scale are the JAX package's
    (``unembed`` is ``(d_model, vocab_padded)``)."""
    runs = [_init_dense_run(cfg, generator, param_dtype, count)
            for _, count in dense_plan(cfg)]
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

def _apply_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One dense block over the full sequence."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    x = x + attn_lib.attend(p["attn"], cfg, h, positions)
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    return x + apply_mlp(cfg.act, p["mlp"], h)


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) integer
    *,
    remat: bool = True,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V) f32, aux_loss).

    ``remat`` checkpoints every layer when autograd records the forward;
    without gradients it changes nothing.
    """
    B, S = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    remat = remat and torch.is_grad_enabled()
    for run_params, (_, count) in zip(params["runs"], dense_plan(cfg)):
        for p_l in layer_unbind(run_params, count):
            if remat:
                x = checkpoint(_apply_block, cfg, p_l, x, positions,
                               use_reentrant=False)
            else:
                x = _apply_block(cfg, p_l, x, positions)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x, cfg.vocab)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
