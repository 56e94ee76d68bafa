"""Decode path, dense family: cache init, prefill, single-token decode step
(port of ``repro.models.decode``).

Cache layout mirrors the layer plan: a list with one entry per run, each a
``{"kv": KVCache}`` whose tensors carry the run's leading layer axis,
``(L, B, C, n_kv, head_dim)``.  A Python loop over that axis replaces
``lax.scan``.  ``decode_step`` writes the new K/V into the cache in place
(the JAX function returns a new cache); the returned cache is the same
object.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, embed, unembed
from repro_torch.models.transformer import dense_plan, layer_slice, unembed_table

Params = dict
Cache = list


def init_cache(cfg: ModelConfig, batch: int, context: int,
               dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """Zero cache sized for `context` tokens."""
    return [{"kv": attn_lib.init_kv_cache(cfg, batch, context, dtype, device,
                                          lead=(count,))}
            for _, count in dense_plan(cfg)]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ring_fill(kv_full: torch.Tensor, cap: int) -> torch.Tensor:
    """Place the last min(S, cap) positions at ring slots pos % cap.

    kv_full: (B, S, n_kv, hd) -> (B, cap, n_kv, hd).
    """
    B, S, n_kv, hd = kv_full.shape
    if S <= cap:
        out = kv_full.new_zeros((B, cap, n_kv, hd))
        out[:, :S] = kv_full
        return out
    # tail row j holds position S - cap + j, which lives at slot
    # (S - cap + j) % cap: a rotation of the tail by (S - cap) % cap
    return torch.roll(kv_full[:, S - cap:], shifts=(S - cap) % cap, dims=1)


def _prefill_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, cap: int):
    """One dense block forward that also emits its ring-filled K/V."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    a, (k, v) = attn_lib.attend(p["attn"], cfg, h, positions, return_kv=True)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    x = x + apply_mlp(cfg.act, p["mlp"], h)
    return x, _ring_fill(k, cap), _ring_fill(v, cap)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,              # (B, S)
    context: int,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """Process the prompt; returns (last-position logits (B, V) f32, cache).

    Only the final position's logits are computed.  The cache holds K/V in
    ``compute_dtype``, as the JAX prefill does.
    """
    B, S = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    cache: Cache = []
    for run_params, (_, count) in zip(params["runs"], dense_plan(cfg)):
        ks, vs = [], []
        for i in range(count):
            x, k, v = _prefill_block(cfg, layer_slice(run_params, i), x,
                                     positions, context)
            ks.append(k)
            vs.append(v)
        cache.append({"kv": KVCache(k=torch.stack(ks), v=torch.stack(vs))})
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, -1], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _step_block(cfg: ModelConfig, p: Params, x: torch.Tensor, pos: int,
                kv: KVCache) -> torch.Tensor:
    """One dense block for one token.  x: (B, 1, D); kv: one layer's view."""
    eps = cfg.norm_eps
    h = apply_norm(cfg.norm, p["ln1"], x, eps)
    a, _ = attn_lib.decode_attend(p["attn"], cfg, h, pos, kv)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, eps)
    return x + apply_mlp(cfg.act, p["mlp"], h)


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,               # (B,) current token
    pos: int,                          # shared position of the batch
    cache: Cache,
    *,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, Cache]:
    """One decode step: returns (logits (B, V) f32, cache updated in place)."""
    x = embed(params["embed"], token[:, None], compute_dtype)  # (B, 1, D)
    for run_params, entry, (_, count) in zip(params["runs"], cache,
                                             dense_plan(cfg)):
        for i in range(count):
            x = _step_block(cfg, layer_slice(run_params, i), x, pos,
                            layer_slice(entry["kv"], i))
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_table(cfg, params), x[:, 0], cfg.vocab)
    return logits, cache
