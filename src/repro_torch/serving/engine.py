"""Batched generation engine: prefill once, decode with the runahead
sampler (port of ``repro.serving.engine``).

The JAX engine runs the whole decode as one ``lax.scan``.  Here prefill
and the first token run eagerly, then each decode step is one replay of a
CUDA graph of ``_decode_body`` (``core/graphs.py``): the forward, the
sample, the token and position advanced in place.  The position is a (B,)
device tensor the graph advances, so the step takes ``decode_step``'s
per-slot branch; the tokens are those of a loop with a host-integer
position, bit for bit.  The graph and its static state (KV cache, token,
position, the step's noise draw) are kept in a ``DecodeGraphs`` the
caller owns, per (params, config, sampler, compute dtype, batch,
context, device), so a later call with the same model and shapes replays
it at once; the prefill's cache (K/V rings, recurrent states and
whisper's encoder K/V alike) is copied into the static one once a call,
and every step writes it in place (the encoder K/V it only reads).  Nothing
is read back to the host until the caller does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.graphs import Graphs
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import decode_step, prefill
from repro_torch.models.transformer import unembed_table
from repro_torch.serving.sampler import (
    SamplerConfig,
    gumbel_from_uniform,
    sample,
)
from repro_torch.tree import leaves


class _DecodeState(NamedTuple):
    params: dict                   # held: the graph reads it by address
    cache: list                    # K/V and recurrent state, in place
    token: torch.Tensor            # (B,) current tokens
    pos: torch.Tensor              # (B,) the position each row writes
    uniforms: torch.Tensor         # (B, V) the step's uniform draw


def _decode_body(cfg: ModelConfig, st: _DecodeState, sc: SamplerConfig,
                 compute_dtype) -> torch.Tensor:
    """One decode step of the batch: the forward at ``st.pos``, the
    sample (its noise from ``st.uniforms``), the token and position
    advanced in place.  Returns the (B,) sampled tokens."""
    logits, _ = decode_step(cfg, st.params, st.token, st.pos, st.cache,
                            compute_dtype=compute_dtype)
    noise = None if sc.greedy else gumbel_from_uniform(st.uniforms)
    nxt = sample(logits, None, sc, noise=noise)
    st.token.copy_(nxt)
    st.pos.add_(1)
    return nxt


class DecodeGraphs:
    """The decode step's graphs and their static state (KV cache, token,
    position, noise draw), one per (params, config, sampler, compute
    dtype, batch, context, device): the jit cache of the JAX engine.  A
    caller that generates again with the same model keeps one and passes
    it to ``generate``; it holds the weights it was used with."""

    def __init__(self):
        self.graphs = Graphs()
        self._states: dict = {}

    def state(self, key, params, cache, B: int, V: int, device
              ) -> _DecodeState:
        """The decode state of ``key``, holding ``cache``'s values: on the
        card the key's static buffers (made at its first call), on the
        CPU fresh ones around ``cache`` itself."""
        def fresh(cache):
            return _DecodeState(
                params, cache,
                torch.zeros((B,), dtype=torch.int64, device=device),
                torch.zeros((B,), dtype=torch.int64, device=device),
                torch.zeros((B, V), dtype=torch.float32, device=device))

        if device.type != "cuda":
            return fresh(cache)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = fresh(cache)
        else:
            for big, new in zip(leaves(st.cache), leaves(cache)):
                big.copy_(new)
        return st


def generate(
    cfg: ModelConfig,
    params,
    prompt: torch.Tensor,              # (B, S) integer
    n_new: int,
    generator: torch.Generator | None,
    *,
    context: int | None = None,
    sampler: SamplerConfig = SamplerConfig(),
    compute_dtype=torch.bfloat16,
    graphs: DecodeGraphs | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns generated tokens (B, n_new) int64.

    The first token comes from the prefill logits; each of the remaining
    ``n_new - 1`` comes from one decode step, so ``n_new`` tokens cost
    ``n_new - 1`` decode steps.  Each step draws its (B, V) noise from
    ``generator`` before the step runs, the draw ``sample`` makes.
    ``graphs`` keeps the step's graph for later calls (without it, this
    call captures its own).  An enc-dec arch (whisper) takes its
    encoder's input frames (B, T_enc, D) as ``encoder_frames``.
    """
    B, S = prompt.shape
    context = context or (S + n_new)
    logits, cache = prefill(cfg, params, prompt, context,
                            encoder_frames=encoder_frames,
                            compute_dtype=compute_dtype)
    toks = [sample(logits, generator, sampler)]
    if n_new > 1:
        graphs = graphs or DecodeGraphs()
        dev = prompt.device
        t_enc = None if encoder_frames is None else encoder_frames.shape[1]
        key = (id(params), cfg, sampler, compute_dtype, B, context, dev,
               t_enc)
        st = graphs.state(key, params, cache, B,
                          unembed_table(cfg, params).shape[-1], dev)
        st.token.copy_(toks[0])
        st.pos.fill_(S)
        body = functools.partial(_decode_body, cfg, st, sampler,
                                 compute_dtype)
        for _ in range(n_new - 1):
            if not sampler.greedy:
                torch.rand(st.uniforms.shape, generator=generator,
                           out=st.uniforms)
            toks.append(graphs.graphs.run(key, body, device=dev))
    return torch.stack(toks, dim=1)[:, :n_new]
