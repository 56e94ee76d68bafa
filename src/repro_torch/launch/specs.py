"""Meta-device stand-ins for every model input: no allocation (port of
``repro.launch.specs``).

``input_specs(arch, shape)`` returns the pytree of inputs the step of
that (architecture x input-shape) cell takes; ``params_specs``,
``cache_specs`` and ``opt_state_specs`` run the port's own init
functions with every factory call sent to ``torch.device("meta")``, so
each leaf has the shape and dtype the real init gives it, and no data.
The trees, leaf shapes and dtypes are those of the JAX package's
``jax.eval_shape`` stand-ins: layer-stacked runs, the cache's
NamedTuples, the AdamW state.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.models import decode as decode_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

META = torch.device("meta")

# the factories the init functions call: sent to the meta device, their
# generator dropped (a meta tensor draws nothing)
_FACTORIES = {torch.randn, torch.rand, torch.randint, torch.zeros,
              torch.ones, torch.full, torch.empty, torch.arange,
              torch.tensor, torch.normal, torch.eye, torch.linspace}


class _MetaFactories(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = META
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def on_meta(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every tensor factory on the meta
    device."""
    with _MetaFactories():
        return fn(*args, **kwargs)


def spec(shape, dtype) -> torch.Tensor:
    """One stand-in leaf."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(arch_id: str, shape: ShapeSpec,
                cfg: ModelConfig | None = None) -> dict[str, Any]:
    """Inputs for the step kind of this cell (train/prefill/decode);
    ``cfg`` replaces the registry's config of ``arch_id``."""
    cfg = cfg or get_config(arch_id)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch: dict[str, Any] = {"tokens": spec((B, S), torch.int32),
                                 "targets": spec((B, S), torch.int32)}
        if cfg.is_encdec:
            batch["frames"] = spec((B, cfg.encoder_len, cfg.d_model),
                                   torch.bfloat16)
        return {"batch": batch}
    if shape.kind == "prefill":
        out: dict[str, Any] = {"tokens": spec((B, S), torch.int32)}
        if cfg.is_encdec:
            out["frames"] = spec((B, cfg.encoder_len, cfg.d_model),
                                 torch.bfloat16)
        return out
    if shape.kind == "decode":
        return {"token": spec((B,), torch.int32),
                "pos": spec((), torch.int32),
                "cache": cache_specs(cfg, B, S)}
    raise ValueError(shape.kind)


def params_specs(cfg: ModelConfig, param_dtype=torch.bfloat16):
    """The parameter tree on the meta device."""
    return on_meta(tfm.init_params, cfg, torch.Generator(), param_dtype)


def cache_specs(cfg: ModelConfig, batch: int, context: int,
                dtype=torch.bfloat16):
    """The decode cache of ``batch`` rows of ``context`` on the meta
    device (int8 ``dtype``: codes and f16 scales)."""
    return on_meta(decode_lib.init_cache, cfg, batch, context, dtype,
                   device=META)


def opt_state_specs(cfg: ModelConfig, param_dtype=torch.bfloat16):
    """The AdamW state of ``params_specs`` on the meta device."""
    from repro_torch.optim.adamw import adamw_init

    return adamw_init(params_specs(cfg, param_dtype))
