"""Registry: public arch id -> ModelConfig, plus the assigned shape grid."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-4b": "qwen3_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "chameleon-34b": "chameleon_34b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "paper-bisection": "paper_bisection",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "paper-bisection")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


# ---------------------------------------------------------------------------
# the assigned input-shape grid (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def input_shapes(arch_id: str) -> dict[str, ShapeSpec]:
    """Shapes applicable to this arch; long_500k only for sub-quadratic
    stacks (DESIGN.md §7 records the skips)."""
    cfg = get_config(arch_id)
    shapes = dict(SHAPES)
    if not cfg.sub_quadratic:
        shapes.pop("long_500k")
    return shapes


def skipped_shapes(arch_id: str) -> dict[str, str]:
    cfg = get_config(arch_id)
    if not cfg.sub_quadratic:
        return {"long_500k": "full quadratic attention — 512k decode "
                             "requires a sub-quadratic mixer (DESIGN.md §7)"}
    return {}
