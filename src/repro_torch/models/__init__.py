"""The model families' forward, prefill and decode (port of
``repro.models``): dense, MoE (``moe``), hymba's attention || SSM blocks
(``ssm``) and xlstm's mLSTM / sLSTM blocks (``xlstm``)."""
from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_params, layer_plan
from repro_torch.models.decode import decode_step, init_cache, prefill

__all__ = [
    "ModelConfig",
    "forward",
    "init_params",
    "layer_plan",
    "decode_step",
    "init_cache",
    "prefill",
]
