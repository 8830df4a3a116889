"""The LM substrate: the five block families (dense, moe, hybrid, rwkv,
encdec) as torch ``nn.Module`` trees and plain step functions.

Port of ``src/repro/models/__init__.py`` (the same exported names).
"""
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    init_params_shape,
)

__all__ = [
    "ArchConfig",
    "init_params",
    "init_params_shape",
    "forward",
    "decode_step",
    "init_decode_state",
]
