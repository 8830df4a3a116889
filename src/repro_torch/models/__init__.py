"""The LM substrate: the dense family as a torch ``nn.Module`` and plain
step functions.

Port of ``src/repro/models/__init__.py`` (the same exported names); the
other families wait for later slices (ROADMAP.md Queue 1 item 9).
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
