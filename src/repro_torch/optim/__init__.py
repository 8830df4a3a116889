"""Optimizers.  Port of ``src/repro/optim``: AdamW (``adamw``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule"]
