"""The architecture registry: ``get_config(name)``, ``smoke_config(name)``
and the shape grid ``SHAPES``.

Port of ``src/repro/configs/__init__.py``: the ten architectures of the
five families, each config file a copy naming its source, and the dry
run's cell grid (``applicable``, ``all_cells``; :56-64).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ArchConfig

__all__ = ["ARCH_IDS", "ShapeSpec", "SHAPES", "get_config", "smoke_config",
           "applicable", "all_cells"]

ARCH_IDS = [
    "internlm2-1.8b",
    "internlm2-20b",
    "starcoder2-15b",
    "granite-20b",
    "recurrentgemma-2b",
    "whisper-tiny",
    "grok-1-314b",
    "qwen3-moe-235b-a22b",
    "rwkv6-7b",
    "chameleon-34b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}: one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).ARCH


def smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §3 skip table)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode cache infeasible (skip per spec)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
