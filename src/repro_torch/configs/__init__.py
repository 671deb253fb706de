"""Config registry: 10 architectures × 4 input shapes = 40 cells (port).

The mirror of :mod:`repro.configs`, as plain data: ``get_config(arch)`` /
``get_smoke(arch)`` return :class:`~repro_torch.models.common.ModelConfig`
objects with the reference's fields; ``SHAPES`` and ``cells()`` keep the
reference's shape grid and its documented ``long_500k`` skips.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from ..models.common import ModelConfig

_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "olmo-1b": "olmo_1b",
    "gemma3-1b": "gemma3_1b",
    "minitron-8b": "minitron_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "Shape", "cells",
           "get_config", "get_smoke", "shape_applicable"]


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; pick from {ARCH_NAMES}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """(runs?, reason) for one (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.uses_subquadratic_attention():
        return False, ("pure full-attention arch: 500k decode KV would be "
                       "quadratic-prefill territory; skipped per assignment")
    return True, ""


def cells(archs: Optional[List[str]] = None
          ) -> List[Tuple[str, str, bool, str]]:
    """All 40 cells: (arch, shape, runs, skip_reason)."""
    out = []
    for a in (archs or ARCH_NAMES):
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
