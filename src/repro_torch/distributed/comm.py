"""The ``Comm`` object model code talks to — single-device only so far.

The mirror of :mod:`repro.distributed.comm` for the ``local_comm()``
deployment: no mesh axes, tp = 1, every collective the identity and
``weight()`` a no-op.  Model code is written against the same method
names as the reference, so the multi-rank ``Comm`` on
``torch.distributed`` (ROADMAP A4) slots in without touching it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.modes import CommConfig


@dataclasses.dataclass(frozen=True)
class Comm:
    """In-graph communication device handed to model code (one rank)."""

    config: CommConfig

    @property
    def tp(self) -> int:
        return 1

    def ag_matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``allgather(x over model) @ w``; with one rank, ``x @ w``."""
        return torch.matmul(x, w).to(x.dtype)

    def matmul_rs(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``reduce_scatter(x @ w over model)``; with one rank, ``x @ w``."""
        return torch.matmul(x, w).to(x.dtype)

    def ag_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        return x

    def rs_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        return x

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def psum_model_ge(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient-exact psum over the model axis (router aux means);
        with one rank, ``x``."""
        return x

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def a2a(self, x: torch.Tensor, *, split_axis: int, concat_axis: int
            ) -> torch.Tensor:
        """All-to-all over the model axis (MoE dispatch and combine); with
        one rank, ``x``."""
        return x

    def model_index(self) -> int:
        return 0

    def weight(self, w: torch.Tensor, *, fsdp_axis: Optional[int]
               ) -> torch.Tensor:
        return w


def local_comm(config: Optional[CommConfig] = None) -> Comm:
    """A Comm with no mesh axes: collectives degenerate to local compute."""
    return Comm(config or CommConfig())
