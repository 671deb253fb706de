"""Plain PyTorch version of the RMSNorm kernel (the oracle).

The mirror of ``repro/kernels/rmsnorm/ref.py``, plus a ``w=None`` case:
``x * rsqrt(mean(x²) + eps) [* w]`` in float32, cast back to x.dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: Optional[torch.Tensor], *,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)
