"""Plain PyTorch version of the SSM conv-stage kernel (the oracle).

The Mamba2 mixer's stage between the fused ``[z|x|dt]`` projection and
the scan, as ``repro/models/ssm.py`` writes it in plain ``jnp``: the
causal depthwise conv over time as the reference's shifted sum, in x's
dtype; SiLU in float32, rounded to x's dtype; ``softplus(dt_raw +
dt_bias)`` in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over dim 0, the reference's shifted sum in
    x's dtype.  x (s, bs, ch), w (K, ch).  (A shift past the sequence's
    start is all zeros, also for s < K - 1, where the reference's pad
    does not fit.)"""
    K, s = w.shape[0], x.shape[0]
    out = x * w[K - 1]
    for k in range(1, K):
        shifted = F.pad(x, (0, 0, 0, 0, k, 0))[:s]
        out = out + shifted * w[K - 1 - k]
    return out


def softplus_dt(dt_raw: torch.Tensor, dt_bias: torch.Tensor
                ) -> torch.Tensor:
    """``softplus(dt_raw + dt_bias)`` in float32 (torch's threshold of 20
    and ``jax.nn.softplus`` agree to a few ulps, ROADMAP §C)."""
    return F.softplus(dt_raw.float() + dt_bias.float())


def ssm_conv_ref(xs: torch.Tensor, dt_raw: torch.Tensor,
                 conv_w: torch.Tensor, dt_bias: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (s, bs, ch); dt_raw (s, bs, h); conv_w (K, ch); dt_bias (h,) ->
    (``silu(causal_conv(xs, conv_w))`` in xs's dtype, ``softplus(dt_raw +
    dt_bias)`` in float32)."""
    y = causal_conv(xs, conv_w)
    return F.silu(y.float()).to(xs.dtype), softplus_dt(dt_raw, dt_bias)
