"""Gradient compression: int8 quantization + error feedback (the mirror
of :mod:`repro.distributed.compression`).

Before the data-axis reduction each rank quantizes its gradient to int8
with a per-tensor float32 scale; the quantization residual stays on the
rank and is added into the next step's gradient (error feedback).  The
int8 payload is summed in int32 over the data axis, the scales are
averaged.  Model-axis reductions stay exact.  Off by default; the
reference's convergence case trains twice and holds the compressed
losses to the uncompressed ones.  As in :mod:`repro_torch.optim.
grad_sync`, a :class:`Comm` that gathers no FSDP weights (``fsdp=False``)
compresses every gradient's data-axis mean.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.tree import leaves_with_paths, tree_from_paths, tree_map


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    gf = g.to(torch.float32)
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grad(g: torch.Tensor, error: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor: returns (q int8, scale, new_error)."""
    corrected = g.to(torch.float32) + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def compressed_psum_data(g: torch.Tensor, error: torch.Tensor, comm
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP mean of one gradient tensor through the int8 wire format.
    Returns (reduced grad in g's dtype, new local error)."""
    q, scale, new_error = compress_grad(g, error)
    qsum = comm.psum_data(q.to(torch.int32))
    ssum = comm.psum_data(scale)
    # mean over dp of per-rank (q_i * scale_i) ≈ (Σq_i) * mean(scale)/dp
    dp = comm.dp
    out = qsum.to(torch.float32) * (ssum / dp) / dp
    return out.to(g.dtype), new_error


def init_error_state(grads_like: Dict[str, Any]) -> Dict[str, Any]:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


@torch.no_grad()
def grad_sync_compressed(grads, specs, error_state, comm):
    """Drop-in alternative to ``optim.grad_sync`` with int8 error
    feedback: returns (synced grads, new error state)."""
    spec_of = dict(leaves_with_paths(specs))
    err_of = dict(leaves_with_paths(error_state))
    out_g, out_e = {}, {}
    dp = comm.dp
    for path, g in leaves_with_paths(grads):
        sp, e = spec_of[path], err_of[path]
        if sp.tp_axis is None:
            g = comm.psum_model(g)
        if sp.fsdp_axis is None or not comm.fsdp:
            g2, e2 = compressed_psum_data(g, e, comm)
        else:
            # AD already summed over data: the local shard is rescaled
            g2, e2 = (g / dp).to(g.dtype), e
        out_g[path], out_e[path] = g2, e2

    return tree_from_paths(grads, out_g), tree_from_paths(grads, out_e)
