"""Gradient synchronization over the data axis (the mirror of
:mod:`repro.optim.grad_sync`).

The reference runs under ``shard_map``, where AD already sums the
gradient of an FSDP-sharded param over the data axis (the transpose of
the forward's all-gather), so :func:`grad_sync` adds only the missing
reductions: a psum over ``model`` for a param replicated there, over
``data`` for one with no FSDP dim, then the mean over the data shards.
The port takes the gradient after the backward, on the rank thread, with
the same rule; a :class:`Comm` that does not gather FSDP weights
(``fsdp=False``, the port's data-parallel training, every param
replicated) sums every gradient over ``data``.  On the data axis the sum
is ``core/collectives.py::all_reduce`` (rings in the LCI modes) when the
leading dim divides over the axis, else the axis' psum, as the
reference picks.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core import collectives as C
from ..core.tree import leaves_with_paths, tree_map
from ..distributed.comm import Comm, _axes


def _psum_data(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    for a in _axes(comm.data_axis):
        if x.dim() >= 1 and x.shape[0] % a.size == 0:
            x = C.all_reduce(x, a, comm.cfg)      # ring rs+ag in LCI modes
        else:
            x = a.psum(x)
    return x


def _reduced_by_ad(spec, comm: Comm) -> bool:
    """Whether the gradient arrives summed over data already (an FSDP
    dim that the forward gathered)."""
    return spec.fsdp_axis is not None and comm.fsdp


@torch.no_grad()
def grad_sync(grads: Dict[str, Any], specs: Dict[str, Any], comm: Comm
              ) -> Dict[str, Any]:
    """Apply the missing reductions; result = mean over data shards."""
    dp = comm.dp

    def sync(g: torch.Tensor, spec) -> torch.Tensor:
        if spec.tp_axis is None:
            g = comm.psum_model(g)
        if not _reduced_by_ad(spec, comm):
            g = _psum_data(g, comm)
        return (g / dp).to(g.dtype)

    return tree_map(sync, grads, specs)


@torch.no_grad()
def global_norm(grads: Dict[str, Any], specs: Dict[str, Any], comm: Comm
                ) -> torch.Tensor:
    """Global L2 norm of the (synced) gradient across all shards; a
    replicated dim's sum of squares is weighted by 1/replication before
    the reduce."""
    tp, dp = comm.tp, comm.dp
    spec_of = dict(leaves_with_paths(specs))
    total = None
    for path, g in leaves_with_paths(grads):
        spec = spec_of[path]
        w = 1.0
        if spec.tp_axis is None:
            w /= tp
        if not _reduced_by_ad(spec, comm):
            w /= dp
        gf = g.to(torch.float32)
        term = w * torch.sum(gf * gf)
        total = term if total is None else total + term
    return torch.sqrt(comm.psum_all(total))


@torch.no_grad()
def clip_by_global_norm(grads, specs, comm: Comm, max_norm: float):
    gn = global_norm(grads, specs, comm)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    # in float32, as the reference's bf16 * f32 promotes
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn
