"""The training step — forward, backward, grad sync, clip, AdamW —
comm-local (the mirror of :mod:`repro.train.step`).

One function serves one rank (``local_comm()``) and every rank of
``spmd_map`` on a ``(D, 1)`` mesh: the loss and its gradient are taken
on the rank's batch shard (``torch.autograd.grad`` of ``Model.loss``,
each layer rematerialized), then :func:`grad_sync` means the gradient
over the data axis on the rank thread, the global norm clips it, AdamW
updates the float32 master and the params, and the metrics are meaned
over every mesh axis.  The step donates its state: the returned
:class:`TrainState` holds the same tensors, updated in place.

:func:`state_tree` / :func:`state_from_tree` give the state as the
reference's ``TrainState`` pytree flattens, so a checkpoint of either
package has the same leaf names (``0_<param>``, ``1_0`` the step,
``1_1_*`` mu, ``1_2_*`` nu, ``1_3_*`` master) and either package resumes
the other's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.tree import leaves_with_paths, tree_from_paths, tree_map
from ..distributed.comm import Comm, local_comm
from ..models.registry import Model
from ..optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                     clip_by_global_norm, grad_sync)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt: OptState


def state_tree(state: TrainState) -> tuple:
    """The state as the reference's pytree flattens it: ``(params, (step,
    mu, nu, master))``."""
    o = state.opt
    return (state.params, (o.step, o.mu, o.nu, o.master))


def state_from_tree(tree: tuple) -> TrainState:
    params, (step, mu, nu, master) = tree
    return TrainState(params, OptState(step, mu, nu, master))


def train_state_init(model: Model, seed, opt_cfg: AdamWConfig
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    params, specs = model.init(seed)
    return TrainState(params, adamw_init(params, opt_cfg)), specs


def loss_and_grads(model: Model, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], comm: Comm, *,
                   remat: bool = True):
    """(loss, metrics, grads): the loss of ``params`` on ``batch`` and its
    gradient, a tree like ``params`` in their dtypes."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(tracked, batch, comm, remat=remat)
    paths = leaves_with_paths(tracked)
    flat = torch.autograd.grad(loss, [p for _, p in paths])
    grads = tree_from_paths(params, dict(zip((n for n, _ in paths), flat)))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, specs: Dict[str, Any],
                    opt_cfg: AdamWConfig, comm: Optional[Comm] = None, *,
                    remat: bool = True) -> Callable:
    comm = comm or local_comm()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _, metrics, grads = loss_and_grads(model, state.params, batch, comm,
                                           remat=remat)
        grads = grad_sync(grads, specs, comm)
        grads, gnorm = clip_by_global_norm(grads, specs, comm,
                                           opt_cfg.max_grad_norm)
        params, opt = adamw_update(grads, state.opt, state.params, opt_cfg)
        # metrics leave the step fully replicated: the mean of every
        # scalar over all mesh axes
        metrics = comm.pmean_all({k: v.to(torch.float32)
                                  for k, v in metrics.items()})
        metrics["grad_norm"] = gnorm
        return TrainState(params, opt), metrics

    return train_step
