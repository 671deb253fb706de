"""The training step — forward, backward, grad sync, clip, AdamW —
comm-local (the mirror of :mod:`repro.train.step`).

One function serves one rank (``local_comm()``) and every rank of
``spmd_map`` on a ``(D, M)`` mesh: the loss and its gradient are taken
on the rank's batch shard (each layer rematerialized), then
:func:`grad_sync` adds the reductions the backward did not make, on the
rank thread, the global norm clips the gradient, AdamW updates the
float32 master and the params, and the metrics are meaned over every
mesh axis.  Where the forward runs collectives with a gradient (tp > 1,
or FSDP weights gathered over data at dp > 1) the backward is the rank
thread's tape (:mod:`repro_torch.distributed.spmd_autograd`): every
collective's transpose and every recompute runs on the rank thread;
otherwise it is ``torch.autograd.grad`` of ``Model.loss``.  The step
donates its state: the returned :class:`TrainState` holds the same
tensors, updated in place.  Its parts are telemetry spans
(:mod:`repro_torch.core.telemetry`): ``train.grad_sync``,
``train.clip``, ``train.adamw`` and ``train.metrics``, and where the
backward is ``autograd.grad``, ``train.forward`` and ``train.backward``
(the tape's passes have no spans of their own).

:class:`ShardedState` holds a state as its ranks' shards over a mesh
between steps (the launcher's ``(D, M)`` path): no rank, and no caller,
holds the whole state; it is put together only for a checkpoint.
:func:`state_tree` / :func:`state_from_tree` give the state as the
reference's ``TrainState`` pytree flattens, so a checkpoint of either
package has the same leaf names (``0_<param>``, ``1_0`` the step,
``1_1_*`` mu, ``1_2_*`` nu, ``1_3_*`` master) and either package resumes
the other's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.telemetry import active
from ..core.tree import leaves_with_paths, tree_from_paths, tree_map
from ..distributed import spmd_autograd
from ..distributed.comm import Comm, local_comm
from ..distributed.elastic import reshard_state
from ..distributed.spmd_map import Mesh, unshard_tree
from ..models.registry import Model
from ..optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                     clip_by_global_norm, grad_sync)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt: OptState


@dataclasses.dataclass
class ShardedState:
    """A :class:`TrainState` cut over ``mesh``: ``ranks[r]`` is rank
    ``r``'s shard, each leaf cut by ``pspecs`` (a TrainState of
    PartitionSpecs, ``launch/mesh.py::state_pspecs``)."""
    ranks: List[TrainState]
    pspecs: TrainState
    mesh: Mesh

    @classmethod
    def cut(cls, state: TrainState, pspecs: TrainState, mesh: Mesh
            ) -> "ShardedState":
        """``state``'s shards on ``mesh``'s device (the caller drops the
        whole state)."""
        return cls(reshard_state(state, pspecs, mesh), pspecs, mesh)

    def resharded(self, state: TrainState) -> "ShardedState":
        """Another whole state cut as this one is."""
        return ShardedState.cut(state, self.pspecs, self.mesh)

    def gather(self) -> TrainState:
        """The whole state, put together from the shards."""
        return unshard_tree(self.ranks, self.pspecs, self.mesh)

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def state_tree(state) -> tuple:
    """The state as the reference's pytree flattens it: ``(params, (step,
    mu, nu, master))`` (a :class:`ShardedState` put together first)."""
    if isinstance(state, ShardedState):
        state = state.gather()
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
    gradient, a tree like ``params`` in their dtypes: by the rank thread's
    tape where the forward runs collectives with a gradient (a model axis
    wider than one rank, or FSDP weights gathered over data)."""
    if comm.tp > 1 or (comm.fsdp and comm.dp > 1):
        return spmd_autograd.loss_and_grads(
            lambda p: model.loss(p, batch, comm, remat=remat), params)
    tele = active()
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with tele.span("train.forward"):
        loss, metrics = model.loss(tracked, batch, comm, remat=remat)
    paths = leaves_with_paths(tracked)
    with tele.span("train.backward"):
        flat = torch.autograd.grad(loss, [p for _, p in paths])
    grads = tree_from_paths(params, dict(zip((n for n, _ in paths), flat)))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, specs: Dict[str, Any],
                    opt_cfg: AdamWConfig, comm: Optional[Comm] = None, *,
                    remat: bool = True) -> Callable:
    comm = comm or local_comm()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        tele = active()
        _, metrics, grads = loss_and_grads(model, state.params, batch, comm,
                                           remat=remat)
        with tele.span("train.grad_sync"):
            grads = grad_sync(grads, specs, comm)
        with tele.span("train.clip"):
            grads, gnorm = clip_by_global_norm(grads, specs, comm,
                                               opt_cfg.max_grad_norm)
        with tele.span("train.adamw"):
            params, opt = adamw_update(grads, state.opt, state.params,
                                       opt_cfg)
        # metrics leave the step fully replicated: the mean of every
        # scalar over all mesh axes
        with tele.span("train.metrics"):
            metrics = comm.pmean_all({k: v.to(torch.float32)
                                      for k, v in metrics.items()})
        metrics["grad_norm"] = gnorm
        return TrainState(params, opt), metrics

    return train_step
