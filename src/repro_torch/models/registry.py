"""Model registry — build a Model facade from a ModelConfig (port).

:func:`build_model` binds a config to a device (``cuda`` unless the caller
asks for ``cpu``).  ``Model.forward`` is inference (no autograd graph is
built); ``Model.loss`` is the training loss; ``Model.abstract_params``
gives the params' shapes and dtypes as meta-device tensors, with no
allocation (the reference's ``eval_shape``).  :func:`params_from_numpy` carries the JAX package's
params across as a numpy tree (``jax.tree_util.tree_map(np.asarray,
params)``) into the port's dict, keys and stacked shapes unchanged, or
into one rank's shards of it (``specs=``, ``mesh=``, ``rank=``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.runtime import resolve_device
from ..distributed.comm import Comm, local_comm
from ..distributed.spmd_map import shard
from . import lm
from .common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    """Facade: init, forward and loss on one device."""

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: Union[int, torch.Generator] = 0
             ) -> Tuple[Dict, Dict]:
        """(params, specs) drawn from ``seed`` (an int, or a generator on
        this model's device)."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return lm.init_params(self.cfg, gen)

    def abstract_params(self) -> Tuple[Dict, Dict]:
        """(params as meta-device tensors of the real shapes and dtypes,
        specs): nothing is allocated or drawn."""
        return lm.init_params(self.cfg, torch.Generator(), device="meta")

    def loss(self, params, batch, comm: Optional[Comm] = None, *,
             remat: bool = True):
        """(loss, metrics) of :func:`lm.loss_and_metrics`."""
        return lm.loss_and_metrics(params, batch, self.cfg,
                                   comm or local_comm(), remat=remat)

    @torch.no_grad()
    def forward(self, params, batch, comm: Optional[Comm] = None, *,
                remat: bool = True):
        """Inference forward: no graph is recorded, whatever the params
        require (``remat`` is the reference's knob; it changes nothing
        without a graph)."""
        return lm.forward(params, batch, self.cfg, comm or local_comm(),
                          remat=remat)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """A :class:`Model` on ``device`` (default ``cuda``; no GPU and no
    ``"cpu"`` raises; ``"meta"`` gives a model for shapes only, as
    ``abstract_params``).  Every family of the reference builds."""
    lm.require_ported(cfg, "build_model")
    if device is not None and torch.device(device).type == "meta":
        return Model(cfg, torch.device("meta"))
    return Model(cfg, resolve_device(device))


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C")        # our own writable copy
    if arr.dtype.name == "bfloat16":      # ml_dtypes.bfloat16, by its bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device=None,
                      *, specs: Optional[Dict[str, Any]] = None,
                      mesh=None, rank: int = 0) -> Dict[str, Any]:
    """The JAX package's params, as a nested dict of numpy arrays, ->
    the port's params on ``device``: same keys, shapes and dtypes
    (bfloat16 arrives as ``ml_dtypes.bfloat16`` and is carried by its
    bits).  With ``specs`` (the :class:`ParamSpec` tree) and a ``mesh``,
    each array is first cut to rank ``rank``'s shard by its spec's
    ``pspec()`` — the full tree from the reference becomes one rank's."""
    lm.require_ported(cfg, "params_from_numpy")
    dev = resolve_device(device)

    def conv(node, spec):
        if isinstance(node, dict):
            return {k: conv(v, None if spec is None else spec[k])
                    for k, v in node.items()}
        arr = np.asarray(node)
        if spec is not None and mesh is not None:
            arr = shard(arr, spec.pspec(), mesh, rank)
        return _to_tensor(arr, dev)
    return conv(tree, specs)
