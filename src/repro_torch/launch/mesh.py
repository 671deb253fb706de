"""Meshes, the step Comm and the batch's partition specs (the mirror of
:mod:`repro.launch.mesh` over the port's :class:`Mesh` and
:func:`spmd_map`).

The reference's mesh axes are ``("data", "model")`` (``("pod", "data",
"model")`` across pods): ``data`` carries DP + FSDP, ``model`` TP/EP/SP.
A port rank's Comm binds :class:`~repro_torch.core.axis.Axis` objects,
so :func:`make_comm` takes the rank's bound axes (``mesh.lci_axes(r)``
or ``dist_axes``); :func:`shard` cuts a whole tree for one rank;
:func:`state_pspecs` gives a train state's specs (the reference
launcher's ``sspecs``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.modes import CommConfig
from ..core.progress import EndpointSpec
from ..distributed.comm import Comm
from ..distributed.spmd_map import Mesh, P
from ..distributed.spmd_map import shard as _shard_leaf
from ..distributed.spmd_map import tree_map2


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.names if a in ("pod", "data"))


def make_comm(mesh: Mesh, axes: Dict[str, Any],
              config: Optional[CommConfig] = None, *, fsdp: bool = True,
              endpoint: Optional[EndpointSpec] = None) -> Comm:
    """The step Comm of the rank whose bound axes are ``axes`` (by mesh
    axis name); ``endpoint`` picks the resource bundle the step's
    collectives ride."""
    data = tuple(axes[a] for a in data_axes(mesh) if a in axes)
    return Comm(config or CommConfig(), model_axis=axes.get("model"),
                data_axis=data or None, fsdp=fsdp, endpoint=endpoint)


def shard(mesh: Mesh, tree, tree_pspecs, rank: int):
    """Rank ``rank``'s shards of the full ``tree`` by ``tree_pspecs`` (a
    matching tree, or one spec for the whole tree)."""
    return tree_map2(lambda t, s: _shard_leaf(t, s, mesh, rank), tree,
                     tree_pspecs)


def state_pspecs(specs: Dict[str, Any]):
    """A :class:`~repro_torch.train.TrainState`'s PartitionSpecs (the
    reference launcher's ``sspecs``): params, mu, nu and the float32
    master each by its param's ``ParamSpec.pspec()`` (tp over ``model``,
    FSDP over ``data``), the step replicated."""
    from ..core.tree import tree_map
    from ..optim import OptState
    from ..train import TrainState
    pspecs = tree_map(lambda sp: sp.pspec(), specs)
    return TrainState(pspecs, OptState(P(), pspecs, pspecs, pspecs))


def batch_pspecs(cfg, shape_kind: str, mesh: Mesh, *, batch: int
                 ) -> Dict[str, P]:
    """PartitionSpecs for the batch dict of one cell: tokens and labels
    sequence over ``model``, batch over the data axes; a vlm config's
    image embeddings whole on every model rank, an enc-dec config's
    frames sequence over ``model`` (batch over data when batch > 1);
    ``cfg`` None: the tokens' specs alone."""
    daxes = data_axes(mesh)
    if shape_kind == "decode":
        out = {"tokens": P() if batch == 1 else P(daxes)}
    else:
        out = {"tokens": P("model", daxes), "labels": P("model", daxes)}
    if cfg is None:                       # tokens alone
        return out
    if cfg.family == "vlm":
        out["image_embeds"] = P(None, daxes if batch > 1 else None, None)
    if cfg.is_encdec:
        out["frames"] = P("model", daxes if batch > 1 else None, None)
    return out
