"""Distributed layer of the port: the ``Comm`` handed to model code (one
rank with ``local_comm()``, or bound rank axes) and ``spmd_map``, the
port's ``shard_map`` over the comm core's rank threads or
``torch.distributed`` processes.  The pipeline and the resilience
features are still to port (ROADMAP A6)."""
from .comm import Comm, local_comm
from .spmd_map import Mesh, P, PartitionSpec, dist_axes, shard, spmd_map, \
    unshard

__all__ = ["Comm", "local_comm", "Mesh", "P", "PartitionSpec", "dist_axes",
           "shard", "spmd_map", "unshard"]
