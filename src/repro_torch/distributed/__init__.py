"""Distributed layer of the port: the ``Comm`` handed to model code (one
rank with ``local_comm()``, or bound rank axes), ``spmd_map``, the
port's ``shard_map`` over the comm core's rank threads or
``torch.distributed`` processes, autograd through the collectives on the
rank thread (``spmd_autograd``), the 1F1B pipeline schedule and its
comm graph, and the resilience features (elastic resharding, straggler
detection)."""
from .comm import Comm, local_comm
from .elastic import compatible_meshes, reshard_state, shrink_mesh
from .pipeline import (PipelineCommGraph, PipelinedModel, PPNode,
                       bubble_fraction, build_1f1b_comm_graph, schedule_1f1b)
from .spmd_map import (PER_RANK, Mesh, P, PartitionSpec, dist_axes, shard,
                       spmd_map, unshard)
from .straggler import HostWatchdog, StepTimeMonitor, StragglerReport

__all__ = ["Comm", "local_comm", "Mesh", "P", "PER_RANK", "PartitionSpec",
           "dist_axes", "shard", "spmd_map", "unshard", "compatible_meshes",
           "reshard_state", "shrink_mesh", "PipelineCommGraph",
           "PipelinedModel", "PPNode", "bubble_fraction",
           "build_1f1b_comm_graph", "schedule_1f1b", "HostWatchdog",
           "StepTimeMonitor", "StragglerReport"]
