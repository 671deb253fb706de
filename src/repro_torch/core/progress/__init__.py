"""The progress-engine subsystem: fabric, reactions, rendezvous, endpoints.

Layout (each file one concern; the paper's Figure-1 chain in engine.py):

* :mod:`.fabric` — registered memory, pending-op records, payload staging
  (the wire types and the :class:`Fabric` implementation itself live in
  :mod:`repro_torch.core.transport`; re-exported here for compatibility).
* :mod:`.engine` — :class:`ProgressEngine`: posting + the reaction chain
  (drain backlog -> source completions -> poll incoming -> react).
* :mod:`.rendezvous` — :class:`RendezvousManager`: RTS/CTS/RDMA handshake
  and RMA put/get handling.
* :mod:`.endpoint` — :class:`Endpoint`/:class:`EndpointSpec`: named
  multi-device bundles with striping + progress policies.
* :mod:`.reliability` — :class:`ReliabilityManager`: stream seqs,
  cumulative acks, retransmit, dedup and post deadlines (DESIGN.md §16).
"""
from .endpoint import (ENDPOINT_ATTRS, PROGRESS_POLICIES,
                       STRIPE_POLICIES, Endpoint, EndpointSpec)
from .engine import ProgressEngine
from .fabric import (Fabric, MemoryRegion, PackedBurst, PendingBurst,
                     PendingOp, WireKind, WireMsg, as_bytes_view,
                     next_op_id, pack_payloads, payload_to_bytes,
                     payloads_to_bytes)
from .reliability import RELIABILITY_ATTRS, ReliabilityManager
from .rendezvous import RendezvousManager

__all__ = [
    "ENDPOINT_ATTRS", "Endpoint", "EndpointSpec", "Fabric", "MemoryRegion", "PendingOp",
    "PackedBurst", "PendingBurst", "pack_payloads",
    "ProgressEngine", "RELIABILITY_ATTRS", "ReliabilityManager",
    "RendezvousManager", "WireKind", "WireMsg",
    "PROGRESS_POLICIES", "STRIPE_POLICIES", "as_bytes_view", "next_op_id",
    "payload_to_bytes", "payloads_to_bytes",
]
