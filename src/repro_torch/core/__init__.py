"""LCI-X core on PyTorch — the paper's communication runtime.

The mirror of :mod:`repro.core` (the JAX package, which stays the
reference): the same public names with the same behaviour, on plain
PyTorch and numpy.  Payloads may be numpy arrays, bytes, or tensors; a
fused doorbell whose payloads are CUDA tensors is staged on the card by
the doorbell kernel (:mod:`repro_torch.kernels.doorbell`).

Ported so far: the host runtime's fused-doorbell message path over the
``sim``, ``shm`` and ``socket`` transports, the binary codec (the
reference's frames, byte for byte), the chaos and reliability planes,
``ProcessCluster``, and the functional ``Ring`` / ``SyncState`` /
``MatchTable`` mirrors (plain functions on tensors), and the in-graph
collectives (:mod:`.collectives`) on bound rank axes (:mod:`.axis`: over
the comm core's rank threads or ``torch.distributed``).
"""
from .attrs import (REGISTRY, AttrError, AttrResource, AttrSpec,
                    ResolvedAttrs, get_spec, parse_attr_args, register_attr,
                    registry_table, resolve, resolve_one,
                    resolved_from_values)
from . import collectives
from .axis import Axis, DistAxis, LciAxis
from .backlog import (BacklogQueue, Ring, init_ring, ring_pop, ring_push,
                      ring_size)
from .channels import Channel, Device, make_channels
from .concurrency import (LCQ, AtomicCounter, AtomicCredit, AtomicFlag,
                          ProgressWorkerPool, ThreadSafeCompletionQueue,
                          TryLock, aggregate_lock_stats)
from .completion import (CompletionHandler, CompletionObject, CompletionQueue,
                         MPMCArray, Synchronizer, SyncState, init_sync,
                         sync_ready, sync_signal)
from .graph import CompletionGraph
from .matching import (HostMatchingEngine, MatchKind, MatchTable,
                       MatchingPolicy, encode_key, init_table, insert,
                       insert_batch, make_key, pending_count, probe,
                       probe_batch)
from .modes import CommConfig, CommMode, parse_mode
from .off import OffBuilder, off
from .packet_pool import (HostPacketPool, SlotPool, free_count,
                          init_buffers, init_pool, pool_from_numpy,
                          pool_get, pool_get_copy_n, pool_get_n, pool_put,
                          pool_to_numpy)
from .post import (CommDesc, CommKind, Direction, PostBatch, classify,
                   post_am, post_am_x, post_comm, post_comm_x, post_get,
                   post_get_x, post_many, post_put, post_put_x, post_recv,
                   post_recv_x, post_send, post_send_x)
from .protocol import Protocol, ProtocolStats, select_protocol
from .progress import (Endpoint, EndpointSpec, Fabric, MemoryRegion,
                       PackedBurst, ProgressEngine, RendezvousManager,
                       WireKind, WireMsg, pack_payloads)
from .runtime import (LocalCluster, ProcessCluster, Runtime, g_runtime,
                      g_runtime_fina, g_runtime_init, progress, progress_x,
                      resolve_device)
from .telemetry import (NULL_TELEMETRY, MetricRegistry, Telemetry,
                        TraceBuffer, merge_snapshots, record_burst_mix,
                        render_block, summarize_spans)
from .transport import (Transport, backend_class, decode_msg, encode_msg,
                        make_transport, msg_weight, register_backend)
from .status import (ErrorCode, ErrorKind, FatalError, Status, done, posted,
                     retry)

__all__ = [
    # status
    "ErrorCode", "ErrorKind", "FatalError", "Status", "done", "posted",
    "retry",
    # unified attribute system (DESIGN.md §12)
    "REGISTRY", "AttrError", "AttrResource", "AttrSpec", "ResolvedAttrs",
    "get_spec", "parse_attr_args", "register_attr", "registry_table",
    "resolve", "resolve_one", "resolved_from_values",
    # resources
    "BacklogQueue", "Channel", "Device", "CompletionGraph",
    "CompletionHandler", "CompletionObject", "CompletionQueue", "MPMCArray",
    "Synchronizer", "HostMatchingEngine", "HostPacketPool",
    "MatchingPolicy", "MatchKind", "make_channels", "make_key",
    # functional resources (tensor mirrors)
    "Ring", "init_ring", "ring_push", "ring_pop", "ring_size",
    "SlotPool", "init_pool", "pool_get", "pool_put", "free_count",
    "pool_from_numpy", "pool_to_numpy",
    "MatchTable", "init_table", "insert", "insert_batch", "encode_key",
    "pending_count", "probe", "probe_batch",
    "SyncState", "init_sync", "sync_signal", "sync_ready",
    # posting
    "CommKind", "Direction", "classify", "post_comm", "post_comm_x",
    "post_send", "post_send_x", "post_recv", "post_recv_x", "post_am",
    "post_am_x", "post_put", "post_put_x", "post_get", "post_get_x",
    # burst posting (paper §4.3 batched data plane)
    "CommDesc", "PostBatch", "post_many", "pool_get_n",
    # fused doorbells (DESIGN.md §13)
    "PackedBurst", "pack_payloads", "pool_get_copy_n", "init_buffers",
    # runtime + progress subsystem
    "Fabric", "LocalCluster", "MemoryRegion", "Runtime", "WireKind",
    "WireMsg", "g_runtime", "g_runtime_fina", "g_runtime_init", "progress",
    "progress_x", "Endpoint", "EndpointSpec", "ProgressEngine",
    "RendezvousManager", "resolve_device",
    # pluggable transport backends (DESIGN.md §14)
    "Transport", "ProcessCluster", "backend_class", "decode_msg",
    "encode_msg", "make_transport", "msg_weight", "register_backend",
    # in-graph collectives on bound rank axes
    "collectives", "Axis", "DistAxis", "LciAxis",
    # modes & protocol
    "CommConfig", "CommMode", "parse_mode", "Protocol", "ProtocolStats",
    "select_protocol", "off", "OffBuilder",
    # concurrency subsystem (paper §4.1)
    "AtomicCounter", "AtomicCredit", "AtomicFlag", "LCQ",
    "ProgressWorkerPool", "ThreadSafeCompletionQueue", "TryLock",
    "aggregate_lock_stats",
    # telemetry plane (DESIGN.md §15)
    "NULL_TELEMETRY", "MetricRegistry", "Telemetry", "TraceBuffer",
    "merge_snapshots", "record_burst_mix", "render_block",
    "summarize_spans",
]
