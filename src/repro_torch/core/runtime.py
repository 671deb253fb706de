"""LCI-X runtime — resource lifecycle: runtimes, devices, endpoints, clusters.

Mirrors the paper's runtime lifecycle (§3.2.2): no global init/fina;
instead runtime objects are allocated/freed, and multiple runtimes can
coexist (library composition).  :class:`LocalCluster` simulates the paper's
*thread mode* faithfully: all ranks live in one address space (exactly like
threads of one process), each with its own :class:`Runtime` holding
replicable resources (devices, matching engine, packet pool, CQs).

Everything that *moves data* lives in :mod:`repro_torch.core.progress`:

* the fabric and wire format          -> ``progress/fabric.py``
* posting + the Figure-1 chain        -> ``progress/engine.py``
* rendezvous (RTS/CTS/RDMA) and RMA   -> ``progress/rendezvous.py``
* multi-device striped endpoints      -> ``progress/endpoint.py``

This module only allocates, wires together, and frees those resources —
plus the thin delegation (``Runtime._post`` / ``Runtime.progress``) that
keeps the paper's Listing-2 call surface on the runtime object.

Every runtime is bound to one torch device (``device=``, default
``"cuda"``): CUDA tensor payloads must live there, and a fused doorbell
of them is staged there by the doorbell kernel.  The device is a
constructor argument, not an attr, so the attr registry stays equal to
the reference's.  :class:`ProcessCluster` binds its one rank the same
way: each OS process of an SPMD job posts CUDA payloads on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from . import attrs as _attrs
from .channels import DEVICE_ATTRS, Device
from .completion import (CompletionHandler, CompletionObject, CompletionQueue,
                         MPMCArray, Synchronizer)
from .concurrency import ProgressWorkerPool, ThreadSafeCompletionQueue
from .graph import CompletionGraph
from .matching import HostMatchingEngine
from .modes import _FIELD_TO_ATTR, CommConfig
from .off import off
from .packet_pool import POOL_ATTRS, HostPacketPool
from .protocol import ProtocolStats
from .status import ErrorCode, FatalError, Status, err
from .telemetry import Telemetry, merge_snapshots

#: runtime-level attrs one Runtime resolves at construction
RUNTIME_ATTRS = ("mode", "n_channels", "eager_max_bytes", "rdv_threshold",
                 "wire_bf16", "doorbell_fused", "fused_min_burst",
                 "matching_buckets", "matching_locks",
                 "packets_per_lane", "packet_bytes", "pool_lanes",
                 "telemetry_level", "trace_capacity")
# Re-exported names that historically lived here (public API compatibility).
from .progress import (ENDPOINT_ATTRS, RELIABILITY_ATTRS, Endpoint,
                       EndpointSpec, Fabric, MemoryRegion,
                       PendingOp, ProgressEngine, ReliabilityManager,
                       RendezvousManager,
                       WireKind, WireMsg, as_bytes_view, payload_to_bytes)
from .transport import (CHAOS_ATTRS, FABRIC_ATTRS, ChaosTransport, Transport,
                        make_transport, maybe_wrap_chaos)

# back-compat aliases for the old private helpers
_as_bytes_view = as_bytes_view
_payload_to_bytes = payload_to_bytes


def resolve_device(device=None) -> torch.device:
    """The torch device a runtime is bound to: ``"cuda"`` unless the
    caller asks for another.  A CUDA request with no GPU present raises —
    there is no silent CPU run; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise FatalError("no CUDA device is available; pass "
                             "device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise FatalError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _resolve_worker_args(layer: Mapping, n_workers: Optional[int],
                         burst: Optional[int]) -> tuple:
    """Resolve alloc_workers knobs through the chain; attr ``n_workers``
    0 means "auto" = the historical pool default of 2."""
    explicit = {k: v for k, v in (("n_workers", n_workers),
                                  ("worker_burst", burst)) if v is not None}
    r = _attrs.resolve(("n_workers", "worker_burst"), runtime=layer,
                       overrides=explicit)
    return r["n_workers"] or 2, r["worker_burst"]


class Runtime(_attrs.AttrResource):
    """One rank's LCI runtime: the replicable resource set.

    Posting and progress are delegated to the default
    :class:`~repro_torch.core.progress.ProgressEngine`; dedicated engines (and
    multi-device striping) are allocated through :meth:`alloc_endpoint`.

    Every ``alloc_*`` resolves its knobs through the four-layer attribute
    chain (DESIGN.md §12): library defaults → ``REPRO_ATTR_*`` env →
    this runtime's config layer (``LocalCluster(attrs=...)`` merged with
    explicit ``CommConfig`` fields) → per-call named-argument overrides.
    """

    def __init__(self, rank: int, cluster: "LocalCluster",
                 config: Optional[CommConfig] = None, device=None):
        self.rank = rank
        self.cluster = cluster
        # torch device this rank's CUDA payloads live on (the cluster's
        # unless given); CUDA without a GPU raises
        self.device = resolve_device(
            device if device is not None else cluster.device)
        # the runtime-level layer feeding every per-resource resolution
        if config is None:
            self._attr_layer: Dict[str, Any] = dict(cluster._attr_layer)
            self.config = cluster.config
        else:
            # a per-rank config's explicit fields override the cluster
            # layer — and the effective config must be rebuilt from the
            # merge, so the data path (select_protocol reads
            # config.inject_max_bytes) agrees with introspection
            self._attr_layer = {**cluster._attr_layer,
                                **config.explicit_attrs()}
            self.config = CommConfig(**{
                f: self._attr_layer[a] for f, a in _FIELD_TO_ATTR.items()
                if a in self._attr_layer})
        resolved = _attrs.resolve(RUNTIME_ATTRS, runtime=self._attr_layer)
        self._init_attrs(resolved)
        # data-plane flags cached as plain fields: the fused doorbell path
        # (DESIGN.md §13) reads them per burst, so no attr-chain lookup on
        # the hot path
        self.doorbell_fused: bool = resolved["doorbell_fused"]
        self.fused_min_burst: int = resolved["fused_min_burst"]
        self.wire_bf16: bool = resolved["wire_bf16"]
        # observability hub (DESIGN.md §15): share the cluster's telemetry
        # unless this rank's resolved level differs (per-rank override)
        ctele = getattr(cluster, "tele", None)
        if ctele is not None and ctele.level == resolved["telemetry_level"]:
            self.tele = ctele
        else:
            self.tele = Telemetry(resolved["telemetry_level"],
                                  resolved["trace_capacity"])
        # resources (all replicable; these are the process-default set)
        self.matching = HostMatchingEngine(
            resolved["matching_buckets"], resolved["matching_locks"],
            resolved=resolved.subset(("matching_buckets",
                                      "matching_locks")),
            tele=self.tele)
        self.packet_pool = HostPacketPool(
            n_lanes=resolved["pool_lanes"] or max(1, resolved["n_channels"]),
            packets_per_lane=resolved["packets_per_lane"],
            packet_bytes=resolved["packet_bytes"],
            resolved=resolved.subset(POOL_ATTRS),
            tele=self.tele)
        self.rcomp_registry = MPMCArray()      # paper §4.1.1 MPMC array
        self.memory_regions = MPMCArray()
        self.devices: List[Device] = []
        self._next_device_index = 0
        self.stats = ProtocolStats()
        # shared per-rank op state the engines operate on
        self.pending_ops: Dict[int, PendingOp] = {}
        self.rdv = RendezvousManager(self)
        # reliability plane (DESIGN.md §16): armed explicitly via the
        # ``reliability`` attr, or automatically when the cluster fabric
        # is a message-faulting chaos transport — the zero-fault default
        # stays rel-free and byte-identical to the pre-chaos engine
        self.dead_peers: set = set()
        relr = _attrs.resolve(RELIABILITY_ATTRS, runtime=self._attr_layer)
        fabric = cluster.fabric
        chaos_faults = (isinstance(fabric, ChaosTransport)
                        and fabric.cfg.faults_messages)
        mode = relr["reliability"]
        self.rel = (ReliabilityManager(self, relr)
                    if mode == "on" or (mode == "auto" and chaos_faults)
                    else None)
        self.engine = ProgressEngine(self, name=f"rank{rank}/shared")
        self.endpoints: List[Endpoint] = []
        self.default_device = self.alloc_device(lane=0)
        # fold this rank's long-standing counters into the unified
        # telemetry snapshot (DESIGN.md §15: the registry is the one
        # read surface; the legacy accessors keep their storage)
        self.tele.attach("protocol", self._protocol_counters)
        self.tele.attach("device", self._device_counters)
        self.tele.attach("engine", lambda: {
            "passes": self.engine.passes,
            "reactions": self.engine.reactions,
            "burst_posts": self.engine.burst_posts})
        self.tele.attach("pool", self.packet_pool.telemetry_counters)
        self.tele.attach("matching", self.matching.telemetry_counters)
        if self.rel is not None:
            self.tele.attach("reliability", self.rel.counters)
        # read-only discovered attributes (LCI get_attr_* mirror)
        self._export_attr("rank_me", lambda: self.rank)
        self._export_attr("rank_n", lambda: self.cluster.n_ranks)
        self._export_attr("n_devices", lambda: len(self.devices))
        self._export_attr("n_endpoints", lambda: len(self.endpoints))
        self._export_attr("free_packets", self.packet_pool.free_packets)
        self._export_attr("telemetry", self.tele.snapshot)

    def _protocol_counters(self) -> Dict[str, int]:
        import dataclasses as _dc
        return _dc.asdict(self.stats)

    def _device_counters(self) -> Dict[str, int]:
        out = {"posts": 0, "pushes": 0, "progresses": 0,
               "lock_acquisitions": 0, "lock_contentions": 0}
        for dev in self.devices:
            out["posts"] += dev.posts
            out["pushes"] += dev.pushes
            out["progresses"] += dev.progresses
            out["lock_acquisitions"] += dev.progress_lock.acquisitions
            out["lock_contentions"] += dev.progress_lock.contentions
        return out

    # -- rank death (DESIGN.md §16) ------------------------------------------
    def mark_peer_dead(self, rank: int) -> None:
        """Declare ``rank`` dead: future posts toward it fail at post
        time with ``err(ERR_PEER_DEAD)``, queued recvs naming it are
        withdrawn and err-signaled, and the reliability layer (when
        armed) fails its unacked window on the next sweep.  Idempotent;
        typically driven by the spmd heartbeat watchdog."""
        if rank == self.rank:
            raise FatalError("a rank cannot declare itself dead")
        if not 0 <= rank < self.n_ranks:
            raise FatalError(f"bad rank {rank}")
        if rank in self.dead_peers:
            return
        self.dead_peers.add(rank)
        for value in self.matching.extract_recvs_for_rank(rank):
            _, buf, comp, rdev = value
            self.engine.signal(
                comp, err(ErrorCode.ERR_PEER_DEAD, rank=rank), rdev)
        if self.rel is not None:
            self.rel.kill_peer(rank)

    # -- rank / fabric queries ----------------------------------------------
    def get_rank_me(self) -> int:
        return self.rank

    def get_rank_n(self) -> int:
        return self.cluster.n_ranks

    @property
    def n_ranks(self) -> int:
        return self.cluster.n_ranks

    @property
    def fabric(self) -> Fabric:
        return self.cluster.fabric

    # -- resource allocation -------------------------------------------------
    def alloc_device(self, lane: Optional[int] = None,
                     **overrides) -> Device:
        """Allocate one device; ``**overrides`` are per-resource attribute
        overrides (``n_channels``, ``backlog_capacity``, ``cq_capacity``)
        validated against the registry at alloc time."""
        resolved = _attrs.resolve(DEVICE_ATTRS, runtime=self._attr_layer,
                                  overrides=overrides)
        dev = Device(self.config,
                     lane=(lane if lane is not None
                           else len(self.devices) % self.packet_pool.n_lanes),
                     resolved=resolved, tele=self.tele)
        # indices are never reused: a fabric stream keyed by a freed
        # device's index must not silently alias a later allocation
        dev.index = self._next_device_index
        self._next_device_index += 1
        self.devices.append(dev)
        return dev

    def _check_device_freeable(self, device: Device) -> None:
        if device is self.default_device:
            raise FatalError("cannot free the default device")
        if not device.backlog.empty_flag or device.pending_tx:
            raise FatalError("cannot free a device with backlogged or "
                             "in-flight operations")
        if device.index in self.fabric.pending_streams(self.rank):
            raise FatalError("cannot free a device with undrained incoming "
                             "traffic (progress it first)")

    def free_device(self, device: Device) -> None:
        self._check_device_freeable(device)
        self.devices.remove(device)

    def alloc_endpoint(self, n_devices: Optional[int] = None,
                       stripe: Optional[str] = None,
                       progress: Optional[str] = None,
                       name: Optional[str] = None, *,
                       spec: Optional[EndpointSpec] = None,
                       n_workers: Optional[int] = None,
                       worker_burst: Optional[int] = None,
                       size_boundaries=None) -> Endpoint:
        """Allocate a named multi-device endpoint (paper §3.2.3: devices
        are replicable and incrementally tunable).  Pass the knobs (each
        ``None`` resolves through the attribute chain) or a prebuilt
        :class:`EndpointSpec` (already resolved at its construction)."""
        if spec is None:
            explicit = {k: v for k, v in
                        (("n_devices", n_devices), ("stripe", stripe),
                         ("progress", progress), ("n_workers", n_workers),
                         ("worker_burst", worker_burst))
                        if v is not None}
            spec, resolved = self._materialize_spec(
                name or f"rank{self.rank}/ep{len(self.endpoints)}",
                explicit, size_boundaries)
        else:
            # a prebuilt spec pins only the fields its caller set
            # explicitly ("resource" source); everything it left to
            # defaults stays tunable through this runtime's attrs layer
            explicit = {a: spec._resolved_attrs[a] for a in ENDPOINT_ATTRS
                        if spec._resolved_attrs.source(a) == "resource"}
            spec, resolved = self._materialize_spec(
                spec.name, explicit, spec.size_boundaries)
        ep = Endpoint(self, spec, resolved=resolved)
        self.endpoints.append(ep)
        return ep

    def _materialize_spec(self, name: str, explicit: Dict[str, Any],
                          size_boundaries) -> tuple:
        """Resolve endpoint attrs through the full chain and build the
        concrete spec.  An ambient (env/runtime-layer) n_workers only
        applies to workers-mode endpoints — it is zeroed elsewhere, and
        the stored resolution is kept in sync so introspection reports
        what the endpoint actually runs with; an explicit n_workers on a
        non-worker endpoint still errors in EndpointSpec."""
        resolved = _attrs.resolve(ENDPOINT_ATTRS, runtime=self._attr_layer,
                                  overrides=explicit)
        vals = {a: resolved[a] for a in ENDPOINT_ATTRS}
        if vals["progress"] != "workers" and "n_workers" not in explicit:
            vals["n_workers"] = 0
            resolved = resolved.merged(_attrs.ResolvedAttrs(
                {"n_workers": 0},
                {"n_workers": resolved.source("n_workers")}))
        spec = EndpointSpec(name=name, size_boundaries=size_boundaries,
                            **vals)
        return spec, resolved

    def free_endpoint(self, ep: Endpoint) -> None:
        # a live worker pool must be quiesced before its devices go away
        ep.stop_workers()
        # validate every device BEFORE mutating: a busy device must not
        # leave the endpoint half-freed
        for dev in ep.devices:
            self._check_device_freeable(dev)
        for dev in ep.devices:
            self.devices.remove(dev)
        self.endpoints.remove(ep)

    def alloc_engine(self, devices: Optional[List[Device]] = None,
                     name: str = "engine") -> ProgressEngine:
        return ProgressEngine(self, devices, name=name)

    def alloc_workers(self, n_workers: Optional[int] = None, *,
                      burst: Optional[int] = None) -> ProgressWorkerPool:
        """A worker pool over this runtime's current devices, driven by
        the shared engine (paper §4.2.3 multithreaded progress).  The
        caller owns the lifecycle: ``with rt.alloc_workers(4): ...``.
        ``n_workers``/``burst`` resolve through the attribute chain
        (attrs ``n_workers`` — 0 = the pool default of 2 — and
        ``worker_burst``)."""
        n, b = _resolve_worker_args(self._attr_layer, n_workers, burst)
        return ProgressWorkerPool.for_runtime(self, n, burst=b)

    # Completion-object allocation (paper §3.2.5): every alloc_* handle
    # satisfies the unified comp protocol — signal(Status) -> Status,
    # non-blocking test(), progress-driven wait().
    def alloc_cq(self, capacity: Optional[int] = None, *,
                 threadsafe: bool = False) -> CompletionObject:
        """``threadsafe=True`` returns the LCQ-backed queue (paper §4.1.4
        FAA array) — required when worker threads signal or drain it.
        ``capacity`` resolves through the attribute chain (attr
        ``cq_capacity``; 0 = unbounded)."""
        overrides = {} if capacity is None else {"cq_capacity": capacity}
        resolved = _attrs.resolve(("cq_capacity",),
                                  runtime=self._attr_layer,
                                  overrides=overrides)
        cap = resolved["cq_capacity"] or None
        if threadsafe:
            return ThreadSafeCompletionQueue(cap, resolved=resolved,
                                             tele=self.tele)
        return CompletionQueue(cap, resolved=resolved, tele=self.tele)

    def alloc_handler(self, fn: Callable[[Status], None]) -> CompletionHandler:
        return CompletionHandler(fn)

    def alloc_sync(self, expected: int = 1) -> Synchronizer:
        return Synchronizer(expected)

    def alloc_graph(self, name: str = "graph") -> CompletionGraph:
        g = CompletionGraph(name)
        g.add_progress(self.cluster)   # default driver for wait()/execute()
        return g

    def free_comp(self, comp: CompletionObject) -> None:
        pass                                    # GC does the freeing

    def register_rcomp(self, comp: CompletionObject) -> int:
        """Register a completion object for *remote* signaling; returns the
        remote completion handle other ranks pass to post_am/put-signal."""
        return self.rcomp_registry.append(comp)

    def register_memory(self, buf: Any) -> MemoryRegion:
        view = as_bytes_view(buf)
        region = MemoryRegion(rid=len(self.memory_regions), buf=view)
        self.memory_regions.append(region)
        return region

    # -- posting / progress: thin delegation to the default engine -----------
    def _post(self, **kwargs) -> Status:
        return self.engine.post(**kwargs)

    def post_many(self, ops, *, endpoint: Optional[Endpoint] = None,
                  device: Optional[Device] = None) -> List[Status]:
        """Burst posting (paper §4.3): coalesce a sequence of ops
        (:class:`~repro_torch.core.post.CommDesc` or unfired ``post_*_x``
        builders) into per-device doorbells — see
        :func:`repro_torch.core.post.post_many`."""
        from .post import post_many as _post_many
        return _post_many(self, ops, endpoint=endpoint, device=device)

    def progress(self, device: Optional[Device] = None,
                 max_msgs: int = 0) -> bool:
        return self.engine.progress(device, max_msgs)

    # back-compat: rendezvous landing zones (CTS handshake state)
    @property
    def _rendezvous_landing(self) -> list:
        return self.rdv.landing

    @property
    def _pending(self) -> Dict[int, PendingOp]:
        return self.pending_ops


# -- module-level progress with the paper's OFF spelling --------------------
#    lci::progress_x().device(device)()

@off
def progress(runtime: Runtime, device: Optional[Device] = None,
             max_msgs: int = 0) -> bool:
    return runtime.progress(device=device, max_msgs=max_msgs)


progress_x = progress.x


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

class LocalCluster(_attrs.AttrResource):
    """All ranks in one address space — the paper's thread-mode testbed.

    ``link_latency`` (seconds) makes the simulated wire take time: pushed
    messages become drainable only after the latency elapses.  Zero (the
    default) keeps the instant fabric; the multithreaded benchmarks use a
    real latency so completion windows model flow control.

    ``attrs`` is the **runtime-level config layer** of the attribute chain
    (DESIGN.md §12): a mapping of attribute names to values that every
    rank's ``alloc_*`` resolves beneath per-call overrides but above
    ``REPRO_ATTR_*`` env and library defaults.  Explicit ``CommConfig``
    fields join the same layer (the ``attrs`` mapping wins on conflict);
    ``fabric_depth``/``link_latency`` constructor args are the cluster's
    own per-resource overrides for its fabric.
    """

    def __init__(self, n_ranks: int, config: Optional[CommConfig] = None,
                 fabric_depth: Optional[int] = None,
                 link_latency: Optional[float] = None,
                 attrs: Optional[Mapping[str, Any]] = None,
                 fabric_backend: Optional[str] = None, device=None):
        self.n_ranks = n_ranks
        self.device = resolve_device(device)
        config = config or CommConfig()
        # the runtime-level layer: explicit config fields, then the attrs
        # mapping (validated against the registry — unknown names raise)
        self._attr_layer: Dict[str, Any] = {**config.explicit_attrs(),
                                            **_attrs._canonicalize(attrs)}
        for key in self._attr_layer:
            _attrs.get_spec(key)
        # rebuild the effective config so field reads
        # (config.inject_max_bytes, ...) reflect the merged layer
        config_layer = {f: self._attr_layer[a]
                        for f, a in _FIELD_TO_ATTR.items()
                        if a in self._attr_layer}
        self.config = CommConfig(**config_layer)
        fabric_overrides = {k: v for k, v in
                            (("fabric_depth", fabric_depth),
                             ("link_latency", link_latency),
                             ("fabric_backend", fabric_backend))
                            if v is not None}
        # FABRIC_ATTRS includes fabric_backend: an unknown backend name
        # raises AttrError right here, at alloc time
        fr = _attrs.resolve(FABRIC_ATTRS, runtime=self._attr_layer,
                            overrides=fabric_overrides)
        rr = _attrs.resolve(RUNTIME_ATTRS, runtime=self._attr_layer)
        # the cluster-wide telemetry hub: every rank's runtime shares it
        # unless a per-rank config resolves a different level
        self.tele = Telemetry(rr["telemetry_level"], rr["trace_capacity"])
        self.fabric = make_transport(
            fr["fabric_backend"], n_ranks, depth=fr["fabric_depth"],
            latency=fr["link_latency"], resolved=fr,
            ring_bytes=fr["shm_ring_bytes"], **self._transport_extra())
        # chaos plane (DESIGN.md §16): an active chaos_* config wraps the
        # backend in the fault-injecting transport; the zero-fault
        # default returns the backend untouched
        cr = _attrs.resolve(CHAOS_ATTRS, runtime=self._attr_layer)
        self.fabric = maybe_wrap_chaos(self.fabric, cr)
        self.fabric.set_telemetry(self.tele)
        self._init_attrs(fr.merged(rr).merged(cr))
        self._export_attr("rank_n", lambda: self.n_ranks)
        self._export_attr("in_flight", self.fabric.in_flight)
        self._export_attr("telemetry", self.telemetry_snapshot)
        self.runtimes = [Runtime(r, self) for r in self._local_ranks()]

    def _transport_extra(self) -> Dict[str, Any]:
        """Extra make_transport kwargs; the base cluster is solo-mode (all
        ranks in-process), so cross-process identity stays unset."""
        return {}

    def _local_ranks(self):
        """Which ranks live in this process (all of them here)."""
        return range(self.n_ranks)

    def local_runtimes(self) -> List[Runtime]:
        return list(self.runtimes)

    def __getitem__(self, rank: int) -> Runtime:
        return self.runtimes[rank]

    def close(self) -> None:
        """Release transport OS resources (idempotent; a no-op for the
        in-process sim backend)."""
        self.fabric.close()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def alloc_endpoint(self, n_devices: Optional[int] = None,
                       stripe: Optional[str] = None,
                       progress: Optional[str] = None,
                       name: str = "endpoint",
                       **overrides) -> List[Endpoint]:
        """Allocate a symmetric endpoint on every rank (device streams are
        matched by index, so peers must replicate the same bundle shape);
        returns the per-rank endpoints, indexed by rank."""
        return [rt.alloc_endpoint(n_devices, stripe, progress,
                                  name=f"{name}@{rt.rank}", **overrides)
                for rt in self.runtimes]

    def alloc_workers(self, n_workers: Optional[int] = None, *,
                      burst: Optional[int] = None) -> "ProgressWorkerPool":
        """A worker pool spanning every rank's devices — the paper's
        thread-mode testbed with real threads driving all progress."""
        n, b = _resolve_worker_args(self._attr_layer, n_workers, burst)
        return ProgressWorkerPool.for_cluster(self, n, burst=b)

    def telemetry_snapshot(self) -> Dict:
        """The cluster-wide telemetry document: every distinct hub across
        the local runtimes (ranks overriding ``telemetry_level`` own their
        own), merged elementwise — the same shape
        :func:`repro_torch.core.telemetry.merge_snapshots` gives an SPMD
        aggregation, so local and multi-process reads are uniform."""
        teles = {id(self.tele): self.tele}
        for rt in self.local_runtimes():
            teles.setdefault(id(rt.tele), rt.tele)
        return merge_snapshots([t.snapshot() for t in teles.values()])

    def export_trace(self, path: str) -> str:
        """Dump the Chrome trace (``telemetry_level=trace`` runs)."""
        return self.tele.export_trace(path)

    def progress_all(self, rounds: int = 1) -> int:
        """Drive every device of every rank; returns #work events."""
        n = 0
        for _ in range(rounds):
            for rt in self.local_runtimes():
                for dev in rt.devices:
                    n += bool(rt.progress(dev))
        return n

    def quiesce(self, max_rounds: int = 10_000) -> None:
        """Progress until no work remains (test/benchmark helper)."""
        import time as _time
        rels = [rt.rel for rt in self.local_runtimes()
                if rt.rel is not None]
        for _ in range(max_rounds):
            if not self.progress_all():
                if self.fabric.in_flight() == 0 \
                        and not any(r.busy() for r in rels):
                    return
                # messages still on the (latency-modeled) wire, held by
                # the chaos stash, or waiting out a reliability backoff
                # timer: sleep rather than declaring quiet — rel backoff
                # needs a coarser tick than the latency model
                _time.sleep(max(self.fabric.latency / 4,
                                1e-4 if rels else 1e-5))
        raise FatalError("cluster failed to quiesce")


class ProcessCluster(LocalCluster):
    """One rank of an N-process SPMD job — the paper's *process mode*.

    Each OS process holds exactly one :class:`Runtime` (its rank) and a
    cross-process transport (``shm`` rings or ``socket`` frames) to its
    peers.  Construction mirrors :class:`LocalCluster`; ``rank`` and the
    shared ``session`` (a directory name both sides derive ring/socket
    paths from) normally arrive from :mod:`repro_torch.launch.spmd` via
    the ``REPRO_SPMD_*`` environment, so benchmark code can build either
    cluster shape from the same attrs.  The frames are the reference's,
    so a rank of either package can join the same session.

    ``device`` binds the rank as :class:`LocalCluster` does: the card
    unless the caller asks for the CPU.

    ``runtimes`` maps rank → Runtime and holds only this process's rank;
    ``cluster[r]`` for a remote rank raises — remote state is another
    process's business.
    """

    def __init__(self, n_ranks: int, rank: int,
                 config: Optional[CommConfig] = None,
                 fabric_depth: Optional[int] = None,
                 link_latency: Optional[float] = None,
                 attrs: Optional[Mapping[str, Any]] = None,
                 fabric_backend: Optional[str] = None,
                 session: Optional[str] = None, device=None):
        if not 0 <= rank < n_ranks:
            raise FatalError(f"rank {rank} out of range for {n_ranks} ranks")
        self.rank_me = rank
        self._session = session
        super().__init__(n_ranks, config, fabric_depth, link_latency,
                         attrs, fabric_backend, device=device)
        self.runtimes = {rt.rank: rt for rt in self.runtimes}
        self._export_attr("rank_me", lambda: self.rank_me)

    def _transport_extra(self) -> Dict[str, Any]:
        return {"rank": self.rank_me, "session": self._session}

    def _local_ranks(self):
        return (self.rank_me,)

    def local_runtimes(self) -> List[Runtime]:
        return list(self.runtimes.values())

    @property
    def runtime(self) -> Runtime:
        """This process's one runtime."""
        return self.runtimes[self.rank_me]

    def __getitem__(self, rank: int) -> Runtime:
        if rank != self.rank_me:
            raise FatalError(
                f"rank {rank} lives in another process (this is rank "
                f"{self.rank_me}); only the local runtime is addressable")
        return self.runtimes[rank]


# -- module-level convenience (paper's g_runtime) ---------------------------

_g_cluster: Optional[LocalCluster] = None


def g_runtime_init(n_ranks: int = 1,
                   config: Optional[CommConfig] = None,
                   attrs: Optional[Mapping[str, Any]] = None,
                   device=None) -> LocalCluster:
    global _g_cluster
    _g_cluster = LocalCluster(n_ranks, config, attrs=attrs, device=device)
    return _g_cluster


def g_runtime() -> LocalCluster:
    if _g_cluster is None:
        raise FatalError("g_runtime_init has not been called")
    return _g_cluster


def g_runtime_fina() -> None:
    global _g_cluster
    _g_cluster = None
