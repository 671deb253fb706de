"""Endpoints — named, striped bundles of devices with a progress policy.

The paper's central design point (§3.2.3) is that communication resources
are *replicable and incrementally tunable*: a workload that is bottlenecked
on one NIC queue pair allocates more devices and stripes traffic across
them.  An :class:`Endpoint` makes that a first-class API object (per the
AMT-interface argument that the resource group should not be an implicit
global): it owns ``n_devices`` devices on one runtime, a **striping
policy** deciding which device each posted operation rides, and a
**progress policy** deciding who drives them:

* stripe ``"round_robin"`` — ops rotate across devices (max throughput for
  homogeneous traffic);
* stripe ``"by_peer"`` — device = f(target rank): all traffic to one peer
  stays ordered on one stream;
* stripe ``"by_size"`` — size classes get their own devices so small
  latency-sensitive messages (decode tokens) never queue behind bulk
  transfers (prefill prompts) — the paper's "new possibilities" scenario;

* progress ``"shared"`` — the runtime's single engine drives all devices
  (the paper's shared-resource thread mode);
* progress ``"dedicated"`` — one :class:`~.engine.ProgressEngine` per
  device (the dedicated mode that scales with threads);
* progress ``"workers"`` — ``n_workers`` real threads drive the
  endpoint's engines concurrently through per-device try-locks (the
  paper's §4.2.3 multithreaded progress discipline: a thread that fails
  a device's try-lock moves on to the next device).  Start them with
  ``ep.start_workers()`` (or use the endpoint as a context manager) and
  stop with ``ep.stop_workers()``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import attrs as _attrs
from ..attrs import AttrError
from ..concurrency.locks import aggregate_lock_stats
from ..concurrency.workers import ProgressWorkerPool
from ..matching import MatchingPolicy
from ..modes import CommMode
from ..post import (CommDesc, CommKind, post_am_x, post_get_x, post_put_x,
                    post_recv_x, post_send_x)
from ..post import post_comm as _post_comm
from ..post import post_many as _post_many
from ..protocol import Protocol, select_protocol
from ..status import FatalError, Status
from .engine import ProgressEngine

STRIPE_POLICIES = _attrs.get_spec("stripe").choices
PROGRESS_POLICIES = _attrs.get_spec("progress").choices

#: payload types a uniform burst may be lowered from directly: numpy
#: arrays and tensors (CUDA tensors reach the doorbell kernel this way)
_ARRAYS = (np.ndarray, torch.Tensor)

#: the attrs an endpoint resolves at alloc time
ENDPOINT_ATTRS = ("n_devices", "stripe", "progress", "n_workers",
                  "worker_burst")


@dataclasses.dataclass(frozen=True)
class EndpointSpec(_attrs.AttrResource):
    """Declarative endpoint description — what a layer *asks for*.

    A thin view over resolved attributes (DESIGN.md §12): every shape
    field defaults to ``None`` = "resolve through the attribute chain"
    (library default, then ``REPRO_ATTR_*``), and explicit fields are
    validated at construction with errors naming the attribute.  Carried
    by config objects (e.g. ``distributed.Comm``) that cannot hold live
    devices; ``Runtime.alloc_endpoint(spec=...)`` materializes it.
    """

    name: str = "endpoint"
    n_devices: Optional[int] = None
    stripe: Optional[str] = None
    progress: Optional[str] = None
    # workers mode: thread count driving the endpoint's devices
    # (0 = auto: one worker per device)
    n_workers: Optional[int] = None
    # by_size boundaries (bytes): size class i = first boundary >= size;
    # None derives geometric classes from the runtime's protocol thresholds.
    size_boundaries: Optional[Sequence[int]] = None
    # wire messages drained per progress-lock grab in workers mode
    worker_burst: Optional[int] = None

    def __post_init__(self):
        explicit = {a: getattr(self, a) for a in ENDPOINT_ATTRS
                    if getattr(self, a) is not None}
        resolved = _attrs.resolve(ENDPOINT_ATTRS, overrides=explicit)
        self._init_attrs(resolved)
        for attr in ENDPOINT_ATTRS:
            object.__setattr__(self, attr, resolved[attr])
        if self.n_workers and self.progress != "workers":
            if resolved.source("n_workers") == "resource":
                raise AttrError("attribute 'n_workers' only applies to "
                                "progress='workers', got progress="
                                f"{self.progress!r}")
            # an env/runtime-layer worker count is ambient tuning, not a
            # request for workers mode: inert on non-worker endpoints.
            # The stored resolution must agree with what the endpoint
            # actually runs with, so zero it there too.
            object.__setattr__(self, "n_workers", 0)
            self._init_attrs(resolved.merged(_attrs.ResolvedAttrs(
                {"n_workers": 0},
                {"n_workers": resolved.source("n_workers")})))
        if self.size_boundaries is not None:
            bounds = tuple(self.size_boundaries)
            if any(b < 0 for b in bounds):
                raise AttrError("attribute 'size_boundaries' must be "
                                f"non-negative byte sizes, got {bounds}")
            object.__setattr__(self, "size_boundaries", bounds)
        self._export_attr("size_boundaries", lambda: self.size_boundaries)

    @classmethod
    def for_mode(cls, mode: CommMode, n_devices: int = 1,
                 name: str = "endpoint", stripe: str = "round_robin"
                 ) -> "EndpointSpec":
        """Map the paper's shared/dedicated mode split onto a spec."""
        if mode == CommMode.LCI_DEDICATED and n_devices > 1:
            return cls(name=name, n_devices=n_devices, stripe=stripe,
                       progress="dedicated")
        return cls(name=name, n_devices=max(1, n_devices), stripe=stripe,
                   progress="shared")


class Endpoint(_attrs.AttrResource):
    """A live bundle of devices on one runtime, posting through a stripe."""

    def __init__(self, runtime, spec: EndpointSpec,
                 resolved: Optional[_attrs.ResolvedAttrs] = None):
        self.runtime = runtime
        self.spec = spec
        self.devices = [runtime.alloc_device()
                        for _ in range(spec.n_devices)]
        self.workers: Optional[ProgressWorkerPool] = None
        if spec.progress in ("dedicated", "workers"):
            self.engines = [ProgressEngine(runtime, [d],
                                           name=f"{spec.name}/dev{i}")
                            for i, d in enumerate(self.devices)]
        else:
            self.engines = [runtime.engine]
        if spec.progress == "workers":
            self.workers = ProgressWorkerPool(
                list(zip(self.engines, self.devices)),
                n_workers=spec.n_workers or spec.n_devices,
                name=f"{spec.name}/workers", burst=spec.worker_burst,
                tele=getattr(runtime, "tele", None))
        self._rr = 0
        if spec.size_boundaries is not None:
            self._boundaries = list(spec.size_boundaries)
        else:
            # geometric classes seeded by the protocol thresholds: class 0
            # holds inject-able messages, each further class 8x larger
            self._boundaries = [runtime.config.inject_max_bytes * (8 ** i)
                                for i in range(spec.n_devices - 1)]
        # introspection: the alloc-time resolution (full provenance when
        # allocated through Runtime.alloc_endpoint) plus discovered state
        self._init_attrs(resolved or spec._resolved_attrs)
        self._export_attr("width", lambda: len(self.devices))
        self._export_attr("size_boundaries", lambda: list(self._boundaries))
        self._export_attr("device_indices",
                          lambda: [d.index for d in self.devices])
        self._export_attr("contention", self._contention)
        self._export_attr("telemetry", self._telemetry_block)

    def _telemetry_block(self) -> dict:
        """This endpoint's contribution to the unified snapshot: its
        devices' counters plus the bundle's progress-lock contention."""
        tele = getattr(self.runtime, "tele", None)
        counters = {"endpoint.posts": sum(d.posts for d in self.devices),
                    "endpoint.pushes": sum(d.pushes for d in self.devices),
                    "endpoint.progresses": sum(d.progresses
                                               for d in self.devices)}
        counters.update({f"endpoint.lock_{k}": v
                         for k, v in self._contention().items()})
        return {"level": tele.level if tele is not None else "off",
                "counters": counters}

    def _contention(self) -> dict:
        """Aggregate progress-lock telemetry across the bundle (the
        runtime-discovered contention attribute)."""
        return aggregate_lock_stats(d.progress_lock for d in self.devices)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Endpoint({self.name!r}, n_devices={self.n_devices}, "
                f"stripe={self.spec.stripe!r}, "
                f"progress={self.spec.progress!r})")

    # -- striping ------------------------------------------------------------
    def select_device(self, *, rank: int = 0, size: int = 0):
        """Pick the device an op rides, per the endpoint's stripe policy."""
        stripe = self.spec.stripe
        if stripe == "by_peer":
            return self.devices[rank % len(self.devices)]
        if stripe == "by_size":
            cls = bisect.bisect_left(self._boundaries, size)
            return self.devices[min(cls, len(self.devices) - 1)]
        dev = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        return dev

    def select_burst_device(self, *, rank: int = 0, size: int = 0):
        """Stripe decision for a whole doorbell, or ``None`` for per-op
        selection.  Round-robin advances once per *burst*, not per op: a
        doorbell rides ONE device stream — per-peer FIFO holds within
        the burst and the per-doorbell costs (pool ``get_n``, payload
        staging, ``push_burst``, the receiver's progress pass) amortize
        over the full burst instead of splintering across the bundle;
        successive bursts still rotate over every device.  ``by_peer`` /
        ``by_size`` keep per-op selection (their placement is a function
        of the op, not of arrival order)."""
        if self.spec.stripe == "round_robin":
            return self.select_device(rank=rank, size=size)
        return None

    # -- posting sugar: every op routes through the single endpoint= path
    #    of repro_torch.core.post (the stripe policy picks the device inside
    #    _route_endpoint, which also validates endpoint ownership) --------
    def post_comm(self, direction, rank: int, buf, local_comp=None, *,
                  tag: int = 0, size=None, remote_buf=None, remote_comp=None,
                  matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG,
                  allow_retry: bool = True, user_context=None) -> Status:
        """The generic Table-1 posting operation, endpoint-routed."""
        return _post_comm(self.runtime, direction, rank, buf, local_comp,
                          tag=tag, size=size, remote_buf=remote_buf,
                          remote_comp=remote_comp, endpoint=self,
                          matching_policy=matching_policy,
                          allow_retry=allow_retry, user_context=user_context)

    def post_send(self, rank: int, buf, size=None, tag: int = 0,
                  local_comp=None, *, allow_retry: bool = True) -> Status:
        return post_send_x(self.runtime, rank, buf, size, tag, local_comp) \
            .endpoint(self).allow_retry(allow_retry)()

    def post_recv(self, rank: int, buf, size=None, tag: int = 0,
                  local_comp=None, *, allow_retry: bool = True) -> Status:
        return post_recv_x(self.runtime, rank, buf, size, tag, local_comp) \
            .endpoint(self).allow_retry(allow_retry)()

    def post_am(self, rank: int, buf, size=None, local_comp=None,
                remote_comp=None, *, tag: int = 0,
                allow_retry: bool = True) -> Status:
        return post_am_x(self.runtime, rank, buf, size, local_comp,
                         remote_comp).tag(tag).endpoint(self) \
            .allow_retry(allow_retry)()

    def post_put(self, rank: int, buf, remote_buf, size=None,
                 local_comp=None, remote_comp=None, *, tag: int = 0,
                 allow_retry: bool = True) -> Status:
        return post_put_x(self.runtime, rank, buf, remote_buf, size,
                          local_comp, remote_comp).tag(tag).endpoint(self) \
            .allow_retry(allow_retry)()

    def post_get(self, rank: int, buf, remote_buf, size=None,
                 local_comp=None, *, tag: int = 0,
                 allow_retry: bool = True) -> Status:
        return post_get_x(self.runtime, rank, buf, remote_buf, size,
                          local_comp).tag(tag).endpoint(self) \
            .allow_retry(allow_retry)()

    # -- burst posting (paper §4.3): K posts, one doorbell per stripe ------
    def post_many(self, ops) -> list[Status]:
        """Post a burst (:class:`~repro_torch.core.post.CommDesc` descriptors or
        unfired ``post_*_x`` builders) through the endpoint's stripe: ops
        are grouped by the device each resolves to, and each group rides
        ONE doorbell — one packet-pool ``get_n``, one stacked payload
        staging copy, one ``fabric.push_burst``, one telemetry bump.
        Per-group order is preserved and failure is prefix-accept, so a
        mid-burst ``retry`` splits — never reorders — the doorbell."""
        return _post_many(self.runtime, ops, endpoint=self)

    def _try_post_fused(self, kind: CommKind, rank: int, bufs, tags,
                        tag: int, local_comp, remote_comp) -> \
            Optional[list[Status]]:
        """Direct fused lowering for a uniform ``post_*_many`` burst
        (DESIGN.md §13): skip per-op :class:`CommDesc` construction and
        size resolution entirely and hand the raw payload list to the
        engine's packed doorbell.  Returns ``None`` when the burst is
        not uniform-eager — the caller falls back to descriptors."""
        rt = self.runtime
        k = len(bufs)
        if not (rt.doorbell_fused and k >= rt.fused_min_burst):
            return None
        first = bufs[0]
        if not isinstance(first, _ARRAYS):
            return None
        nb = first.nbytes
        if not (len(set(map(id, bufs))) == 1
                or all(isinstance(b, _ARRAYS) and b.nbytes == nb
                       for b in bufs)):
            return None
        proto = select_protocol(nb, rt.config)
        if proto == Protocol.ZEROCOPY:
            return None
        if tags is None:
            tags = [tag] * k
        elif len(tags) != len(bufs):
            raise FatalError(f"post_{kind.value}_many: {len(bufs)} bufs "
                             f"but {len(tags)} tags")
        else:
            tags = list(tags)
        dev = self.select_burst_device(rank=rank, size=nb) \
            or self.select_device(rank=rank, size=nb)
        eng = rt.engine
        eng._burst_posts.fetch_add(1)
        tele = eng.tele
        if tele.timers_on:
            with tele.span("post_burst"):
                return eng._post_fused_run(kind, rank, bufs, tags, nb,
                                           (proto,) * k, local_comp,
                                           remote_comp,
                                           MatchingPolicy.RANK_TAG, dev)
        return eng._post_fused_run(kind, rank, bufs, tags, nb, (proto,) * k,
                                   local_comp, remote_comp,
                                   MatchingPolicy.RANK_TAG, dev)

    def post_send_many(self, rank: int, bufs, *, tags=None, tag: int = 0,
                       local_comp=None, allow_retry: bool = True
                       ) -> list[Status]:
        """Burst of sends to one peer; ``tags`` (else constant ``tag``)
        aligns with ``bufs``."""
        if allow_retry and bufs:
            sts = self._try_post_fused(CommKind.SEND, rank, bufs, tags,
                                       tag, local_comp, None)
            if sts is not None:
                return sts
        if tags is None:
            tags = [tag] * len(bufs)
        elif len(tags) != len(bufs):
            raise FatalError(f"post_send_many: {len(bufs)} bufs but "
                             f"{len(tags)} tags")
        return _post_many(self.runtime, [
            CommDesc(CommKind.SEND, rank, b, tag=t, local_comp=local_comp,
                     allow_retry=allow_retry)
            for b, t in zip(bufs, tags)], endpoint=self)

    def post_am_many(self, rank: int, bufs, remote_comp, *, tags=None,
                     tag: int = 0, local_comp=None,
                     allow_retry: bool = True) -> list[Status]:
        """Burst of active messages to one peer (the message-rate hot
        loop): K payloads, one remote completion handle."""
        if remote_comp is None:
            raise FatalError("post_am_many requires a remote completion "
                             "handle")
        if allow_retry and bufs:
            sts = self._try_post_fused(CommKind.AM, rank, bufs, tags,
                                       tag, local_comp, remote_comp)
            if sts is not None:
                return sts
        if tags is None:
            tags = [tag] * len(bufs)
        elif len(tags) != len(bufs):
            raise FatalError(f"post_am_many: {len(bufs)} bufs but "
                             f"{len(tags)} tags")
        return _post_many(self.runtime, [
            CommDesc(CommKind.AM, rank, b, tag=t, local_comp=local_comp,
                     remote_comp=remote_comp, allow_retry=allow_retry)
            for b, t in zip(bufs, tags)], endpoint=self)

    # -- progress ------------------------------------------------------------
    def _idle(self, dev) -> bool:
        """Lock-free probe: nothing for a pass on ``dev`` to do — no
        incoming traffic, no backlog, no pending source completions, and
        no armed reliability timers (a dropped message's retransmit is
        work even when every queue is empty).  A burst that landed on one
        stripe leaves the other devices idle; skipping their locked
        passes keeps a wide endpoint's progress cost proportional to
        traffic, not to width."""
        rel = self.runtime.rel
        return (not dev.pending_tx and dev.backlog.empty_flag
                and not self.runtime.fabric.stream_depth(
                    self.runtime.rank, dev.index)
                and (rel is None or not rel.armed()))

    def progress(self, rounds: int = 1, max_msgs: int = 0) -> int:
        """Drive this endpoint's devices with its engine(s).

        Safe to call while the worker pool runs: the inline pass uses the
        same per-device try-locks, skipping any device a worker holds."""
        n = 0
        for _ in range(rounds):
            if self.spec.progress == "workers":
                for eng, dev in zip(self.engines, self.devices):
                    if self._idle(dev):
                        continue
                    n += bool(eng.try_progress(dev, max_msgs))
            elif self.spec.progress == "dedicated":
                for eng, dev in zip(self.engines, self.devices):
                    if self._idle(dev):
                        continue
                    n += bool(eng.progress(dev, max_msgs))
            else:
                for dev in self.devices:
                    if self._idle(dev):
                        continue
                    n += bool(self.engines[0].progress(dev, max_msgs))
        return n

    # -- worker lifecycle (progress == "workers") ----------------------------
    def start_workers(self) -> "Endpoint":
        """Spawn the endpoint's progress worker threads."""
        if self.workers is None:
            raise FatalError(f"endpoint {self.name!r} has progress="
                             f"{self.spec.progress!r}; workers need "
                             "EndpointSpec(progress='workers')")
        self.workers.start()
        return self

    def stop_workers(self, timeout: float = 10.0) -> None:
        if self.workers is not None and self.workers.running:
            self.workers.stop(timeout)

    def __enter__(self) -> "Endpoint":
        if self.workers is not None:
            self.start_workers()
        return self

    def __exit__(self, *exc) -> None:
        self.stop_workers()

    # -- telemetry -----------------------------------------------------------
    def counters(self) -> dict:
        """Per-device posts/pushes/progress counts (Fig-8-style evidence
        that traffic really striped across the bundle)."""
        out = {
            "name": self.name,
            "stripe": self.spec.stripe,
            "progress": self.spec.progress,
            "devices": [
                {"index": d.index, "lane": d.lane, "posts": d.posts,
                 "pushes": d.pushes, "progresses": d.progresses}
                for d in self.devices
            ],
        }
        if self.workers is not None:
            out["workers"] = self.workers.counters()
        return out
