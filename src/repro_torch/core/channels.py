"""Channels & devices — LCI's replicable communication resources.

Paper (§3.2.3): "a device encapsulat[es] a complete set of low-level network
resources and LCI ensures threads operating on different devices will not
interfere with each other."  Replicating devices is how LCI's dedicated-
resource mode beats the shared-resource mode.

* :class:`Channel` — one independent chunk-stream of a device (the
  reference's unit of ring-collective traffic; kept for parity).
* :class:`Device` — a full replicable resource set: channels + a packet-pool
  lane + a completion queue + a backlog queue.  ``Runtime.alloc_device``
  hands these out; the host runtime replicates them per lane exactly like
  the paper replicates devices per thread.

The *contention-free guarantee* (paper §4.2.3: no interference between a
worker posting and a progress thread) maps to: operations on different
devices touch disjoint state (their own backlog, CQ, progress lock and
fabric stream).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Optional

from . import attrs as _attrs
from .backlog import BacklogQueue
from .completion import CompletionQueue
from .concurrency.atomics import AtomicCounter
from .concurrency.locks import TryLock
from .modes import CommConfig, CommMode
from .telemetry import NULL_TELEMETRY

#: attrs a device resolves at alloc time (n_channels may be overridden
#: per device; 0-capacities mean unbounded)
DEVICE_ATTRS = ("n_channels", "backlog_capacity", "cq_capacity")

_device_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class Channel:
    """One independent chunk-stream. ``direction`` ∈ {+1, -1} picks the ring
    orientation; interleaved chunk index picks the payload slice."""

    cid: int
    direction: int
    chunk_index: int
    n_chunks: int


def make_channels(n: int) -> tuple[Channel, ...]:
    """n channels: alternate ring directions, interleave chunk slots."""
    chans = []
    for i in range(n):
        chans.append(Channel(cid=i,
                             direction=+1 if i % 2 == 0 else -1,
                             chunk_index=i,
                             n_chunks=n))
    return tuple(chans)


class Device(_attrs.AttrResource):
    """A replicable set of communication resources (paper: LCI device)."""

    def __init__(self, config: CommConfig, lane: int,
                 cq: Optional[CompletionQueue] = None,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 tele=None):
        self.did = next(_device_ids)
        self.lane = lane                       # packet-pool lane this device owns
        self.config = config
        if resolved is None:
            resolved = _attrs.resolved_from_values(
                {"n_channels": config.resolved_channels(),
                 "backlog_capacity": 0, "cq_capacity": 0})
        # an explicit per-device n_channels override beats the
        # config-derived width; otherwise the mode logic decides (BSP and
        # LCI_SHARED collapse to one channel regardless of the knob) —
        # and the stored resolution must agree with the width the device
        # actually runs with, so re-merge when the mode collapsed it
        n_chan = (resolved["n_channels"]
                  if resolved.source("n_channels") == "resource"
                  else config.resolved_channels())
        if resolved["n_channels"] != n_chan:
            resolved = resolved.merged(_attrs.ResolvedAttrs(
                {"n_channels": n_chan},
                {"n_channels": resolved.source("n_channels")}))
        self._init_attrs(resolved)
        self.channels = make_channels(n_chan)
        self.cq = cq or CompletionQueue(resolved["cq_capacity"] or None)
        self.backlog = BacklogQueue(resolved["backlog_capacity"] or None)
        self._export_attr("lane", lambda: self.lane)
        self._export_attr("width", lambda: len(self.channels))
        self._export_attr("posts", lambda: self.posts)
        self._export_attr("pushes", lambda: self.pushes)
        self._export_attr("progresses", lambda: self.progresses)
        self._export_attr("progress_lock_stats",
                          lambda: self.progress_lock.stats())
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._export_attr("telemetry", self._telemetry_block)
        self.index = 0                         # position in the owner's device list
        self.pending_tx = collections.deque()  # ops awaiting source completion
        # per-device progress try-lock (paper §4.2.3): any number of
        # threads may call progress; the holder runs the reaction chain,
        # a loser "moves on".  Reentrant: a completion callback fired
        # inside a pass may legally drive progress on its own device.
        self.progress_lock = TryLock(name=f"device{self.did}/progress",
                                     reentrant=True)
        # telemetry (paper's "progress" counters) — atomic: posts/pushes
        # are bumped by arbitrary poster threads, progresses by whichever
        # thread holds the progress lock
        self._posts = AtomicCounter()
        self._pushes = AtomicCounter()
        self._progresses = AtomicCounter()

    # counters read as plain ints; writers use count_*()
    @property
    def posts(self) -> int:
        return self._posts.load()

    @property
    def pushes(self) -> int:
        return self._pushes.load()

    @property
    def progresses(self) -> int:
        return self._progresses.load()

    def count_post(self, n: int = 1) -> None:
        self._posts.fetch_add(n)

    def count_push(self, n: int = 1) -> None:
        self._pushes.fetch_add(n)

    def count_progress(self) -> None:
        self._progresses.fetch_add(1)

    def _telemetry_block(self) -> dict:
        """This device's contribution to the unified snapshot
        (DESIGN.md §15): its legacy counters under dotted names."""
        ls = self.progress_lock.stats()
        return {"level": self.tele.level,
                "counters": {"device.posts": self.posts,
                             "device.pushes": self.pushes,
                             "device.progresses": self.progresses,
                             "device.lock_acquisitions": ls["acquisitions"],
                             "device.lock_contentions": ls["contentions"]}}

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def __repr__(self) -> str:
        return (f"Device(id={self.did}, lane={self.lane}, "
                f"channels={self.n_channels}, mode={self.config.mode.value})")
