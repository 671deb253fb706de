"""The ``sim`` backend — the deterministic in-process fabric.

The original simulated NIC: per ``(dst-rank, device-stream)`` bounded
FIFO deques in one address space.  A full queue surfaces ``retry`` — the
same back-pressure path a full ibv send queue triggers in the paper
(§4.4) — and the progress engine moves such requests through the backlog
queue.  Messages are keyed by the *sender's* device index, so each device
stream is an independent, ordered channel: replicating devices replicates
streams, which is exactly the paper's resource-replication story (§3.2.3).

This is the default backend for tests: no OS resources, byte-exact
determinism, and an optional latency model (``link_latency``) for the
multithreaded benchmarks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import attrs as _attrs
from .base import Transport
from .wire import PACKED_KINDS, PackedBurst, WireMsg


class Fabric(Transport):
    """Bounded per-(dst, device) FIFO deques; the NIC send-queue stand-in.

    ``depth`` bounds each queue row-weighted — a packed doorbell occupies
    one deque slot but weighs ``payload.count`` messages.  ``latency``
    (seconds) models the wire: a pushed message only becomes drainable
    ``latency`` after its push; the default (0) keeps the historical
    instantly-visible behaviour.  Thread-safety per the Transport
    contract: streams are single-consumer, concurrent producers ride the
    GIL-atomic deque append, so the depth bound is approximate by at most
    the number of racing posters.
    """

    backend = "sim"

    def __init__(self, n_ranks: int, depth: int = 4096,
                 latency: float = 0.0,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 **_ignored):
        super().__init__(n_ranks, depth, latency, resolved)
        self._queues: Dict[Tuple[int, int], collections.deque] = {}
        # per-stream weight beyond len(queue): a packed doorbell occupies
        # one deque slot but weighs payload.count messages toward the
        # depth bound, so _extra holds sum(count - 1) per stream.  Same
        # approximate-under-races contract as the depth bound itself.
        self._extra: Dict[Tuple[int, int], int] = {}
        #: called with the destination rank after every accepted push
        #: (rank threads that sleep until traffic lands set it)
        self.on_push = None

    def _q(self, dst: int, device_index: int) -> collections.deque:
        return self._queues.setdefault((dst, device_index),
                                       collections.deque())

    def try_push(self, msg: WireMsg) -> bool:
        q = self._q(msg.dst, msg.device_index)
        if len(q) + self._extra.get((msg.dst, msg.device_index), 0) \
                >= self.depth:
            self._full_events.fetch_add(1)
            return False
        if self.latency:
            msg.ready_at = time.perf_counter() + self.latency
        q.append(msg)
        self._pushes.fetch_add(1)
        if self.on_push is not None:
            self.on_push(msg.dst)
        return True

    def push_burst(self, msgs: Sequence[WireMsg]) -> int:
        """One doorbell: push a burst of messages bound for the SAME
        ``(dst, device_index)`` stream.  Accepts the longest prefix that
        fits under the depth bound (never a subsequence — accepting
        message k+1 after rejecting k would break stream FIFO) and
        returns how many were accepted.  Per-burst costs are paid once:
        one queue lookup, one latency stamp, one deque extend, one
        telemetry FAA — the paper's §4.3 amortization at the device
        boundary."""
        if not msgs:
            return 0
        dst, didx = self.check_stream(msgs)
        q = self._q(dst, didx)
        n = min(len(msgs), max(0, self.depth - len(q)
                               - self._extra.get((dst, didx), 0)))
        if n < len(msgs):
            self._full_events.fetch_add(1)
        if n == 0:
            return 0
        accepted = msgs[:n]
        if self.latency:
            ready = time.perf_counter() + self.latency
            for m in accepted:
                m.ready_at = ready
        q.extend(accepted)
        self._pushes.fetch_add(n)
        if self.on_push is not None:
            self.on_push(dst)
        return n

    def push_packed(self, msg: WireMsg) -> int:
        """Ring a fused doorbell: ONE descriptor whose :class:`PackedBurst`
        payload carries the whole burst.  The burst weighs ``count``
        messages toward the stream depth bound — split points are
        identical to pushing the rows through :meth:`push_burst` — and
        accepts the longest row prefix that fits (the rejected suffix is
        the caller's to retry).  Per-doorbell costs collapse to one queue
        lookup, one latency stamp, one append, one telemetry FAA.
        Returns the number of rows accepted."""
        burst: PackedBurst = msg.payload
        key = (msg.dst, msg.device_index)
        q = self._q(*key)
        n = min(burst.count,
                max(0, self.depth - len(q) - self._extra.get(key, 0)))
        if n < burst.count:
            self._full_events.fetch_add(1)
        if n == 0:
            return 0
        if n < burst.count:                  # prefix-accept split
            pb = burst.prefix(n)
            msg = dataclasses.replace(msg, payload=pb,
                                      size=int(pb.data.nbytes))
        if self.latency:
            msg.ready_at = time.perf_counter() + self.latency
        q.append(msg)
        if n > 1:
            self._extra[key] = self._extra.get(key, 0) + n - 1
        self._pushes.fetch_add(n)
        if self.on_push is not None:
            self.on_push(msg.dst)
        return n

    def ready(self, dst: int, device_index: int) -> bool:
        """Cheap unlocked readiness probe: is at least one message on
        this stream due for delivery?  The poll-before-lock doorbell
        check — idle progress passes branch on this instead of paying
        the lock + telemetry + drain machinery to discover nothing.
        Safe without the stream lock: a stale True costs one full pass,
        a stale False is indistinguishable from polling a hair earlier."""
        q = self._queues.get((dst, device_index))
        if not q:
            return False
        if not self.latency:
            return True
        try:
            return q[0].ready_at <= time.perf_counter()
        except IndexError:            # racing drain emptied the stream
            return False

    def drain(self, dst: int, device_index: int, limit: int = 0
              ) -> List[WireMsg]:
        """Pop ready messages from one stream.  ``limit`` bounds the
        burst *row-weighted* (``limit == 0`` = drain all): a packed
        doorbell counts its row count toward the cap but is popped whole
        — the limit is a burst bound, not a split point — so
        ``stream_depth`` drops by exactly the weight of what was
        returned.  ``limit < 0`` is an error."""
        if limit < 0:
            raise ValueError(f"drain: limit must be >= 0 (0 = drain all), "
                             f"got {limit}")
        q = self._q(dst, device_index)
        out: List[WireMsg] = []
        weight = 0
        budget = len(q)               # snapshot: never chase racing pushes
        now = time.perf_counter() if self.latency else 0.0
        while budget > 0 and q and (limit == 0 or weight < limit):
            if self.latency and q[0].ready_at > now:
                break                 # FIFO: stop at the first on-the-wire
            msg = q.popleft()
            out.append(msg)
            budget -= 1
            weight += (msg.payload.count if msg.kind in PACKED_KINDS else 1)
        # settle the packed-weight surplus — only streams that actually
        # carried fused doorbells pay the scan (scalar drains skip it)
        key = (dst, device_index)
        ex = self._extra.get(key)
        if ex:
            dec = sum(m.payload.count - 1 for m in out
                      if m.kind in PACKED_KINDS)
            if dec:
                self._extra[key] = ex - dec
        return out

    def stream_depth(self, dst: int, device_index: int) -> int:
        """Queued messages on one stream (including not-yet-drainable
        ones; a packed doorbell counts its row count) — the lock-free
        idle probe progress drivers use to skip a quiet device without
        paying for a full locked pass."""
        q = self._queues.get((dst, device_index))
        if q is None:
            return 0
        return len(q) + self._extra.get((dst, device_index), 0)

    def in_flight(self) -> int:
        """Total queued messages (including not-yet-drainable ones);
        packed doorbells count their row counts."""
        return (sum(len(q) for q in self._queues.values())
                + sum(self._extra.values()))

    def pending_to(self, dst: int) -> int:
        return sum(len(q) + self._extra.get(k, 0)
                   for k, q in self._queues.items() if k[0] == dst)

    def pending_streams(self, dst: int) -> List[int]:
        """Device-stream indices with traffic queued toward ``dst``."""
        return sorted(i for (d, i), q in self._queues.items()
                      if d == dst and q)
