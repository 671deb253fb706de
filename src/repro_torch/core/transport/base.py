"""The Transport ABC — the pluggable data plane behind the Fabric surface.

The paper's evaluation (Figures 2/3) compares the multithreaded runtime
against the *multi-process* execution mode; reproducing that comparison
needs the wire to be pluggable.  :class:`Transport` pins down the surface
every backend must provide — exactly the contract the progress engine,
endpoints and worker pools were already written against:

* ``try_push`` / ``push_burst`` / ``push_packed`` — post wire messages to
  a ``(dst, device)`` stream; a full stream surfaces back-pressure by
  accepting only a prefix (never a subsequence: accepting message k+1
  after rejecting k would break stream FIFO);
* ``drain`` — pop ready messages from one stream (the consumer side of
  the Figure-1 reaction chain); ``limit`` is **row-weighted**: a packed
  doorbell counts its row count toward the bound but is never split;
* ``ready`` / ``stream_depth`` — cheap *unlocked* probes the idle fast
  paths branch on (``Endpoint.progress`` skips quiet devices without
  paying for a locked pass);
* depth accounting is row-weighted everywhere: a packed doorbell weighs
  ``payload.count`` messages toward ``stream_depth`` / ``in_flight`` /
  the depth bound.

Backends register under a name (``sim`` / ``shm`` / ``socket``) and are
selected through the attribute chain (``fabric_backend``, env spelling
``REPRO_ATTR_FABRIC_BACKEND``) — every consumer works unchanged on top
of any backend.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import attrs as _attrs
from ..concurrency.atomics import AtomicCounter
from ..status import FatalError
from ..telemetry import NULL_TELEMETRY
from .wire import WireMsg

#: attrs a transport resolves at alloc time (the fabric's registry slice)
FABRIC_ATTRS = ("fabric_backend", "fabric_depth", "link_latency",
                "shm_ring_bytes")


class Transport(_attrs.AttrResource, abc.ABC):
    """Per-(dst, device) FIFO streams with bounded depth; the NIC stand-in.

    ``depth`` bounds each stream in *messages* (row-weighted) — a full
    stream is the paper's "underlying network send queue is full" event
    and surfaces ``retry``.  ``latency`` (seconds) models the wire where
    the backend can honor it (the sim backend always does; shm honors it
    on one host; sockets have real latency and ignore the model).

    Thread-safety contract (DESIGN.md §10): streams are single-consumer
    (the consumer device's progress try-lock serializes ``drain``);
    producers may race, and the depth bound is approximate by at most
    the number of racing posters — back-pressure, not an invariant.
    ``ready`` / ``stream_depth`` must be safe to call unlocked from any
    thread: a stale answer costs one wasted (or one late) pass, nothing
    more.
    """

    #: registry name of the backend (subclasses override)
    backend = "abstract"

    def __init__(self, n_ranks: int, depth: int = 4096,
                 latency: float = 0.0,
                 resolved: Optional[_attrs.ResolvedAttrs] = None):
        self.n_ranks = n_ranks
        self.depth = depth
        self.latency = latency
        # atomic: producers on any thread bump these concurrently
        self._pushes = AtomicCounter()
        self._full_events = AtomicCounter()
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"fabric_backend": self.backend, "fabric_depth": depth,
             "link_latency": latency}))
        self.tele = NULL_TELEMETRY
        self._export_attr("in_flight", self.in_flight)
        self._export_attr("pushes", lambda: self.pushes)
        self._export_attr("full_events", lambda: self.full_events)
        self._export_attr("telemetry", self._telemetry_block)

    # -- telemetry -----------------------------------------------------------
    @property
    def pushes(self) -> int:
        return self._pushes.load()

    @property
    def full_events(self) -> int:
        return self._full_events.load()

    def set_telemetry(self, tele) -> None:
        """Attach the owning cluster's hub (transport spans are timed at
        the engine call sites; the hub folds these counters in)."""
        self.tele = tele
        tele.attach("fabric", lambda: {"pushes": self.pushes,
                                       "full_events": self.full_events})

    def _telemetry_block(self) -> dict:
        return {"level": self.tele.level,
                "counters": {"fabric.pushes": self.pushes,
                             "fabric.full_events": self.full_events,
                             "fabric.in_flight": self.in_flight()}}

    # -- producer side -------------------------------------------------------
    @abc.abstractmethod
    def try_push(self, msg: WireMsg) -> bool:
        """Push one message; ``False`` = stream full (back-pressure)."""

    @abc.abstractmethod
    def push_burst(self, msgs: Sequence[WireMsg]) -> int:
        """One doorbell: a burst bound for the SAME ``(dst, device)``
        stream.  Accepts the longest prefix that fits under the depth
        bound and returns how many messages were accepted."""

    @abc.abstractmethod
    def push_packed(self, msg: WireMsg) -> int:
        """Ring a fused doorbell: ONE descriptor whose ``PackedBurst``
        payload carries the whole burst.  The burst weighs ``count``
        messages toward the depth bound; accepts the longest row prefix
        that fits and returns the number of rows accepted."""

    # -- consumer side -------------------------------------------------------
    @abc.abstractmethod
    def drain(self, dst: int, device_index: int, limit: int = 0
              ) -> List[WireMsg]:
        """Pop ready messages from one stream.  ``limit`` bounds the
        burst row-weighted: ``limit == 0`` means "drain all", ``limit >
        0`` stops once the popped row weight reaches the cap (a packed
        doorbell is popped whole, so one doorbell may overshoot);
        ``limit < 0`` is an error."""

    @abc.abstractmethod
    def ready(self, dst: int, device_index: int) -> bool:
        """Cheap unlocked readiness probe: is at least one message on
        this stream due for delivery?"""

    @abc.abstractmethod
    def stream_depth(self, dst: int, device_index: int) -> int:
        """Queued messages on one stream (row-weighted, including
        not-yet-drainable ones) — the lock-free idle probe."""

    @abc.abstractmethod
    def in_flight(self) -> int:
        """Total queued messages this transport can observe
        (row-weighted).  Cross-process backends report what is visible
        from this process (shm rings are globally visible on one host;
        sockets only count locally buffered frames)."""

    @abc.abstractmethod
    def pending_to(self, dst: int) -> int:
        """Queued messages bound for rank ``dst`` across all streams."""

    @abc.abstractmethod
    def pending_streams(self, dst: int) -> List[int]:
        """Device-stream indices with traffic queued toward ``dst``."""

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Release OS resources (shm files, sockets).  Idempotent; the
        in-process sim backend has nothing to release."""

    @staticmethod
    def check_stream(msgs: Sequence[WireMsg]) -> tuple:
        """Validate a burst rides one stream; returns ``(dst, device)``."""
        dst, didx = msgs[0].dst, msgs[0].device_index
        for m in msgs[1:]:
            if m.dst != dst or m.device_index != didx:
                raise FatalError("push_burst: a doorbell rides one "
                                 "(dst, device) stream; got mixed streams")
        return dst, didx


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

#: backend name -> lazy factory returning the Transport subclass
_BACKENDS: Dict[str, Callable[[], type]] = {}


def register_backend(name: str, loader: Callable[[], type]) -> None:
    """Register a transport backend under ``name``.  ``loader`` is lazy
    (called at first use) so registering the stock backends does not
    import their OS machinery up front."""
    _BACKENDS[name] = loader


def backend_class(name: str) -> type:
    loader = _BACKENDS.get(name)
    if loader is None:
        raise _attrs.AttrError(
            f"unknown fabric backend {name!r}; registered backends: "
            f"{sorted(_BACKENDS)}")
    return loader()


def make_transport(backend: str, n_ranks: int, **kwargs: Any) -> Transport:
    """Construct the selected backend.  ``kwargs`` are the union of every
    backend's knobs; each constructor takes what it understands (they all
    accept ``depth`` / ``latency`` / ``resolved``)."""
    return backend_class(backend)(n_ranks, **kwargs)
