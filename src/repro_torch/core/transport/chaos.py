"""Chaos plane: deterministic fault injection over any transport backend.

:class:`ChaosTransport` composes over a registered backend (sim / shm /
socket) and injects faults on the **drain side** — the consumer's view of
the wire — driven by the ``chaos_*`` attrs through the four-layer chain
(DESIGN.md §16).  Draining rather than pushing keeps the producer-side
contracts honest: prefix-accept, depth accounting, and back-pressure all
belong to the real backend; chaos only decides what the consumer
*observes*.

Fault model:

* **drop** — a drained message is discarded.  Only retransmittable
  messages (``seq >= 0``, i.e. reliability-stamped eager traffic) are
  eligible: control traffic (RTS/CTS/RDMA, RMA, ACKs) rides the reliable
  connection, exactly like verbs RC transports under packet loss.
* **dup** — a drained message is delivered twice (receiver-side dedup by
  seq must swallow the second copy).
* **reorder** — a drained message is held back and delivered after the
  *next* drain batch, scrambling stream FIFO.
* **delay** — a drained message matures only after ``chaos_delay_us``
  (a latency spike, not a loss).
* **rank death** — traffic from/to a killed rank vanishes; pushes toward
  it are swallowed-and-counted so producers never wedge on a corpse's
  full ring.

Held-back messages stay part of the observable queue: ``ready`` /
``stream_depth`` / ``in_flight`` include the stash, so quiesce loops and
idle fast paths keep driving progress until chaos lets go.

Every decision comes from a per-stream ``random.Random`` seeded from
``(chaos_seed, dst, device)`` — the same seed replays the same fault
sequence for a given drain pattern.  Per-fault counters attach to the
telemetry hub under the ``chaos.`` prefix.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from random import Random

from .. import attrs as _attrs
from ..concurrency.atomics import AtomicCounter
from .base import Transport
from .wire import WireMsg, msg_weight

#: attrs the chaos plane resolves at cluster construction
CHAOS_ATTRS = ("chaos_seed", "chaos_drop", "chaos_dup", "chaos_reorder",
               "chaos_delay_p", "chaos_delay_us", "chaos_kill_rank")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Resolved fault-injection knobs (one per ``chaos_*`` attr)."""

    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    delay_p: float = 0.0
    delay_us: float = 1000.0
    kill_rank: int = -1

    @classmethod
    def from_resolved(cls, r) -> "ChaosConfig":
        return cls(seed=r["chaos_seed"], drop=r["chaos_drop"],
                   dup=r["chaos_dup"], reorder=r["chaos_reorder"],
                   delay_p=r["chaos_delay_p"], delay_us=r["chaos_delay_us"],
                   kill_rank=r["chaos_kill_rank"])

    @property
    def active(self) -> bool:
        """Does this config fault anything at all?  Inactive configs
        skip the ChaosTransport wrap entirely (zero-cost default)."""
        return (self.drop > 0 or self.dup > 0 or self.reorder > 0
                or self.delay_p > 0 or self.kill_rank >= 0)

    @property
    def faults_messages(self) -> bool:
        return self.drop > 0 or self.dup > 0 or self.reorder > 0 \
            or self.delay_p > 0


class ChaosTransport(Transport):
    """Fault-injecting wrapper around a real backend (DESIGN.md §16).

    Producer-side calls delegate to the wrapped transport unchanged
    (except traffic involving a dead rank, which is swallowed).  The
    consumer-side ``drain`` filters the wrapped backend's batch through
    the fault model, keeping held-back messages in a per-stream stash
    that still counts toward every depth probe.
    """

    def __init__(self, inner: Transport, cfg: ChaosConfig,
                 resolved: Optional[_attrs.ResolvedAttrs] = None):
        self.inner = inner
        self.cfg = cfg
        self.backend = inner.backend          # instance shadow: echo inner
        # share the wrapped backend's resolved attrs: the wrapper must be
        # introspection-transparent (get_attr / attr_source / provenance
        # answer exactly as the real backend would)
        super().__init__(inner.n_ranks, inner.depth, inner.latency,
                         resolved=resolved or inner._resolved_attrs)
        self._dead: set = set()
        if cfg.kill_rank >= 0:
            self._dead.add(cfg.kill_rank)
        # per-(dst, device) fault state — mutated only by the stream's
        # single consumer (drain); probes read unlocked (stale is fine)
        self._rngs: Dict[Tuple[int, int], Random] = {}
        self._held: Dict[Tuple[int, int], List[WireMsg]] = {}
        self._delayed: Dict[Tuple[int, int],
                            List[Tuple[float, WireMsg]]] = {}
        self._stash_weight: Dict[Tuple[int, int], int] = {}
        # per-fault counters (atomic: dead-rank swallows happen on
        # producer threads)
        self.dropped = AtomicCounter()
        self.duped = AtomicCounter()
        self.reordered = AtomicCounter()
        self.delayed = AtomicCounter()
        self.dead_dropped = AtomicCounter()
        self._export_attr("chaos", self.fault_counters)

    # -- rank death ----------------------------------------------------------
    def kill(self, rank: int) -> None:
        """Declare ``rank`` dead at the wire from now on (idempotent)."""
        self._dead.add(rank)

    def rank_dead(self, rank: int) -> bool:
        return rank in self._dead

    @property
    def dead_ranks(self) -> frozenset:
        return frozenset(self._dead)

    def _swallow(self, msg: WireMsg) -> None:
        self.dead_dropped.add(msg_weight(msg))

    # -- producer side (delegated) -------------------------------------------
    def try_push(self, msg: WireMsg) -> bool:
        if self._dead and (msg.dst in self._dead or msg.src in self._dead):
            self._swallow(msg)
            return True
        return self.inner.try_push(msg)

    def push_burst(self, msgs: Sequence[WireMsg]) -> int:
        if self._dead and msgs and (msgs[0].dst in self._dead
                                    or msgs[0].src in self._dead):
            for m in msgs:
                self._swallow(m)
            return len(msgs)
        return self.inner.push_burst(msgs)

    def push_packed(self, msg: WireMsg) -> int:
        if self._dead and (msg.dst in self._dead or msg.src in self._dead):
            self._swallow(msg)
            return msg.payload.count
        return self.inner.push_packed(msg)

    # -- consumer side (the fault model) -------------------------------------
    def _rng(self, key: Tuple[int, int]) -> Random:
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = Random(
                (self.cfg.seed + 1) * 0x9E3779B1 ^ (key[0] << 16) ^ key[1])
        return rng

    def drain(self, dst: int, device_index: int, limit: int = 0
              ) -> List[WireMsg]:
        if dst in self._dead:
            # a corpse never drains; flush its streams so rings drain
            for m in self.inner.drain(dst, device_index, limit):
                self._swallow(m)
            return []
        key = (dst, device_index)
        batch = self.inner.drain(dst, device_index, limit)
        cfg = self.cfg
        out: List[WireMsg] = []
        stash_delta = 0
        # matured latency spikes deliver first — they are the oldest
        delayed = self._delayed.get(key)
        if delayed:
            now = time.monotonic()
            still: List[Tuple[float, WireMsg]] = []
            for due, m in delayed:
                if due <= now:
                    out.append(m)
                    stash_delta -= msg_weight(m)
                else:
                    still.append((due, m))
            self._delayed[key] = still
        prev_held = self._held.pop(key, [])
        new_held: List[WireMsg] = []
        rng = self._rng(key)
        for m in batch:
            if self._dead and m.src in self._dead:
                self._swallow(m)
                continue
            if m.seq < 0 or not cfg.faults_messages:
                out.append(m)                  # control traffic: reliable
                continue
            if cfg.drop and rng.random() < cfg.drop:
                self.dropped.add(1)
                continue
            if cfg.delay_p and rng.random() < cfg.delay_p:
                self._delayed.setdefault(key, []).append(
                    (time.monotonic() + cfg.delay_us * 1e-6, m))
                stash_delta += msg_weight(m)
                self.delayed.add(1)
                continue
            if cfg.reorder and rng.random() < cfg.reorder:
                new_held.append(m)
                stash_delta += msg_weight(m)
                self.reordered.add(1)
                continue
            out.append(m)
            if cfg.dup and rng.random() < cfg.dup:
                out.append(m)                  # receiver dedups by seq
                self.duped.add(1)
        # messages held back last drain land AFTER this batch (reordered)
        for m in prev_held:
            out.append(m)
            stash_delta -= msg_weight(m)
        if new_held:
            self._held[key] = new_held
        if stash_delta:
            self._stash_weight[key] = \
                self._stash_weight.get(key, 0) + stash_delta
        return out

    # -- probes (stash-aware) ------------------------------------------------
    def _stash_ready(self, key: Tuple[int, int]) -> bool:
        if self._held.get(key):
            return True
        delayed = self._delayed.get(key)
        if delayed:
            now = time.monotonic()
            return any(due <= now for due, _ in delayed)
        return False

    def ready(self, dst: int, device_index: int) -> bool:
        return self.inner.ready(dst, device_index) \
            or self._stash_ready((dst, device_index))

    def stream_depth(self, dst: int, device_index: int) -> int:
        return self.inner.stream_depth(dst, device_index) \
            + self._stash_weight.get((dst, device_index), 0)

    def in_flight(self) -> int:
        return self.inner.in_flight() + sum(self._stash_weight.values())

    def pending_to(self, dst: int) -> int:
        extra = sum(w for (d, _), w in self._stash_weight.items()
                    if d == dst)
        return self.inner.pending_to(dst) + extra

    def pending_streams(self, dst: int) -> List[int]:
        streams = set(self.inner.pending_streams(dst))
        streams.update(di for (d, di), w in self._stash_weight.items()
                       if d == dst and w > 0)
        return sorted(streams)

    # -- introspection transparency ------------------------------------------
    def get_attr(self, name: str):
        try:
            return super().get_attr(name)
        except _attrs.AttrError:
            return self.inner.get_attr(name)   # inner-exported readonly attrs

    def attr_source(self, name: str) -> str:
        try:
            return super().attr_source(name)
        except _attrs.AttrError:
            return self.inner.attr_source(name)

    @property
    def attrs(self) -> dict:
        out = dict(self.inner.attrs)
        out.update(_attrs.AttrResource.attrs.fget(self))
        return out

    # -- telemetry / lifecycle -----------------------------------------------
    def fault_counters(self) -> dict:
        return {"dropped": self.dropped.load(),
                "duped": self.duped.load(),
                "reordered": self.reordered.load(),
                "delayed": self.delayed.load(),
                "dead_dropped": self.dead_dropped.load(),
                "dead_ranks": sorted(self._dead)}

    def set_telemetry(self, tele) -> None:
        self.inner.set_telemetry(tele)
        self.tele = tele
        tele.attach("chaos", lambda: {
            k: v for k, v in self.fault_counters().items()
            if k != "dead_ranks"})

    def _telemetry_block(self) -> dict:
        block = self.inner._telemetry_block()
        block["counters"].update(
            {f"chaos.{k}": v for k, v in self.fault_counters().items()
             if k != "dead_ranks"})
        return block

    @property
    def pushes(self) -> int:
        return self.inner.pushes

    @property
    def full_events(self) -> int:
        return self.inner.full_events

    def close(self) -> None:
        self.inner.close()


def maybe_wrap_chaos(fabric: Transport, resolved) -> Transport:
    """Wrap ``fabric`` in a :class:`ChaosTransport` when the resolved
    ``chaos_*`` attrs fault anything; otherwise return it untouched."""
    cfg = ChaosConfig.from_resolved(resolved)
    if not cfg.active:
        return fabric
    return ChaosTransport(fabric, cfg)
