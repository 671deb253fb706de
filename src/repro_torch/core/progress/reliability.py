"""Reliability plane: post deadlines, retransmit, and dedup (DESIGN.md §16).

The chaos transport (:mod:`repro_torch.core.transport.chaos`) drops, duplicates
and reorders reliability-stamped wire traffic; this module is the layer
that makes eager messaging survive it — the software analogue of a verbs
RC connection's ack/retransmit machinery, driven entirely from the
progress engine's reaction chain:

* **Sender**: every eager message (scalar, burst, or fused packed
  doorbell) is stamped with a per-``(dst, device)`` stream sequence
  number at the moment it is accepted by the fabric, and recorded in an
  unacked window.  A packed doorbell allocates ``count`` *consecutive*
  seqs — one per row — so a partial prefix-accept or a partially
  duplicated delivery stays addressable at row granularity.  The sweep
  stage retransmits entries whose ack is overdue (exponential backoff,
  ``retry_backoff`` doubling per attempt, capped), fails them with
  ``ERR_TIMEOUT`` once ``retry_limit`` attempts are spent, and with
  ``ERR_PEER_DEAD`` when the peer has been declared dead.

* **Receiver**: per-``(src, device)`` cumulative counter plus a hold
  buffer resequences the stream — duplicates (seq ≤ cum) are swallowed,
  gaps are held until the retransmit arrives, and delivery order is
  exactly seq order, which restores the per-stream FIFO the matching
  tests pin.  Every accepted-or-duplicate batch triggers a cumulative
  :data:`~repro_torch.core.transport.wire.WireKind.ACK` back to the sender
  (payload ``(cum, epoch)``); a lost ack is healed by the retransmit
  it fails to suppress — the dup re-triggers an ack.

* **Deadlines**: ``post_deadline_us`` is a *completion* deadline.  An
  expired send signals ``err(ERR_TIMEOUT)`` to its comps exactly once
  (the pending op is popped, so the eventual ack completes nothing) but
  keeps retransmitting — abandoning the payload would leave a permanent
  gap in the stream and stall every later message behind it.  Expired
  recvs are withdrawn from the matching engine (:meth:`remove` — a
  no-op if they already matched) and err-signaled.

Sequence numbers are allocated and recorded under a per-stream
:class:`~repro_torch.core.concurrency.locks.TryLock`, so concurrent posters
cannot interleave stamp and push; the sweep uses ``try_acquire`` and
moves on, the paper's progress discipline.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from ..concurrency.atomics import AtomicCounter
from ..concurrency.locks import TryLock
from ..matching import MatchKind
from ..status import ErrorCode, err
from .fabric import PACKED_KINDS, PackedBurst, WireKind, WireMsg

#: attrs the reliability plane resolves at runtime construction
RELIABILITY_ATTRS = ("reliability", "post_deadline_us", "retry_limit",
                     "retry_backoff")

#: exponential backoff is capped at ``retry_backoff * _BACKOFF_CAP``
_BACKOFF_CAP = 16


def _rows(msg: WireMsg) -> int:
    """How many stream seqs ``msg`` occupies (packed: one per row)."""
    if msg.kind in PACKED_KINDS:
        return msg.payload.count
    return 1


def _suffix(burst: PackedBurst, start: int) -> PackedBurst:
    """Rows ``[start:]`` of a packed burst (complement of ``prefix``)."""
    return PackedBurst(burst.data[start:], burst.sizes[start:],
                       burst.tags[start:], burst.count - start,
                       burst.wire_dtype)


@dataclasses.dataclass(slots=True)
class _TxEntry:
    """One unacked wire message: ``count`` consecutive seqs starting at
    ``first_seq``.  ``op_id`` is the pending-op completed on ack (or -1
    for inject rows, which retransmit but never signal comps)."""

    first_seq: int
    count: int
    msg: WireMsg
    op_id: int
    last_tx: float
    deadline: float = 0.0          # 0 = no completion deadline
    retries: int = 0
    failed: bool = False           # deadline already err-signaled


@dataclasses.dataclass(slots=True)
class _RecvTrack:
    """A deadline-tracked posted recv (only built when
    ``post_deadline_us > 0``)."""

    key: Any
    value: Any                     # the matching-engine entry (identity)
    comp: Any
    deadline: float
    rank: int
    tag: int
    dev: Any


class ReliabilityManager:
    """Per-runtime ack/retransmit state (sender windows + receiver
    resequencers).  Constructed by :class:`~repro_torch.core.runtime.Runtime`
    when the ``reliability`` attr is ``"on"``, or ``"auto"`` with an
    active message-faulting chaos transport."""

    def __init__(self, rt, resolved):
        self.rt = rt
        self.deadline_us: float = resolved["post_deadline_us"]
        self.retry_limit: int = resolved["retry_limit"]
        self.retry_backoff: float = resolved["retry_backoff"]
        self.epoch = 0
        # sender state, per (dst, device_index) stream
        self._locks: Dict[Tuple[int, int], TryLock] = {}
        self._next_seq: Dict[Tuple[int, int], int] = {}
        self._unacked: Dict[Tuple[int, int], Deque[_TxEntry]] = {}
        # receiver state, per (src, device_index) stream
        self._cum: Dict[Tuple[int, int], int] = {}
        self._hold: Dict[Tuple[int, int], Dict[int, WireMsg]] = {}
        self._ack_pending: Set[Tuple[int, int]] = set()
        self._tracked_recvs: Deque[_RecvTrack] = collections.deque()
        self._dead: Set[int] = set()
        # counters (atomic: posting threads and sweepers race)
        self.retransmits = AtomicCounter()
        self.acks_sent = AtomicCounter()
        self.acks_received = AtomicCounter()
        self.dups_dropped = AtomicCounter()
        self.resequenced = AtomicCounter()
        self.held = AtomicCounter()
        self.expired_timeout = AtomicCounter()
        self.expired_peer_dead = AtomicCounter()
        self.abandoned = AtomicCounter()
        self.stale_epoch = AtomicCounter()

    # -- sender: stamp-on-accept ---------------------------------------------
    def _lock_of(self, key: Tuple[int, int]) -> TryLock:
        lk = self._locks.get(key)
        if lk is None:
            lk = self._locks.setdefault(
                key, TryLock(name=f"rel/{key[0]}.{key[1]}"))
        return lk

    def _record(self, key: Tuple[int, int], msg: WireMsg, op_id: int,
                count: int, now: float) -> _TxEntry:
        deadline = (now + self.deadline_us * 1e-6
                    if self.deadline_us > 0 else 0.0)
        entry = _TxEntry(msg.seq, count, msg, op_id, now, deadline)
        self._unacked.setdefault(key, collections.deque()).append(entry)
        return entry

    def send(self, fabric, msg: WireMsg) -> bool:
        """Stamp one eager message and push it; returns the push result.
        A failed push unstamps (the seq is not consumed), so wire
        acceptance order IS seq order — the FIFO the receiver restores."""
        key = (msg.dst, msg.device_index)
        now = time.monotonic()
        with self._lock_of(key):
            seq = self._next_seq.get(key, 0)
            msg.seq = seq
            msg.epoch = self.epoch
            if msg.dst in self._dead:
                # record-but-never-push: the sweep fails it PEER_DEAD so
                # the op's comps are signaled instead of silently lost
                self._next_seq[key] = seq + 1
                self._record(key, msg, msg.op_id, 1, now)
                return True
            if not fabric.try_push(msg):
                msg.seq = -1
                return False
            self._next_seq[key] = seq + 1
            self._record(key, msg, msg.op_id, 1, now)
        return True

    def send_burst(self, fabric, msgs: List[WireMsg]) -> int:
        """Stamp-and-push one same-stream burst; prefix-accept.  The
        rejected tail is unstamped (seqs rolled back under the lock), so
        the engine's unwind-and-retry re-posts it with fresh seqs."""
        if not msgs:
            return 0
        key = (msgs[0].dst, msgs[0].device_index)
        now = time.monotonic()
        with self._lock_of(key):
            seq = self._next_seq.get(key, 0)
            for i, m in enumerate(msgs):
                m.seq = seq + i
                m.epoch = self.epoch
            if msgs[0].dst in self._dead:
                acc = len(msgs)
            else:
                acc = fabric.push_burst(msgs)
            for m in msgs[acc:]:
                m.seq = -1
            self._next_seq[key] = seq + acc
            for m in msgs[:acc]:
                self._record(key, m, m.op_id, 1, now)
        return acc

    def send_packed(self, fabric, msg: WireMsg) -> int:
        """Stamp one fused doorbell with ``count`` consecutive per-row
        seqs and push it; prefix-accept at row granularity.  The recorded
        entry covers exactly the accepted prefix — ``msg.seq`` stays the
        stamped first seq so the engine can bind the pending-burst op to
        it afterwards (:meth:`bind_op`)."""
        burst: PackedBurst = msg.payload
        key = (msg.dst, msg.device_index)
        now = time.monotonic()
        with self._lock_of(key):
            seq = self._next_seq.get(key, 0)
            msg.seq = seq
            msg.epoch = self.epoch
            if msg.dst in self._dead:
                self._next_seq[key] = seq + burst.count
                self._record(key, msg, -1, burst.count, now)
                return burst.count
            pushed = fabric.push_packed(msg)
            if pushed <= 0:
                msg.seq = -1
                return 0
            self._next_seq[key] = seq + pushed
            rec = msg if pushed == burst.count else dataclasses.replace(
                msg, payload=burst.prefix(pushed),
                size=int(burst.data[:pushed].nbytes))
            self._record(key, rec, -1, pushed, now)
        return pushed

    def bind_op(self, dst: int, device_index: int, first_seq: int,
                op_id: int) -> bool:
        """Attach a pending-op id to the packed entry recorded with
        ``first_seq`` (the engine creates the PendingBurst only after the
        push).  Returns True when bound — the engine must then NOT queue
        the op on ``pending_tx`` (the ack completes it instead)."""
        key = (dst, device_index)
        with self._lock_of(key):
            dq = self._unacked.get(key)
            if dq:
                for entry in reversed(dq):
                    if entry.first_seq == first_seq:
                        entry.op_id = op_id
                        return True
        return False

    # -- receiver: resequence + dedup + ack ----------------------------------
    def _slice_from(self, msg: WireMsg, start: int) -> WireMsg:
        """Rows ``[start:]`` of a partially duplicated delivery (a
        retransmit overlapping the cum counter)."""
        if start <= 0:
            return msg
        nb = _suffix(msg.payload, start)
        return dataclasses.replace(msg, payload=nb, seq=msg.seq + start,
                                   size=int(nb.data.nbytes))

    def on_incoming(self, msgs: List[WireMsg], engine, dev
                    ) -> List[WireMsg]:
        """Filter one drained batch: consume ACKs, drop duplicates and
        stale epochs, hold out-of-order messages, release resequenced
        runs.  Returns the messages the engine should react to, with
        tracked traffic in exact seq order per stream."""
        out: List[WireMsg] = []
        touched: Set[Tuple[int, int]] = set()
        for msg in msgs:
            if msg.kind == WireKind.ACK:
                self._on_ack(msg, engine, dev)
                continue
            if msg.seq < 0:
                out.append(msg)            # untracked control traffic
                continue
            if msg.epoch != self.epoch:
                self.stale_epoch.fetch_add(1)
                continue
            key = (msg.src, msg.device_index)
            if msg.src in self._dead:
                continue                   # a corpse's straggler
            cum = self._cum.get(key, -1)
            count = _rows(msg)
            last = msg.seq + count - 1
            if last <= cum:                # full duplicate
                self.dups_dropped.fetch_add(count)
                touched.add(key)           # re-ack: heals a lost ack
                continue
            if msg.seq > cum + 1:          # gap: hold for the retransmit
                hold = self._hold.setdefault(key, {})
                if msg.seq in hold:
                    self.dups_dropped.fetch_add(count)
                else:
                    hold[msg.seq] = msg
                    self.held.fetch_add(1)
                touched.add(key)
                continue
            # in-order (possibly overlapping a retransmit): deliver the
            # rows beyond cum, then release any consecutive held run
            out.append(self._slice_from(msg, cum + 1 - msg.seq))
            cum = last
            hold = self._hold.get(key)
            while hold:
                ready = [s for s in hold if s <= cum + 1]
                if not ready:
                    break
                s = min(ready)
                m2 = hold.pop(s)
                c2 = _rows(m2)
                l2 = s + c2 - 1
                if l2 <= cum:
                    self.dups_dropped.fetch_add(c2)
                    continue
                out.append(self._slice_from(m2, cum + 1 - s))
                self.resequenced.fetch_add(1)
                cum = l2
            self._cum[key] = cum
            touched.add(key)
        if touched:
            self._ack_pending.update(touched)
            self._flush_acks()
        return out

    def _flush_acks(self) -> bool:
        """Push pending cumulative acks best-effort; a full fabric keeps
        the stream marked and the sweep retries."""
        did = False
        fabric = self.rt.fabric
        for key in list(self._ack_pending):
            cum = self._cum.get(key, -1)
            ack = WireMsg(WireKind.ACK, self.rt.rank, key[0],
                          payload=(cum, self.epoch), device_index=key[1])
            if fabric.try_push(ack):
                self._ack_pending.discard(key)
                self.acks_sent.fetch_add(1)
                did = True
        return did

    def _on_ack(self, msg: WireMsg, engine, dev) -> None:
        """Sender side of an incoming cumulative ack: retire every entry
        fully covered by ``cum`` and complete its pending op."""
        cum, epoch = msg.payload
        if epoch != self.epoch:
            self.stale_epoch.fetch_add(1)
            return
        key = (msg.src, msg.device_index)
        done_entries: List[_TxEntry] = []
        with self._lock_of(key):
            dq = self._unacked.get(key)
            while dq and dq[0].first_seq + dq[0].count - 1 <= cum:
                done_entries.append(dq.popleft())
        self.acks_received.fetch_add(1)
        for e in done_entries:
            if e.op_id >= 0:
                # a deadline-failed op was already popped+err-signaled;
                # complete_tx_op on a popped id is a no-op, so the comps
                # stay exactly-once either way
                engine.complete_tx_op(e.op_id, dev)

    # -- recv deadlines -------------------------------------------------------
    def track_recv(self, key, value, comp, rank: int, tag: int,
                   dev) -> None:
        """Arm a completion deadline for one unmatched posted recv (no-op
        without ``post_deadline_us``, so the default costs nothing)."""
        if self.deadline_us <= 0:
            return
        self._tracked_recvs.append(_RecvTrack(
            key, value, comp, time.monotonic() + self.deadline_us * 1e-6,
            rank if rank is not None else -1,
            tag if tag is not None else -1, dev))

    # -- rank death -----------------------------------------------------------
    def kill_peer(self, rank: int) -> None:
        """Declare ``rank`` dead: the next sweep fails its unacked window
        with ``ERR_PEER_DEAD``; its receiver state is discarded."""
        self._dead.add(rank)
        for key in list(self._hold):
            if key[0] == rank:
                self._hold.pop(key, None)
        self._ack_pending.difference_update(
            k for k in list(self._ack_pending) if k[0] == rank)

    def peer_dead(self, rank: int) -> bool:
        return rank in self._dead

    def bump_epoch(self) -> int:
        """Reset every stream (elastic shrink / recovery): in-flight
        traffic from the old epoch is dropped on arrival."""
        self.epoch += 1
        self._next_seq.clear()
        self._unacked.clear()
        self._cum.clear()
        self._hold.clear()
        self._ack_pending.clear()
        return self.epoch

    # -- the sweep stage ------------------------------------------------------
    def sweep(self, engine, dev) -> bool:
        """One timer pass: retransmit overdue entries, expire deadlines,
        fail dead-peer windows, flush stuck acks, expire tracked recvs.
        Called from the progress reaction chain when :meth:`armed`."""
        did = False
        now = time.monotonic()
        fabric = self.rt.fabric
        for key in list(self._unacked.keys()):
            lock = self._lock_of(key)
            if not lock.try_acquire():
                continue                   # another thread owns the stream
            try:
                dq = self._unacked.get(key)
                if not dq:
                    continue
                if key[0] in self._dead:
                    while dq:
                        e = dq.popleft()
                        if e.op_id >= 0:
                            engine.fail_tx_op(e.op_id, dev,
                                              ErrorCode.ERR_PEER_DEAD)
                        self.expired_peer_dead.fetch_add(1)
                    did = True
                    continue
                drop: List[_TxEntry] = []
                for e in dq:
                    if e.deadline and not e.failed and now >= e.deadline:
                        # completion deadline: err the op exactly once
                        # but KEEP retransmitting — abandoning the seq
                        # would stall the receiver's stream on the gap
                        e.failed = True
                        if e.op_id >= 0:
                            engine.fail_tx_op(e.op_id, dev,
                                              ErrorCode.ERR_TIMEOUT)
                        self.expired_timeout.fetch_add(1)
                        did = True
                    wait = self.retry_backoff * min(1 << e.retries,
                                                    _BACKOFF_CAP)
                    if now - e.last_tx < wait:
                        continue
                    if e.retries >= self.retry_limit:
                        if e.op_id >= 0 and not e.failed:
                            engine.fail_tx_op(e.op_id, dev,
                                              ErrorCode.ERR_TIMEOUT)
                        self.abandoned.fetch_add(1)
                        drop.append(e)
                        did = True
                        continue
                    if e.msg.kind in PACKED_KINDS:
                        ok = fabric.push_packed(e.msg) > 0
                    else:
                        ok = fabric.try_push(e.msg)
                    if ok:
                        # a partial packed re-push still counts: the
                        # receiver dedups rows, the suffix rides the
                        # next attempt
                        e.retries += 1
                        e.last_tx = now
                        self.retransmits.fetch_add(1)
                        did = True
                for e in drop:
                    dq.remove(e)
            finally:
                lock.release()
        if self._ack_pending:
            did |= self._flush_acks()
        dq = self._tracked_recvs
        while dq:
            try:
                head = dq[0]
            except IndexError:
                break
            if head.deadline > now:
                break
            try:
                dq.remove(head)
            except ValueError:
                continue                   # another sweeper got it
            if head.rank >= 0 and head.rank in self._dead:
                code = ErrorCode.ERR_PEER_DEAD
            else:
                code = ErrorCode.ERR_TIMEOUT
            if self.rt.matching.remove(head.key, MatchKind.RECV,
                                       head.value):
                engine.signal(head.comp,
                              err(code,
                                  rank=None if head.rank < 0 else head.rank,
                                  tag=None if head.tag < 0 else head.tag),
                              head.dev or dev)
                self.expired_timeout.fetch_add(1)
                did = True
        return did

    # -- probes ---------------------------------------------------------------
    def armed(self) -> bool:
        """Timer work pending (the progress idle fast path must not skip
        the pass): unacked entries, stuck acks, or tracked recvs."""
        if self._ack_pending or self._tracked_recvs:
            return True
        for dq in self._unacked.values():
            if dq:
                return True
        return False

    def busy(self) -> bool:
        """Quiesce probe: also counts receiver hold buffers (a gap that
        is still waiting on the peer's retransmit)."""
        return self.armed() or any(self._hold.values())

    def counters(self) -> dict:
        return {"retransmits": self.retransmits.load(),
                "acks_sent": self.acks_sent.load(),
                "acks_received": self.acks_received.load(),
                "dups_dropped": self.dups_dropped.load(),
                "resequenced": self.resequenced.load(),
                "held": self.held.load(),
                "expired_timeout": self.expired_timeout.load(),
                "expired_peer_dead": self.expired_peer_dead.load(),
                "abandoned": self.abandoned.load(),
                "stale_epoch": self.stale_epoch.load(),
                "epoch": self.epoch}
