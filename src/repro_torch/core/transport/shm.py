"""The ``shm`` backend — shared-memory ring buffers between OS processes.

This is the transport that makes the paper's central comparison real:
N *processes* on one host exchanging wire messages through per-stream
shared-memory rings instead of N threads sharing one address space.

Layout.  Each stream is one (or, cross-process, ``n_ranks``) ring
file(s) under a session directory in ``/dev/shm``::

    ring_p{producer}_d{dst}_{device}     (header page + data region)

Rings are strict SPSC per the paper's §4.1 atomics discipline: the
producer *process* owns the write cursor and the pushed counter, the
consumer process owns the read cursor and the drained counter, and no
cross-process read-modify-write ever happens — depth is computed as
``pushed − drained`` from two single-writer counters.  The counters sit
on separate 64-byte lines of the header page (no false sharing), and
``stream_depth`` is exactly the ISSUE's "unlocked head peek": two loads,
no locks, so ``Endpoint.progress`` idle-skip works unchanged.

Two deployment modes share the code path:

* **solo** (default, e.g. tier-1 under ``REPRO_ATTR_FABRIC_BACKEND=shm``):
  all ranks live in one process, which is therefore both producer and
  consumer of every ring — producer id 0, one ring per ``(dst, device)``
  stream, a per-ring ``threading.Lock`` serializing in-process
  multithreaded producers (the SPSC discipline is per *process*, not per
  thread).
* **spmd** (under ``launch/spmd.py``): each rank process produces into
  its own ring per ``(dst, device)`` and consumes the ``n_ranks``
  producer rings addressed to it.  Ring creation is idempotent
  (fixed-size, zero-initialized), so whichever side touches a stream
  first creates the file and the other side attaches.

Records never wrap: if the space left before the end of the data region
cannot hold a record, the producer writes a PAD record (or, below one
header, skips implicitly) and continues at offset 0.  Payloads larger
than half the ring (rendezvous RDMA payloads run to megabytes) spill to
a side file and ride the ring as an 8-byte reference — back-pressure
still applies, the bytes just live outside the ring.
"""
from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import attrs as _attrs
from ..status import FatalError
from .base import Transport
from .codec import decode_msg, encode_msg, frame_bytes
from .wire import PackedBurst, WireMsg, msg_weight

# header-page slots (one per 64-byte cache line; u64 little-endian).
# pushed/tail are producer-owned, drained/head consumer-owned — the
# single-writer discipline that lets the other side read them unlocked.
_OFF_PUSHED = 0
_OFF_TAIL = 64
_OFF_DRAINED = 128
_OFF_HEAD = 192
_HEADER_BYTES = 4096

# record header: [u32 span][u8 flags][u32 weight][f64 ready_at]
_REC = struct.Struct("<IBId")
_REC_SIZE = _REC.size
_F_PAD = 1
_F_SPILL = 2

_SPMD_RANK_ENV = "REPRO_SPMD_RANK"
_SPMD_SESSION_ENV = "REPRO_SPMD_SESSION"


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


class _Ring:
    """One mmap'd SPSC ring file (create-or-attach, idempotent)."""

    def __init__(self, path: str, capacity: int):
        self.path = path
        self.capacity = capacity
        size = _HEADER_BYTES + capacity
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, size)       # idempotent: fixed deterministic size
            import mmap
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)

    # -- counter slots (8-byte aligned; effectively atomic on this ABI) --
    # Each access is ONE 8-byte copy (an mmap slice): ``struct.pack_into``
    # zero-fills its target before it stores and ``unpack_from`` reads
    # byte by byte, so a process racing either could read a torn counter
    # (a tail of 0 sends the consumer into stale ring bytes).
    def _get(self, off: int) -> int:
        return int.from_bytes(self.mm[off:off + 8], "little")

    def _put(self, off: int, value: int) -> None:
        self.mm[off:off + 8] = value.to_bytes(8, "little")

    @property
    def pushed(self) -> int:
        return self._get(_OFF_PUSHED)

    @property
    def drained(self) -> int:
        return self._get(_OFF_DRAINED)

    def depth(self) -> int:
        """Row-weighted occupancy: two unlocked loads, never negative
        (a racing consumer can only make the stream look fuller)."""
        return max(0, self.pushed - self.drained)

    # -- producer side ----------------------------------------------------
    def _place(self, span: int) -> Optional[Tuple[int, int, int]]:
        """``(tail, pos, rem)`` for a record of ``span`` bytes, or
        ``None`` when the free bytes (wrap padding included) are short."""
        tail = self._get(_OFF_TAIL)
        head = self._get(_OFF_HEAD)
        free = self.capacity - (tail - head)
        pos = tail % self.capacity
        rem = self.capacity - pos
        pad = rem if rem < span else 0     # wrap cost if the record won't fit
        if span + pad > free:
            return None
        return tail, pos, rem

    def fits(self, nbytes: int) -> bool:
        """Whether a record of ``nbytes`` body bytes fits now.  Only the
        producer writes, so the room can only grow until it does."""
        return self._place(_REC_SIZE + nbytes) is not None

    def try_write(self, body: bytes, weight: int, ready_at: float,
                  flags: int = 0) -> bool:
        """Append one record; ``False`` = not enough free bytes."""
        span = _REC_SIZE + len(body)
        place = self._place(span)
        if place is None:
            return False
        tail, pos, rem = place
        pad = rem if rem < span else 0
        if pad:
            if rem >= _REC_SIZE:           # explicit PAD record
                _REC.pack_into(self.mm, _HEADER_BYTES + pos, rem, _F_PAD,
                               0, 0.0)
            # rem < _REC_SIZE: implicit skip — consumer applies the same rule
            tail += pad
            pos = 0
        base = _HEADER_BYTES + pos
        _REC.pack_into(self.mm, base, span, flags, weight, ready_at)
        self.mm[base + _REC_SIZE:base + span] = body
        # publish AFTER the record bytes are in place (x86-TSO store order;
        # the GIL serializes the in-process case)
        self._put(_OFF_TAIL, tail + span)
        self._put(_OFF_PUSHED, self.pushed + weight)
        return True

    # -- consumer side ----------------------------------------------------
    def _skip_pads(self, head: int, tail: int) -> int:
        """Resolve ``head`` past pad/skip space to a real record (or tail)."""
        while head != tail:
            pos = head % self.capacity
            rem = self.capacity - pos
            if rem < _REC_SIZE:
                head += rem
                continue
            span, flags, _w, _r = _REC.unpack_from(
                self.mm, _HEADER_BYTES + pos)
            if flags & _F_PAD:
                head += span
                continue
            break
        return head

    def peek(self) -> Optional[Tuple[int, int, int, float]]:
        """Head record's ``(pos, span, flags, ready_at)`` without
        consuming — pure, safe from any thread (stale, never corrupt)."""
        tail = self._get(_OFF_TAIL)
        head = self._skip_pads(self._get(_OFF_HEAD), tail)
        if head == tail:
            return None
        pos = head % self.capacity
        span, flags, _w, ready_at = _REC.unpack_from(
            self.mm, _HEADER_BYTES + pos)
        return pos, span, flags, ready_at

    def read(self) -> Optional[Tuple[bytes, int, int, float]]:
        """Consume the head record: ``(body, weight, flags, ready_at)``."""
        tail = self._get(_OFF_TAIL)
        head = self._skip_pads(self._get(_OFF_HEAD), tail)
        if head == tail:
            if head != self._get(_OFF_HEAD):   # persist pad skips
                self._put(_OFF_HEAD, head)
            return None
        pos = head % self.capacity
        base = _HEADER_BYTES + pos
        span, flags, weight, ready_at = _REC.unpack_from(self.mm, base)
        body = bytes(self.mm[base + _REC_SIZE:base + span])
        self._put(_OFF_HEAD, head + span)
        self._put(_OFF_DRAINED, self.drained + weight)
        return body, weight, flags, ready_at

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass


class ShmTransport(Transport):
    """Shared-memory ring transport (see module docstring for layout)."""

    backend = "shm"

    def __init__(self, n_ranks: int, depth: int = 4096,
                 latency: float = 0.0,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 ring_bytes: int = 1 << 20,
                 rank: Optional[int] = None,
                 session: Optional[str] = None, **_ignored):
        super().__init__(n_ranks, depth, latency, resolved)
        if resolved is not None and "shm_ring_bytes" in resolved:
            ring_bytes = resolved["shm_ring_bytes"]
        self.ring_bytes = ring_bytes
        # deployment mode: spmd (one process per rank) when a rank id is
        # given or the launcher's env is present, else solo (all ranks
        # in-process, single producer id 0)
        env_rank = os.environ.get(_SPMD_RANK_ENV)
        self.rank = rank if rank is not None else (
            int(env_rank) if env_rank is not None else None)
        self.spmd = self.rank is not None
        session = session or os.environ.get(_SPMD_SESSION_ENV)
        if session:
            self._dir = (session if os.path.isabs(session)
                         else os.path.join(_shm_dir(), session))
            os.makedirs(self._dir, exist_ok=True)
            self._owns_dir = False       # the launcher reaps the session
        else:
            self._dir = tempfile.mkdtemp(prefix="repro-shm-",
                                         dir=_shm_dir())
            self._owns_dir = True
        self._producer_id = self.rank if self.spmd else 0
        self._producer_ids = (tuple(range(n_ranks)) if self.spmd else (0,))
        self._rings: Dict[Tuple[int, int, int], _Ring] = {}
        self._plocks: Dict[Tuple[int, int], threading.Lock] = {}
        self._spill_seq: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()    # guards the maps, not the rings
        self._closed = False
        self._export_attr("shm_ring_bytes", lambda: self.ring_bytes)
        self._export_attr("shm_session_dir", lambda: self._dir)

    # -- ring bookkeeping -------------------------------------------------
    def _ring(self, producer: int, dst: int, didx: int) -> _Ring:
        key = (producer, dst, didx)
        ring = self._rings.get(key)
        if ring is None:
            with self._lock:
                ring = self._rings.get(key)
                if ring is None:
                    path = os.path.join(
                        self._dir, f"ring_p{producer}_d{dst}_{didx}")
                    ring = _Ring(path, self.ring_bytes)
                    self._rings[key] = ring
        return ring

    def _plock(self, dst: int, didx: int) -> threading.Lock:
        key = (dst, didx)
        lock = self._plocks.get(key)
        if lock is None:
            with self._lock:
                lock = self._plocks.setdefault(key, threading.Lock())
        return lock

    def _stamp(self) -> float:
        # monotonic: comparable across processes on one Linux host
        return time.monotonic() + self.latency if self.latency else 0.0

    # -- producer side ----------------------------------------------------
    def _write_msg(self, ring: _Ring, msg: WireMsg, weight: int,
                   dst: int, didx: int) -> bool:
        # room first: a frame the ring refuses is never encoded, so a
        # CUDA payload crosses to the host once however often it waits
        size = frame_bytes(msg)
        spill = _REC_SIZE + size > self.ring_bytes // 2
        if not ring.fits(8 if spill else size):
            self._full_events.fetch_add(1)
            return False
        body = encode_msg(msg)
        flags = 0
        if spill:
            # oversized (rendezvous payloads): spill to a side file, ride
            # the ring as an 8-byte reference so FIFO order is preserved
            key = (dst, didx)
            seq = self._spill_seq.get(key, 0)
            path = self._spill_path(self._producer_id, dst, didx, seq)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(body)
            os.rename(tmp, path)         # atomic publish
            probe = struct.pack("<Q", seq)
            if not ring.try_write(probe, weight, self._stamp(), _F_SPILL):
                os.unlink(path)
                self._full_events.fetch_add(1)
                return False
            self._spill_seq[key] = seq + 1
            self._pushes.fetch_add(weight)
            return True
        if not ring.try_write(body, weight, self._stamp(), flags):
            self._full_events.fetch_add(1)
            return False
        self._pushes.fetch_add(weight)
        return True

    def _spill_path(self, producer: int, dst: int, didx: int,
                    seq: int) -> str:
        return os.path.join(self._dir,
                            f"spill_p{producer}_d{dst}_{didx}_{seq}.bin")

    def _room(self, ring: _Ring, want: int) -> int:
        """How many of ``want`` rows fit under the row-weighted depth
        bound right now (byte capacity is checked at write time)."""
        return min(want, max(0, self.depth - ring.depth()))

    def try_push(self, msg: WireMsg) -> bool:
        dst, didx = msg.dst, msg.device_index
        ring = self._ring(self._producer_id, dst, didx)
        with self._plock(dst, didx):
            if self._room(ring, 1) < 1:
                self._full_events.fetch_add(1)
                return False
            return self._write_msg(ring, msg, 1, dst, didx)

    def push_burst(self, msgs: Sequence[WireMsg]) -> int:
        if not msgs:
            return 0
        dst, didx = self.check_stream(msgs)
        ring = self._ring(self._producer_id, dst, didx)
        accepted = 0
        with self._plock(dst, didx):
            n = self._room(ring, len(msgs))
            if n < len(msgs):
                self._full_events.fetch_add(1)
            for m in msgs[:n]:
                if not self._write_msg(ring, m, 1, dst, didx):
                    break                # ring bytes full: prefix stands
                accepted += 1
        return accepted

    def push_packed(self, msg: WireMsg) -> int:
        burst: PackedBurst = msg.payload
        dst, didx = msg.dst, msg.device_index
        ring = self._ring(self._producer_id, dst, didx)
        with self._plock(dst, didx):
            n = self._room(ring, burst.count)
            if n < burst.count:
                self._full_events.fetch_add(1)
            if n == 0:
                return 0
            if n < burst.count:          # prefix-accept split
                pb = burst.prefix(n)
                import dataclasses
                msg = dataclasses.replace(msg, payload=pb,
                                          size=int(pb.data.nbytes))
            if not self._write_msg(ring, msg, n, dst, didx):
                return 0                 # ring bytes full: whole doorbell
            return n

    # -- consumer side ----------------------------------------------------
    def _read_record(self, producer: int, dst: int, didx: int,
                     ring: _Ring) -> Optional[WireMsg]:
        rec = ring.read()
        if rec is None:
            return None
        body, _weight, flags, _ready = rec
        if flags & _F_SPILL:
            (seq,) = struct.unpack("<Q", body)
            path = self._spill_path(producer, dst, didx, seq)
            with open(path, "rb") as f:
                body = f.read()
            os.unlink(path)
        msg, _ = decode_msg(body)
        return msg

    def drain(self, dst: int, device_index: int, limit: int = 0
              ) -> List[WireMsg]:
        if limit < 0:
            raise ValueError(f"drain: limit must be >= 0 (0 = drain all), "
                             f"got {limit}")
        out: List[WireMsg] = []
        weight = 0
        now = time.monotonic() if self.latency else 0.0
        for producer in self._producer_ids:
            ring = self._ring(producer, dst, device_index)
            while limit == 0 or weight < limit:
                head = ring.peek()
                if head is None:
                    break
                _pos, _span, _flags, ready_at = head
                if ready_at and ready_at > now:
                    break                # FIFO: stop at the on-the-wire head
                msg = self._read_record(producer, dst, device_index, ring)
                if msg is None:
                    break
                out.append(msg)
                weight += msg_weight(msg)
        return out

    def ready(self, dst: int, device_index: int) -> bool:
        if not self.latency:
            return self.stream_depth(dst, device_index) > 0
        now = time.monotonic()
        for producer in self._producer_ids:
            head = self._ring(producer, dst, device_index).peek()
            if head is not None and head[3] <= now:
                return True
        return False

    def stream_depth(self, dst: int, device_index: int) -> int:
        # the ISSUE's unlocked head peek: two counter loads per ring
        return sum(self._ring(p, dst, device_index).depth()
                   for p in self._producer_ids)

    def in_flight(self) -> int:
        """Row-weighted occupancy of every ring this process has touched
        (solo mode sees everything; spmd ranks see their own streams)."""
        with self._lock:
            rings = list(self._rings.values())
        return sum(r.depth() for r in rings)

    def pending_to(self, dst: int) -> int:
        with self._lock:
            items = list(self._rings.items())
        return sum(r.depth() for (p, d, i), r in items if d == dst)

    def pending_streams(self, dst: int) -> List[int]:
        # scan the session dir too: a producer in another process may
        # have created streams this process never touched
        didxs = set()
        try:
            names = os.listdir(self._dir)
        except OSError:
            names = []
        for name in names:
            if not name.startswith("ring_p"):
                continue
            try:
                p, d, i = name[6:].split("_")
                producer, d, i = int(p), int(d[1:]), int(i)
            except ValueError:
                continue
            if d == dst and producer in self._producer_ids:
                if self._ring(producer, d, i).depth() > 0:
                    didxs.add(i)
        for (p, d, i), r in list(self._rings.items()):
            if d == dst and r.depth() > 0:
                didxs.add(i)
        return sorted(didxs)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            rings, self._rings = list(self._rings.values()), {}
        for ring in rings:
            ring.close()
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
