"""The ``socket`` backend — stream-socket fallback transport.

Where shm rings need a shared ``/dev/shm``, sockets only need a path (or
a host:port), so this backend is the cross-host fallback in the backend
matrix (DESIGN.md §14).  Unix-domain sockets with deterministic names::

    {session}/rank{r}.sock

Each rank process listens on its own socket; producers connect lazily on
first push and send length-prefixed codec frames (``[u32 len][frame]``).
The consumer side pumps ``accept``/``recv`` non-blocking from the probe
and drain calls themselves — no extra threads, matching the paper's
explicit-progress model (§3.2.4): the network only moves when somebody
calls progress.

Depth semantics differ from the in-memory backends where they must: the
producer cannot observe the remote queue, so the row-weighted ``depth``
bound applies to *locally buffered* (not-yet-flushed) messages per
stream — kernel socket buffers provide the rest of the back-pressure.
``ready``/``stream_depth`` report the local inbox after a non-blocking
pump, which keeps the unlocked idle-probe contract (a stale answer costs
one extra poll).  The wire-latency model is ignored: sockets have real
latency.  In solo mode (all ranks in one process) the backend still
works — the process owns every listener and messages loop through the
kernel — which keeps the backend testable single-process.
"""
from __future__ import annotations

import collections
import errno
import os
import socket as _socket
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import attrs as _attrs
from ..status import FatalError
from .base import Transport
from .codec import decode_msg, encode_msg
from .wire import PackedBurst, WireMsg, msg_weight

_LEN = struct.Struct("<I")
_SPMD_RANK_ENV = "REPRO_SPMD_RANK"
_SPMD_SESSION_ENV = "REPRO_SPMD_SESSION"
_CONNECT_RETRY_S = 5.0


class SocketTransport(Transport):
    """Unix-domain socket transport (see module docstring)."""

    backend = "socket"

    def __init__(self, n_ranks: int, depth: int = 4096,
                 latency: float = 0.0,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 rank: Optional[int] = None,
                 session: Optional[str] = None, **_ignored):
        super().__init__(n_ranks, depth, latency, resolved)
        env_rank = os.environ.get(_SPMD_RANK_ENV)
        self.rank = rank if rank is not None else (
            int(env_rank) if env_rank is not None else None)
        self.spmd = self.rank is not None
        session = session or os.environ.get(_SPMD_SESSION_ENV)
        if session:
            self._dir = (session if os.path.isabs(session)
                         else os.path.join(tempfile.gettempdir(), session))
            os.makedirs(self._dir, exist_ok=True)
            self._owns_dir = False
        else:
            self._dir = tempfile.mkdtemp(prefix="repro-sock-")
            self._owns_dir = True
        self._lock = threading.Lock()
        # listeners: my rank in spmd mode, every rank in solo mode
        self._listeners: Dict[int, _socket.socket] = {}
        for r in ([self.rank] if self.spmd else range(n_ranks)):
            srv = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            srv.setblocking(False)
            srv.bind(self._sock_path(r))
            srv.listen(2 * n_ranks)
            self._listeners[r] = srv
        self._conns: List[Tuple[_socket.socket, bytearray]] = []
        self._out: Dict[int, _socket.socket] = {}       # dst -> client sock
        # producer-side local buffering, row-weighted per stream
        self._txq: Dict[int, collections.deque] = {}    # dst -> frames
        self._tx_weight: Dict[Tuple[int, int], int] = {}
        # consumer-side inbox per (dst, device) stream
        self._inbox: Dict[Tuple[int, int], collections.deque] = {}
        self._closed = False
        self._dead_dsts: set = set()
        self._tx_flushes = 0             # coalesced kernel sends
        self._tx_flush_frames = 0        # frames those sends carried
        self._export_attr("socket_session_dir", lambda: self._dir)
        self._export_attr("socket_dead_dsts",
                          lambda: sorted(self._dead_dsts))
        self._export_attr("socket_flush_batches", lambda: self._tx_flushes)
        self._export_attr("socket_flush_frames",
                          lambda: self._tx_flush_frames)

    def _sock_path(self, rank: int) -> str:
        return os.path.join(self._dir, f"rank{rank}.sock")

    # -- producer side ----------------------------------------------------
    def _connect(self, dst: int) -> _socket.socket:
        sock = self._out.get(dst)
        if sock is not None:
            return sock
        path = self._sock_path(dst)
        deadline = time.monotonic() + _CONNECT_RETRY_S
        while True:
            try:
                sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
                sock.connect(path)
                break
            except OSError:
                sock.close()
                if time.monotonic() >= deadline:
                    raise FatalError(
                        f"socket transport: cannot connect to rank {dst} "
                        f"at {path} after {_CONNECT_RETRY_S}s")
                time.sleep(0.01)         # peer may not have bound yet
        sock.setblocking(False)
        self._out[dst] = sock
        return sock

    def _mark_dst_dead(self, dst: int) -> None:
        """A hard socket error (EPIPE/ECONNRESET/refused) means the peer
        process is gone: its frames can never be delivered.  Drop the
        stream instead of wedging or crashing the survivor — rank-death
        *semantics* (ERR_PEER_DEAD on outstanding ops) belong to the
        failure detector and reliability layer above (DESIGN.md §16);
        the transport's job is merely to stay alive."""
        self._dead_dsts.add(dst)
        q = self._txq.pop(dst, None)
        if q:
            for _frame, key, weight in q:
                self._tx_weight[key] = self._tx_weight.get(key, 0) - weight
        sock = self._out.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    #: frames coalesced per kernel send — bounds the join copy while a
    #: deep queue still drains in a handful of syscalls
    _FLUSH_COALESCE = 64
    #: bytes one coalesced send joins at most (a frame larger than this
    #: goes alone): the kernel takes a few hundred KiB a send, so joining
    #: a queue of 4 MiB frames (fused doorbells of 64 KiB rows) for each
    #: send would copy the queue over and over
    _FLUSH_COALESCE_BYTES = 1 << 20

    def _flush(self, dst: int) -> None:
        """Push buffered frames into the kernel; stops when it would
        block (the kernel buffer is the real back-pressure).

        Frames queued for ``dst`` coalesce into one contiguous send — a
        writev-style flush: a burst of K messages costs one syscall, not
        K.  Depth accounting walks the accepted byte count afterwards:
        fully-sent frames pop and decrement their stream's row weight, a
        partially-sent head frame is re-sliced in place, as a view of its
        unsent bytes (no copy)."""
        q = self._txq.get(dst)
        if not q:
            return
        try:
            sock = self._connect(dst)
        except FatalError:
            self._mark_dst_dead(dst)     # connect refused past the grace
            return
        while q:
            chunk, size = [], 0
            for i in range(min(len(q), self._FLUSH_COALESCE)):
                frame = q[i][0]
                if chunk and size + len(frame) > self._FLUSH_COALESCE_BYTES:
                    break
                chunk.append(frame)
                size += len(frame)
            blob = chunk[0] if len(chunk) == 1 else b"".join(chunk)
            try:
                sent = sock.send(blob)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return
                self._mark_dst_dead(dst)
                return
            self._tx_flushes += 1
            for frame in chunk:
                if sent >= len(frame):
                    sent -= len(frame)
                    _f, key, weight = q.popleft()
                    self._tx_weight[key] = \
                        self._tx_weight.get(key, 0) - weight
                    self._tx_flush_frames += 1
                else:
                    if sent:                   # partial head: re-slice
                        head, key, weight = q[0]
                        q[0] = (memoryview(head)[sent:], key, weight)
                    return

    def _enqueue(self, msg: WireMsg, weight: int) -> bool:
        if msg.dst in self._dead_dsts:
            # accepted-and-dropped: the peer is gone, back-pressure would
            # never clear; liveness for the caller, loss handled above
            self._pushes.fetch_add(weight)
            return True
        key = (msg.dst, msg.device_index)
        if self._tx_weight.get(key, 0) + weight > self.depth:
            self._flush(msg.dst)
            if self._tx_weight.get(key, 0) + weight > self.depth:
                self._full_events.fetch_add(1)
                return False
        body = encode_msg(msg)
        frame = _LEN.pack(len(body)) + body
        self._txq.setdefault(msg.dst, collections.deque()).append(
            (frame, key, weight))
        self._tx_weight[key] = self._tx_weight.get(key, 0) + weight
        self._pushes.fetch_add(weight)
        return True

    def try_push(self, msg: WireMsg) -> bool:
        with self._lock:
            ok = self._enqueue(msg, 1)
            if ok:
                self._flush(msg.dst)
            return ok

    def push_burst(self, msgs: Sequence[WireMsg]) -> int:
        if not msgs:
            return 0
        dst, _didx = self.check_stream(msgs)
        accepted = 0
        with self._lock:
            for m in msgs:
                if not self._enqueue(m, 1):
                    break                # prefix stands, never a subsequence
                accepted += 1
            self._flush(dst)
        return accepted

    def push_packed(self, msg: WireMsg) -> int:
        burst: PackedBurst = msg.payload
        key = (msg.dst, msg.device_index)
        with self._lock:
            self._flush(msg.dst)
            room = self.depth - self._tx_weight.get(key, 0)
            n = min(burst.count, max(0, room))
            if n < burst.count:
                self._full_events.fetch_add(1)
            if n == 0:
                return 0
            if n < burst.count:
                import dataclasses
                pb = burst.prefix(n)
                msg = dataclasses.replace(msg, payload=pb,
                                          size=int(pb.data.nbytes))
            if not self._enqueue(msg, n):
                return 0
            self._flush(msg.dst)
            return n

    # -- consumer side ----------------------------------------------------
    def _pump(self) -> None:
        """Non-blocking accept + recv + frame demux into the inbox."""
        for srv in self._listeners.values():
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    break
                conn.setblocking(False)
                self._conns.append((conn, bytearray()))
        live: List[Tuple[_socket.socket, bytearray]] = []
        for conn, buf in self._conns:
            eof = False
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                except OSError as e:
                    if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                        break
                    eof = True
                    break
                if not chunk:
                    eof = True
                    break
                buf.extend(chunk)
            off = 0
            while len(buf) - off >= _LEN.size:
                (nbytes,) = _LEN.unpack_from(buf, off)
                if len(buf) - off - _LEN.size < nbytes:
                    break
                msg, _ = decode_msg(
                    memoryview(buf)[off + _LEN.size:off + _LEN.size + nbytes])
                self._inbox.setdefault(
                    (msg.dst, msg.device_index),
                    collections.deque()).append(msg)
                off += _LEN.size + nbytes
            if off:
                del buf[:off]
            if not eof or buf:
                live.append((conn, buf))
            else:
                conn.close()
        self._conns = live
        # opportunistic producer flush: a pump is a progress call
        for dst in list(self._txq):
            if self._txq[dst]:
                try:
                    self._flush(dst)
                except FatalError:
                    pass                 # peer not up yet; next pump retries

    def drain(self, dst: int, device_index: int, limit: int = 0
              ) -> List[WireMsg]:
        if limit < 0:
            raise ValueError(f"drain: limit must be >= 0 (0 = drain all), "
                             f"got {limit}")
        out: List[WireMsg] = []
        weight = 0
        with self._lock:
            self._pump()
            q = self._inbox.get((dst, device_index))
            while q and (limit == 0 or weight < limit):
                msg = q.popleft()
                out.append(msg)
                weight += msg_weight(msg)
        return out

    def ready(self, dst: int, device_index: int) -> bool:
        return self.stream_depth(dst, device_index) > 0

    def stream_depth(self, dst: int, device_index: int) -> int:
        q = self._inbox.get((dst, device_index))
        if q:
            return sum(msg_weight(m) for m in q)
        # empty inbox: pump once so idle probes observe arrivals
        if self._lock.acquire(blocking=False):
            try:
                self._pump()
                q = self._inbox.get((dst, device_index))
            finally:
                self._lock.release()
        return sum(msg_weight(m) for m in q) if q else 0

    def in_flight(self) -> int:
        """Locally observable: inbox rows + not-yet-flushed tx rows."""
        return (sum(msg_weight(m) for q in self._inbox.values() for m in q)
                + sum(max(0, w) for w in self._tx_weight.values()))

    def pending_to(self, dst: int) -> int:
        return (sum(msg_weight(m) for (d, _i), q in self._inbox.items()
                    if d == dst for m in q)
                + sum(max(0, w) for (d, _i), w in self._tx_weight.items()
                      if d == dst))

    def pending_streams(self, dst: int) -> List[int]:
        with self._lock:
            self._pump()
            return sorted(i for (d, i), q in self._inbox.items()
                          if d == dst and q)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in self._out.values():
            try:
                sock.close()
            except OSError:
                pass
        for conn, _buf in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        for r, srv in self._listeners.items():
            try:
                srv.close()
            except OSError:
                pass
            try:
                os.unlink(self._sock_path(r))
            except OSError:
                pass
        if self._owns_dir:
            import shutil
            shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
