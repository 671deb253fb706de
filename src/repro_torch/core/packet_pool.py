"""Packet pool (paper §4.1.2) — fixed-size pre-registered buffer management.

The paper's packet pool is a collection of per-thread deques of fixed-size
pre-registered buffers ("packets"):

* ``get`` pops from the tail of the local deque; when empty it steals *half*
  of a randomly selected victim's packets from the head (one attempt, then
  the nonblocking ``get`` fails and ``post_comm`` returns ``retry``).
* ``put`` pushes to the tail (cache locality: hot packets are reused first).
* stealing happens at the head end (cold packets), local traffic at the tail.

Two implementations, mirroring :mod:`repro_torch.core.matching`:

1. :class:`HostPacketPool` — Python deques, used by the host-side runtime
   (message staging for the buffer-copy protocol, serving KV page allocator,
   aggregation buffers).  Since the concurrency subsystem landed this is
   the paper's §4.1.2 design verbatim: each lane's deque is guarded by a
   spinlock-style :class:`~repro_torch.core.concurrency.TryLock`; local get/put
   take their own lane's lock (blocking spin — a lane is rarely contended
   by design), while a steal attempt *try-locks* the victim and, on
   failure, gives up immediately so the nonblocking ``get`` surfaces
   ``retry(RETRY_NOPACKET)`` rather than waiting (paper: "``get`` can be
   nonblocking and will return a nullptr when it fails the first packet
   stealing attempts").  Holding one's own lane lock while try-locking a
   victim cannot deadlock: the second acquisition never blocks.
2. Functional tensor pool (:func:`init_pool` / :func:`pool_get` /
   :func:`pool_put`) — a fixed-geometry slot pool held in ``int32``
   tensors on an explicit device, the mirror of the reference's jitted
   pool.  Every op is branch-free tensor arithmetic (both sides of the
   reference's ``lax.cond`` are computed and selected with
   ``torch.where``), so a pool on the card never syncs with the host.

Status protocol: ``get`` returns packet id ``-1`` + ``retry`` status on
exhaustion (paper: "``get`` can be nonblocking and will return a nullptr
when it fails the first packet stealing attempts").
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import attrs as _attrs
from .concurrency.atomics import AtomicCounter
from .concurrency.locks import TryLock, aggregate_lock_stats
from .status import ErrorCode, Status, done, retry
from .telemetry import NULL_TELEMETRY

#: attrs the host pool resolves at alloc time
POOL_ATTRS = ("pool_lanes", "packets_per_lane", "packet_bytes")


class HostPacketPool(_attrs.AttrResource):
    """Host-side packet pool: per-lane locked deques + try-lock steal-half.

    ``n_lanes`` plays the role of the paper's thread count; each lane owns a
    deque seeded with ``packets_per_lane`` packet ids.  Packets are plain
    integer ids into a backing buffer table (``buffer_of``), so "allocation"
    never copies.  Every deque (and its victim-selection RNG) is protected
    by that lane's :class:`TryLock`; counters are atomic so telemetry stays
    exact under concurrent get/put/steal.
    """

    def __init__(self, n_lanes: int, packets_per_lane: int,
                 packet_bytes: int = 8192, seed: int = 0,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 tele=None):
        self.n_lanes = n_lanes
        self.packet_bytes = packet_bytes
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"pool_lanes": n_lanes, "packets_per_lane": packets_per_lane,
             "packet_bytes": packet_bytes}))
        self._export_attr("width", lambda: self.n_lanes)
        self._export_attr("free_packets", self.free_packets)
        self._export_attr("steals", lambda: self.steals)
        self._export_attr("steal_lock_failures",
                          lambda: self.steal_lock_failures)
        self._export_attr("contention",
                          lambda: aggregate_lock_stats(self.locks))
        self._export_attr("telemetry", self._telemetry_block)
        self.n_packets = n_lanes * packets_per_lane
        self._deques = [
            collections.deque(range(i * packets_per_lane,
                                    (i + 1) * packets_per_lane))
            for i in range(n_lanes)
        ]
        self.locks = [TryLock(name=f"pool/lane{i}") for i in range(n_lanes)]
        # per-lane RNGs: victim selection happens under the lane lock, so
        # a per-lane generator is race-free without further locking
        self._rngs = [np.random.default_rng(seed + i) for i in range(n_lanes)]
        # pre-registered fixed-size buffers (the paper registers them with
        # the NIC; here registration == preallocation)
        self.buffer_of = [bytearray(packet_bytes) for _ in range(self.n_packets)]
        self._steals = AtomicCounter()
        self._gets = AtomicCounter()
        self._puts = AtomicCounter()
        self._steal_lock_failures = AtomicCounter()

    # counters stay plain ints to callers (tests compare with ==)
    @property
    def steals(self) -> int:
        return self._steals.load()

    @property
    def gets(self) -> int:
        return self._gets.load()

    @property
    def puts(self) -> int:
        return self._puts.load()

    @property
    def steal_lock_failures(self) -> int:
        """Steal attempts abandoned because the victim's lock was held."""
        return self._steal_lock_failures.load()

    def get(self, lane: int) -> tuple[int, Status]:
        """Pop a packet id; one try-lock-guarded steal attempt on local
        exhaustion, failing to ``retry(RETRY_NOPACKET)`` (never blocking).
        The scalar get IS a burst of one — same locking, same steal."""
        ids, st = self.get_n(lane, 1)
        return (ids[0] if ids else -1), st

    def _steal_half_locked(self, lane: int) -> bool:
        """One nonblocking steal attempt into ``lane`` (whose lock the
        caller holds): try-lock a random victim — never self, that would
        waste the single attempt — and move half its deque, head end to
        head end.  False when the victim was contended or empty."""
        victim = (lane + 1
                  + int(self._rngs[lane].integers(self.n_lanes - 1))) \
            % self.n_lanes
        vlock = self.locks[victim]
        if not vlock.try_acquire():
            # the paper's nonblocking get: a contended victim is a
            # failed attempt, not a wait
            self._steal_lock_failures.fetch_add(1)
            return False
        try:
            vdq = self._deques[victim]
            n_steal = len(vdq) // 2
            if n_steal == 0:
                return False
            self._steals.fetch_add(1)
            dq = self._deques[lane]
            for _ in range(n_steal):
                dq.appendleft(vdq.popleft())     # head end on both sides
        finally:
            vlock.release()
        return True

    def get_n(self, lane: int, n: int) -> tuple[list[int], Status]:
        """Burst ``get`` (paper §4.3: amortize per-message costs): pop up
        to ``n`` packet ids under ONE lane-lock acquisition — one lock
        round-trip grabs a whole doorbell's worth of packets instead of
        ``n`` separate get() calls.

        Returns ``(ids, status)``; ``status`` is ``done`` when all ``n``
        were obtained, else ``retry(RETRY_NOPACKET)`` with however many
        packets *were* available (possibly zero).  A short grab is how a
        mid-burst pool exhaustion splits a doorbell: the caller posts the
        prefix it has packets for and retries the rest.  At most one
        try-lock-guarded steal attempt is made."""
        if n <= 0:
            return [], done()
        tele = self.tele
        if tele.timers_on:
            with tele.span("pool.get"):
                return self._get_n_locked(lane, n)
        return self._get_n_locked(lane, n)

    def _get_n_locked(self, lane: int, n: int) -> tuple[list[int], Status]:
        self._gets.fetch_add(1)
        dq = self._deques[lane]
        out: list[int] = []
        with self.locks[lane]:
            while dq and len(out) < n:
                out.append(dq.pop())             # tail end: cache locality
            if len(out) == n:
                return out, done()
            if self.n_lanes == 1 or not self._steal_half_locked(lane):
                return out, retry(ErrorCode.RETRY_NOPACKET)
            while dq and len(out) < n:
                out.append(dq.pop())
            if len(out) == n:
                return out, done()
            return out, retry(ErrorCode.RETRY_NOPACKET)

    def put(self, lane: int, packet: int) -> Status:
        tele = self.tele
        if tele.timers_on:
            with tele.span("pool.put"):
                return self._put_locked(lane, packet)
        return self._put_locked(lane, packet)

    def _put_locked(self, lane: int, packet: int) -> Status:
        self._puts.fetch_add(1)
        with self.locks[lane]:
            self._deques[lane].append(packet)    # tail end
        return done()

    def put_n(self, lane: int, packets: Sequence[int]) -> Status:
        """Burst ``put``: return a batch of packets under one lane-lock
        acquisition (the progress engine's batched source-completion
        sweep returns a whole drain's packets at once)."""
        if not packets:
            return done()
        tele = self.tele
        if tele.timers_on:
            with tele.span("pool.put"):
                return self._put_n_locked(lane, packets)
        return self._put_n_locked(lane, packets)

    def _put_n_locked(self, lane: int, packets: Sequence[int]) -> Status:
        self._puts.fetch_add(1)
        with self.locks[lane]:
            self._deques[lane].extend(packets)   # tail end, post order
        return done()

    def free_packets(self) -> int:
        return sum(len(d) for d in self._deques)

    def lock_stats(self) -> list[dict]:
        """Per-lane lock telemetry (contention evidence for benchmarks)."""
        return [lk.stats() for lk in self.locks]

    def telemetry_counters(self) -> dict:
        """This pool's legacy counters, for the unified snapshot (the
        owning runtime attaches this under the ``pool.`` prefix)."""
        locks = aggregate_lock_stats(self.locks)
        return {"gets": self.gets, "puts": self.puts,
                "steals": self.steals,
                "steal_lock_failures": self.steal_lock_failures,
                "lock_contentions": locks["contentions"],
                "free_packets": self.free_packets()}

    def _telemetry_block(self) -> dict:
        return {"level": self.tele.level,
                "counters": {f"pool.{k}": v
                             for k, v in self.telemetry_counters().items()}}


# ---------------------------------------------------------------------------
# Functional slot pool (tensor mirror of the reference's jitted pool).
#
# Geometry: ``n_lanes`` lanes x ``lane_cap`` slots holding packet ids.
#   slots (n_lanes, lane_cap) int32  -- packet ids, -1 == empty position
#   count (n_lanes,)          int32  -- live entries per lane (stack top)
#
# Each lane is a *stack* (the deque's tail end); stealing takes the bottom
# half of the victim's stack (the head end), preserving the paper's
# cache-locality split.  Every op returns new tensors (the pool is a
# value, as in the reference); only :func:`pool_get_copy_n` writes its
# packet table in place, where the reference returns an updated copy.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlotPool:
    slots: torch.Tensor
    count: torch.Tensor


def init_pool(n_lanes: int, packets_per_lane: int,
              lane_cap: Optional[int] = None, *,
              device="cuda") -> SlotPool:
    """Seed each lane with its own contiguous packet-id range."""
    cap = lane_cap or n_lanes * packets_per_lane   # worst case: all in one lane
    ids = np.full((n_lanes, cap), -1, np.int32)
    for i in range(n_lanes):
        ids[i, :packets_per_lane] = np.arange(
            i * packets_per_lane, (i + 1) * packets_per_lane, dtype=np.int32)
    count = np.full((n_lanes,), packets_per_lane, np.int32)
    return pool_from_numpy(ids, count, device)


def pool_from_numpy(slots, count, device) -> SlotPool:
    """A pool from the reference's state (its ``slots`` and ``count`` as
    numpy arrays) — both packages can then start from one pool."""
    return SlotPool(
        slots=torch.tensor(np.asarray(slots, np.int32), device=device),
        count=torch.tensor(np.asarray(count, np.int32), device=device))


def pool_to_numpy(pool: SlotPool) -> tuple[np.ndarray, np.ndarray]:
    """``(slots, count)`` as numpy arrays (a host copy, for tests)."""
    return pool.slots.cpu().numpy(), pool.count.cpu().numpy()


def _i32(x, device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device``.  A host int is written by a fill
    kernel: ``as_tensor`` would copy it from pageable host memory, which
    blocks the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), x, dtype=torch.int32, device=device)


def _roll(row: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``jnp.roll`` by a tensor shift, as a gather (``torch.roll`` takes
    only a host int, which would sync)."""
    cap = row.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=row.device)
    return row[torch.remainder(idx - shift, cap).long()]


def _steal_half(slots: torch.Tensor, count: torch.Tensor, lane: torch.Tensor,
                steal_seed, clamp: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One steal attempt into ``lane``: move the head half of a victim's
    stack to our head.  Victim selection matches the host pool:
    ``(lane + 1 + (seed % max(n_lanes-1, 1))) % n_lanes`` — never lane
    itself.  ``torch.remainder`` (not ``fmod``) takes the divisor's sign,
    so a negative seed still gives a non-negative offset.  ``clamp``
    bounds the transfer by our lane's free room (the burst get steals
    while still holding packets)."""
    n_lanes, cap = slots.shape
    dev = slots.device
    offset = torch.remainder(_i32(steal_seed, dev), max(n_lanes - 1, 1))
    victim = (lane + 1 + offset) % n_lanes
    vcnt = count[victim.long()]
    n_steal = vcnt // 2
    if clamp:
        n_steal = torch.minimum(n_steal, cap - count[lane.long()])
    ok = (n_steal > 0) & (victim != lane)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    vrow = slots[victim.long()]
    stolen = torch.where(idx < n_steal, vrow, -1)
    remaining = torch.where((idx >= n_steal) & (idx < vcnt), vrow, -1)
    new_victim = torch.where(ok, _roll(remaining, -n_steal), vrow)
    my = slots[lane.long()]
    new_mine = torch.where(ok, torch.where(idx < n_steal, stolen,
                                           _roll(my, n_steal)), my)
    slots = slots.clone()
    slots[victim.long()] = new_victim
    slots[lane.long()] = new_mine          # lane last, as .at[].set order
    count = count.clone()
    count[victim.long()] -= torch.where(ok, n_steal, 0)
    count[lane.long()] += torch.where(ok, n_steal, 0)
    return slots, count


def _local_pop(slots: torch.Tensor, count: torch.Tensor, lane: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pop the stack top of ``lane`` (callers select the result away when
    the lane is empty, so the index is clamped rather than wrapped)."""
    top = torch.clamp(count[lane.long()] - 1, min=0)
    pid = slots[lane.long(), top.long()]
    slots = slots.clone()
    slots[lane.long(), top.long()] = -1
    count = count.clone()
    count[lane.long()] -= 1
    return slots, count, pid


def pool_get(pool: SlotPool, lane, steal_seed
             ) -> tuple[SlotPool, torch.Tensor, torch.Tensor]:
    """Functional ``get``: returns (pool', packet_id, status).

    packet_id == -1 and status == IN_GRAPH_RETRY(1) when both the local pop
    and the single steal attempt fail, mirroring the host pool.
    """
    dev = pool.slots.device
    lane = _i32(lane, dev)
    cnt = pool.count[lane.long()]
    s2, c2 = _steal_half(pool.slots, pool.count, lane, steal_seed,
                         clamp=False)
    has = cnt > 0
    # a failed steal leaves (s2, c2) equal to the input pool
    base_s = torch.where(has, pool.slots, s2)
    base_c = torch.where(has, pool.count, c2)
    can_pop = has | (c2[lane.long()] > 0)
    ps, pc, pid = _local_pop(base_s, base_c, lane)
    return (SlotPool(torch.where(can_pop, ps, base_s),
                     torch.where(can_pop, pc, base_c)),
            torch.where(can_pop, pid, -1),
            torch.where(can_pop, 0, 1).to(torch.int32))


def pool_get_n(pool: SlotPool, lane, n: int, steal_seed
               ) -> tuple[SlotPool, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Functional burst ``get``: returns (pool', ids, got, status).

    ``n`` is a host int (it shapes the output): ``ids`` is ``(n,)`` int32
    in pop order (stack top first), padded with ``-1``; ``got`` is the
    number of valid ids; ``status`` is 0 when the full burst was
    satisfied, else ``IN_GRAPH_RETRY`` (a short grab — the
    doorbell-splitting case).  Mirrors :meth:`HostPacketPool.get_n`: at
    most one steal attempt, and only when the local lane cannot satisfy
    the burst alone.
    """
    n_lanes, cap = pool.slots.shape
    dev = pool.slots.device
    lane = _i32(lane, dev)
    li = lane.long()
    s2, c2 = _steal_half(pool.slots, pool.count, lane, steal_seed,
                         clamp=True)
    enough = pool.count[li] >= n
    slots = torch.where(enough, pool.slots, s2)
    count = torch.where(enough, pool.count, c2)
    cnt = count[li]
    got = torch.clamp(cnt, max=n)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    src = cnt - 1 - idx                        # stack top downward
    ids = torch.where(idx < got,
                      slots[li][torch.clamp(src, min=0).long()], -1)
    row = torch.where(torch.arange(cap, dtype=torch.int32, device=dev)
                      >= cnt - got, -1, slots[li])
    slots = slots.clone()
    slots[li] = row
    count = count.clone()
    count[li] -= got
    status = torch.where(got == n, 0, 1).to(torch.int32)
    return SlotPool(slots, count), ids, got, status


def init_buffers(n_packets: int, packet_bytes: int, *,
                 device="cuda") -> torch.Tensor:
    """Backing byte table for the functional pool — the tensor mirror
    of :attr:`HostPacketPool.buffer_of` (one fixed-size pre-registered
    buffer per packet id)."""
    return torch.zeros((n_packets, packet_bytes), dtype=torch.uint8,
                       device=device)


def pool_get_copy_n(pool: SlotPool, buf: torch.Tensor, lane, payload,
                    steal_seed) -> tuple[SlotPool, torch.Tensor,
                                         torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fused allocate-and-stage (DESIGN.md §13), plain tensor version:
    pop a burst of packet slots AND scatter the burst's payload bytes
    into the pool's backing buffers.

    ``payload`` is ``(n, row_bytes)`` uint8 (one packed wire image, e.g.
    from the doorbell stage-copy kernel); row ``i`` lands in
    ``buf[ids[i]]`` (zero-padded to the packet width).  On a short grab
    only the first ``got`` rows are written — the unallocated tail
    touches nothing, mirroring the host pool's prefix-accept split.
    ``buf`` is written in place and returned.  Returns ``(pool', buf,
    ids, got, status)`` with the same id/status contract as
    :func:`pool_get_n`.  The doorbell kernel's wrapper
    (:func:`repro_torch.kernels.doorbell.stage_copy_push`) is the fused
    one-launch form for a pool on the card.
    """
    n, row_bytes = payload.shape
    n_packets, packet_bytes = buf.shape
    if row_bytes > packet_bytes:
        raise ValueError(f"pool_get_copy_n: payload rows of {row_bytes} "
                         f"bytes exceed packet_bytes={packet_bytes}")
    pool, ids, got, status = pool_get_n(pool, lane, n, steal_seed)
    rows = payload.to(torch.uint8)
    if row_bytes < packet_bytes:
        rows = torch.nn.functional.pad(rows, (0, packet_bytes - row_bytes))
    # unallocated rows (id == -1) and ids past the table are dropped, as
    # the reference's mode="drop" scatter drops them; the mask reads the
    # ids on the host, which is fine for this plain version
    keep = (ids >= 0) & (ids < n_packets)
    buf[ids[keep].long()] = rows[keep]
    return pool, buf, ids, got, status


def pool_put(pool: SlotPool, lane, packet_id
             ) -> tuple[SlotPool, torch.Tensor]:
    """Functional ``put``: push to stack top. Returns (pool', status)."""
    dev = pool.slots.device
    lane = _i32(lane, dev)
    li = lane.long()
    cnt = pool.count[li]
    cap = pool.slots.shape[1]
    ok = cnt < cap
    pos = torch.clamp(cnt, max=cap - 1).long()
    slots = pool.slots.clone()
    slots[li, pos] = torch.where(ok, _i32(packet_id, dev), slots[li, pos])
    count = pool.count.clone()
    count[li] += torch.where(ok, 1, 0).to(torch.int32)
    return SlotPool(slots, count), torch.where(ok, 0, 1).to(torch.int32)


def free_count(pool: SlotPool) -> torch.Tensor:
    return pool.count.sum()
