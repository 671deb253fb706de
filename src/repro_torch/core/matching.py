"""Matching engine (paper §4.1.3) — hash-bucket send/recv matching.

The engine exposes two methods, exactly as in the paper:

* ``make_key(rank, tag, policy)`` — build the match key.  ``matching_policy``
  (§3.3.2) selects which fields participate: ``rank_tag`` (default),
  ``rank_only``, ``tag_only``, or a user ``make_key`` function.
* ``insert(key, kind, value)`` — insert a send or receive; returns the
  matched value of the complementary kind if present, else stores the entry.

Two implementations in the reference:

1. :class:`HostMatchingEngine` — a Python dict-of-deques used at trace
   time (matching program-builder sends with recvs before emitting ppermute),
   by the serving router, and — since the concurrency subsystem landed —
   by concurrent progress workers.  The paper's per-bucket spinlock is
   real here: insertions take a fine-grained bucket lock (keys hash onto a
   fixed stripe of :class:`~repro_torch.core.concurrency.TryLock`\\ s, so two
   inserts on different buckets never contend) and the whole
   check-complement/append step is atomic per bucket, which is what makes
   insert linearizable.
2. The functional engine (:func:`init_table` / :func:`insert_batch` /
   :func:`probe_batch`), the tensor mirror of the reference's
   fixed-capacity hash table for jitted programs: plain functions on
   tensors that run on whatever device their inputs are on, returning a
   new table rather than mutating the old one.

The paper's relaxed semantics (out-of-order delivery, restricted wildcard)
are what make the hash-table design legal; we adopt the same semantics and
the same default bucket count (65536).
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Callable, Hashable, Optional, Sequence

import numpy as np
import torch

from . import attrs as _attrs
from .concurrency.atomics import AtomicCounter
from .concurrency.locks import TryLock, aggregate_lock_stats
from .telemetry import NULL_TELEMETRY


class MatchKind(enum.IntEnum):
    SEND = 1
    RECV = 2

    @property
    def complement(self) -> "MatchKind":
        return MatchKind.RECV if self is MatchKind.SEND else MatchKind.SEND


class MatchingPolicy(enum.Enum):
    RANK_TAG = "rank_tag"    # default: match on (engine, source rank, tag)
    RANK_ONLY = "rank_only"  # wildcard tag
    TAG_ONLY = "tag_only"    # wildcard rank


def make_key(rank: int, tag: int,
             policy: MatchingPolicy = MatchingPolicy.RANK_TAG,
             custom: Optional[Callable[[int, int], Hashable]] = None
             ) -> Hashable:
    """Build the insertion key (paper: 'the matching_policy will instruct the
    matching engine on how to make the insertion key based on rank and tag';
    users can also supply their own make_key)."""
    if custom is not None:
        return custom(rank, tag)
    if policy == MatchingPolicy.RANK_TAG:
        return (rank, tag)
    if policy == MatchingPolicy.RANK_ONLY:
        return (rank, None)
    return (None, tag)


class HostMatchingEngine(_attrs.AttrResource):
    """Host-side matching engine, insert-linearizable.

    Buckets are materialized lazily (a Python dict is already a hash table);
    each bucket holds FIFO queues per kind, mirroring the paper's
    list-of-queues buckets.  ``insert`` returns the matched value or None.

    Lock granularity (DESIGN.md §10): keys hash onto ``n_locks`` bucket
    stripes; an insert spin-acquires its stripe's :class:`TryLock` (insert
    cannot fail, so the blocking fallback applies) and performs the
    check-complement / pop-or-append step atomically.  Two inserts whose
    keys land on different stripes proceed in parallel; two on the same
    key serialize, which is exactly the linearizability a send/recv match
    needs — one of them matches the other, never both or neither.
    """

    def __init__(self, n_buckets: int = 65536, n_locks: int = 64,
                 resolved=None, tele=None):
        self.n_buckets = n_buckets
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._buckets: dict[Hashable, dict[MatchKind, collections.deque]] = {}
        self.locks = [TryLock(name=f"match/bucket{i}")
                      for i in range(n_locks)]
        self._inserts = AtomicCounter()
        self._matches = AtomicCounter()
        self._fast_matches = AtomicCounter()
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"matching_buckets": n_buckets, "matching_locks": n_locks}))
        self._export_attr("inserts", lambda: self.inserts)
        self._export_attr("matches", lambda: self.matches)
        self._export_attr("fast_matches", lambda: self.fast_matches)
        self._export_attr("contention",
                          lambda: aggregate_lock_stats(self.locks))
        self._export_attr("telemetry", self._telemetry_block)

    @property
    def inserts(self) -> int:
        return self._inserts.load()

    @property
    def matches(self) -> int:
        return self._matches.load()

    @property
    def fast_matches(self) -> int:
        """Matches taken through the lock-free :meth:`match_now` probe."""
        return self._fast_matches.load()

    def _lock_of(self, key: Hashable) -> TryLock:
        return self.locks[hash(key) % len(self.locks)]

    def match_now(self, key: Hashable, kind: MatchKind):
        """Probe-before-lock fast path (the eager delivery hot case): pop
        a complementary entry *if one is already posted* — without ever
        taking the bucket lock — and NEVER store.

        The probe is a plain dict read; the pop is a single
        ``deque.popleft`` (GIL-atomic), so two concurrent fast-path
        deliveries can never double-match one recv, and a concurrent
        locked ``insert`` can never be dropped: ``insert`` re-checks the
        complement under the lock with the same atomic pop.  Returns the
        matched value, or ``None`` when no complement is posted — in
        which case the caller falls back to the locked :meth:`insert`
        (which stores into the unexpected queue)."""
        tele = self.tele
        if tele.timers_on:
            with tele.span("match.now"):
                return self._match_now_probe(key, kind)
        return self._match_now_probe(key, kind)

    def _match_now_probe(self, key: Hashable, kind: MatchKind):
        bucket = self._buckets.get(key)
        if bucket is None:
            return None
        try:
            value = bucket[kind.complement].popleft()
        except IndexError:
            return None
        self._matches.fetch_add(1)
        self._fast_matches.fetch_add(1)
        return value

    def match_now_n(self, key: Hashable, kind: MatchKind, n: int) -> list:
        """Burst probe for ONE key (a fused doorbell of uniform match
        keys): pop up to ``n`` pre-posted complements with a single
        bucket lookup and NEVER store.  Each pop is the same GIL-atomic
        ``popleft`` as :meth:`match_now`, so racing fast-path deliveries
        still never double-match one entry.  Returns the matched values
        in FIFO order (possibly fewer than ``n``, possibly empty) — the
        caller falls back to the locked :meth:`insert` per missing row."""
        bucket = self._buckets.get(key)
        if bucket is None:
            return []
        dq = bucket[kind.complement]
        out: list = []
        try:
            for _ in range(n):
                out.append(dq.popleft())
        except IndexError:
            pass
        if out:
            self._matches.fetch_add(len(out))
            self._fast_matches.fetch_add(len(out))
        return out

    def match_now_burst(self, keys: Sequence[Hashable], kind: MatchKind
                        ) -> list:
        """Vectorized probe for a whole burst's match keys (paper §4.3 at
        the matching engine): one pass groups the keys, then each unique
        key pays a single bucket lookup (:meth:`match_now_n`) for all its
        rows — duplicate keys in one doorbell cost one probe instead of
        K.  Returns values aligned with ``keys``; ``None`` rows had no
        pre-posted complement and fall back to the per-bucket locked
        path."""
        out: list = [None] * len(keys)
        if not self._buckets:
            return out
        groups: dict = {}
        for i, k in enumerate(keys):
            g = groups.get(k)
            if g is None:
                groups[k] = [i]
            else:
                g.append(i)
        for k, idxs in groups.items():
            for i, v in zip(idxs, self.match_now_n(k, kind, len(idxs))):
                out[i] = v
        return out

    def insert(self, key: Hashable, kind: MatchKind, value: Any):
        tele = self.tele
        if tele.timers_on:
            with tele.span("match.insert"):
                return self._insert_locked(key, kind, value)
        return self._insert_locked(key, kind, value)

    def _insert_locked(self, key: Hashable, kind: MatchKind, value: Any):
        self._inserts.fetch_add(1)
        with self._lock_of(key):
            bucket = self._buckets.setdefault(
                key, {MatchKind.SEND: collections.deque(),
                      MatchKind.RECV: collections.deque()})
            # pop-with-except rather than check-then-pop: a lock-free
            # match_now() racing this insert may drain the last
            # complement between a truthiness check and the popleft
            try:
                matched = bucket[kind.complement].popleft()
            except IndexError:
                bucket[kind].append(value)
                return None
            self._matches.fetch_add(1)
            return matched

    def remove(self, key: Hashable, kind: MatchKind, value: Any) -> bool:
        """Withdraw a previously inserted entry (identity match) — the
        recv-deadline expiry path (DESIGN.md §16).  Returns True when the
        entry was still queued and is now gone; False means it already
        matched (or was never inserted), so the caller must NOT fail the
        op — its completion is coming through the normal path."""
        with self._lock_of(key):
            bucket = self._buckets.get(key)
            if bucket is None:
                return False
            dq = bucket[kind]
            for v in dq:
                if v is value:
                    dq.remove(v)
                    return True
            return False

    def extract_recvs_for_rank(self, rank: int) -> list:
        """Withdraw every queued RECV whose key names ``rank`` — the
        dead-peer sweep (DESIGN.md §16).  Wildcard-rank keys stay: a
        TAG_ONLY recv can still match a living sender.  Returns the
        extracted values."""
        out: list = []
        for key in list(self._buckets.keys()):
            if not (isinstance(key, tuple) and key and key[0] == rank):
                continue
            with self._lock_of(key):
                bucket = self._buckets.get(key)
                if bucket is None:
                    continue
                dq = bucket[MatchKind.RECV]
                while dq:
                    try:
                        out.append(dq.popleft())
                    except IndexError:
                        break
        return out

    def pending(self) -> int:
        # snapshot the bucket list in one C-level call (GIL-atomic) so a
        # concurrent insert growing the dict cannot break the iteration
        return sum(len(q) for b in list(self._buckets.values())
                   for q in b.values())

    def lock_stats(self) -> list[dict]:
        """Per-bucket-stripe lock telemetry."""
        return [lk.stats() for lk in self.locks]

    def telemetry_counters(self) -> dict:
        """This engine's legacy counters for the unified snapshot (the
        owning runtime attaches this under the ``matching.`` prefix)."""
        locks = aggregate_lock_stats(self.locks)
        return {"inserts": self.inserts, "matches": self.matches,
                "fast_matches": self.fast_matches,
                "lock_contentions": locks["contentions"]}

    def _telemetry_block(self) -> dict:
        return {"level": self.tele.level,
                "counters": {f"matching.{k}": v
                             for k, v in self.telemetry_counters().items()}}


# ---------------------------------------------------------------------------
# Functional engine (the mirror of the reference's in-graph one).
#
# Fixed geometry: ``n_buckets`` x ``bucket_cap`` slots. State tensors:
#   keys  (n_buckets, bucket_cap) int32   -- 0 == empty
#   kinds (n_buckets, bucket_cap) int32   -- MatchKind or 0
#   vals  (n_buckets, bucket_cap) int32   -- payload index (e.g. packet slot)
#
# Every op is tensor arithmetic: both sides of the reference's
# ``lax.cond`` are computed and selected with ``torch.where``, and cells
# are read and written with ``index_select`` / ``index_copy`` at a
# computed flat index, so a table on the card never syncs with the host.
# The batch forms resolve their keys one after another in a host loop of
# fixed length, as the reference's ``lax.scan`` does: duplicate keys in
# one burst each pop (or store) a distinct entry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchTable:
    keys: torch.Tensor
    kinds: torch.Tensor
    vals: torch.Tensor


def init_table(n_buckets: int, bucket_cap: int, *,
               device="cuda") -> MatchTable:
    shape = (n_buckets, bucket_cap)
    return MatchTable(
        keys=torch.zeros(shape, dtype=torch.int32, device=device),
        kinds=torch.zeros(shape, dtype=torch.int32, device=device),
        vals=torch.full(shape, -1, dtype=torch.int32, device=device))


def _i32(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, a host int or array) as an int32 tensor; a tensor
    keeps its device unless ``device`` is given, host data goes to
    ``device`` (the CPU when ``None``).  A host int is written by a fill
    kernel: ``as_tensor`` would copy it from pageable host memory, which
    blocks the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int32)
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x), dtype=torch.int32, device=device)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


#: Knuth's multiplier 2654435761 split into 16-bit halves: the uint32
#: product is formed from two products that fit in int64
_HASH_HI, _HASH_LO = 2654435761 >> 16, 2654435761 & 0xFFFF


def _hash_key(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Cheap integer hash (Knuth multiplicative) -> bucket index: the
    reference's uint32 arithmetic in int64 (the key's bits as uint32,
    the product kept to its low 32 bits before the shift)."""
    k = key.to(torch.int64) & 0xFFFFFFFF
    h = (k * _HASH_LO + ((k * _HASH_HI) & 0xFFFF) * 65536) & 0xFFFFFFFF
    return ((h >> 16) % n_buckets).to(torch.int32)


def encode_key(rank, tag, policy: MatchingPolicy = MatchingPolicy.RANK_TAG):
    """Pack (rank, tag) into one nonzero int32 key under the policy.

    Layout: bit 30 = nonzero marker, bits 16..29 = rank (14 bits),
    bits 0..15 = tag.  (Bit 31 would overflow int32.)  The key lies on
    the device of a tensor argument, else on the CPU."""
    dev = next((x.device for x in (rank, tag)
                if isinstance(x, torch.Tensor)), None)
    rank = _i32(rank, dev)
    tag = _i32(tag, dev)
    if policy == MatchingPolicy.RANK_ONLY:
        tag = torch.zeros_like(tag)
    elif policy == MatchingPolicy.TAG_ONLY:
        rank = torch.zeros_like(rank)
    return ((rank & 0x3FFF) << 16) | (tag & 0xFFFF) | (1 << 30)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool row: the first True index, 0 if none."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    return torch.where(mask, idx, mask.shape[0]).min() % mask.shape[0]


def _cell(arr: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return arr.reshape(-1).index_select(0, flat)[0]


def _with_cell(arr: torch.Tensor, flat: torch.Tensor, v) -> torch.Tensor:
    """A copy of ``arr`` with the cell at ``flat`` set to ``v``."""
    return arr.reshape(-1).index_copy(
        0, flat, v.reshape(1).to(arr.dtype)).reshape(arr.shape)


def _bucket(table: MatchTable, key: torch.Tensor):
    """The key's bucket (a (1,) index) and its key and kind rows."""
    b = _hash_key(key, table.keys.shape[0]).long().reshape(1)
    return b, table.keys.index_select(0, b)[0], \
        table.kinds.index_select(0, b)[0]


def _insert(table: MatchTable, key, kind: torch.Tensor, comp, val):
    """One insert of ``kind`` against its complement ``comp`` (int32
    tensors): pop a complementary entry, else store in the first empty
    slot, else leave the table as it was."""
    dev = table.keys.device
    key, val = _i32(key, dev), _i32(val, dev)
    cap = table.keys.shape[1]
    b, row_keys, row_kinds = _bucket(table, key)
    is_match = (row_keys == key) & (row_kinds == comp)
    any_match = is_match.any()
    match_slot = _first(is_match)
    matched_val = torch.where(any_match,
                              _cell(table.vals, b * cap + match_slot), -1)
    is_empty = row_kinds == 0
    any_empty = is_empty.any()
    # on match: clear the matched slot; on store: fill the empty slot
    slot = torch.where(any_match, match_slot, _first(is_empty))
    flat = b * cap + slot
    can_write = any_match | any_empty

    def write(arr, v):
        return _with_cell(arr, flat,
                          torch.where(can_write, v, _cell(arr, flat)))

    table = MatchTable(write(table.keys, torch.where(any_match, 0, key)),
                       write(table.kinds, torch.where(any_match, 0, kind)),
                       write(table.vals, torch.where(any_match, -1, val)))
    status = torch.where(any_match, 1, torch.where(any_empty, 0, 2))
    return table, matched_val.to(torch.int32), status.to(torch.int32)


def insert(table: MatchTable, key, kind: int, val):
    """Insert one entry; returns (table', matched_val, status).

    matched_val == -1 when no complementary entry existed (entry stored,
    status=posted->0 stored / 1 matched); status==2 => bucket full (retry).
    """
    dev = table.keys.device
    comp = MatchKind(kind).complement
    return _insert(table, key, _i32(int(kind), dev), _i32(int(comp), dev),
                   val)


def _stack(parts, dtype, device) -> torch.Tensor:
    return (torch.stack(parts) if parts
            else torch.zeros(0, dtype=dtype, device=device))


def insert_batch(table: MatchTable, keys, kinds, vals):
    """Sequential batch insert (keeps matching semantics exact): key
    ``i`` is resolved against the table keys ``0..i-1`` left."""
    dev = table.keys.device
    keys, kinds, vals = _i32(keys, dev), _i32(kinds, dev), _i32(vals, dev)
    send, recv = int(MatchKind.SEND), int(MatchKind.RECV)
    matched, status = [], []
    for i in range(keys.shape[0]):
        comp = torch.where(kinds[i] == send, recv, send)
        table, m, s = _insert(table, keys[i], kinds[i], comp, vals[i])
        matched.append(m)
        status.append(s)
    return (table, _stack(matched, torch.int32, dev),
            _stack(status, torch.int32, dev))


def _probe(table: MatchTable, key: torch.Tensor, comp: int, gate=None):
    """Pop a complementary entry if one is stored (and ``gate`` holds);
    never store."""
    cap = table.keys.shape[1]
    b, row_keys, row_kinds = _bucket(table, key)
    is_match = (row_keys == key) & (row_kinds == comp)
    any_match = is_match.any() if gate is None else is_match.any() & gate
    flat = b * cap + _first(is_match)
    matched_val = torch.where(any_match, _cell(table.vals, flat), -1)

    def clear(arr, empty):
        return _with_cell(arr, flat,
                          torch.where(any_match, empty, _cell(arr, flat)))

    table = MatchTable(clear(table.keys, 0), clear(table.kinds, 0),
                       clear(table.vals, -1))
    return table, matched_val.to(torch.int32), any_match


def probe(table: MatchTable, key, kind: int):
    """Functional ``match_now``: pop a complementary entry if one is
    already stored — NEVER store.  Returns ``(table', matched_val,
    hit)``; ``matched_val == -1`` and ``hit == False`` when no
    complement is present (the caller falls back to :func:`insert`)."""
    return _probe(table, _i32(key, table.keys.device),
                  int(MatchKind(kind).complement))


def probe_batch(table: MatchTable, keys, kind: int):
    """Vectorized burst probe — the fused doorbell's one hashed-array
    pass: every key is hashed and its bucket row compared in a single
    vectorized gather, producing a per-key candidate mask; the actual
    pops then resolve one after another, because duplicate keys in one
    burst must each pop a *distinct* pre-posted entry — the same
    exactness argument as :func:`insert_batch`.  Returns ``(table',
    matched_vals, hits)`` aligned with ``keys``."""
    dev = table.keys.device
    keys = _i32(keys, dev)
    comp = int(MatchKind(kind).complement)
    # the one hashed-array pass: (k,) bucket indices, (k, cap) gathered
    # rows, one vectorized candidate mask over the whole burst
    b = _hash_key(keys, table.keys.shape[0]).long()
    candidates = ((table.keys.index_select(0, b) == keys[:, None])
                  & (table.kinds.index_select(0, b) == comp)).any(dim=1)
    vals, hits = [], []
    for i in range(keys.shape[0]):
        table, v, ok = _probe(table, keys[i], comp, candidates[i])
        vals.append(v)
        hits.append(ok)
    return (table, _stack(vals, torch.int32, dev),
            _stack(hits, torch.bool, dev))


def pending_count(table: MatchTable) -> torch.Tensor:
    return (table.kinds != 0).sum().to(torch.int32)
