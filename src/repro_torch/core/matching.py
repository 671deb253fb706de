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
2. The reference's functional engine (``init_table`` /
   ``insert_batch`` / ``probe_batch``), a fixed-capacity hash table for
   jitted programs, has no tensor mirror yet (see ROADMAP.md).

The paper's relaxed semantics (out-of-order delivery, restricted wildcard)
are what make the hash-table design legal; we adopt the same semantics and
the same default bucket count (65536).
"""
from __future__ import annotations

import collections
import enum
from typing import Any, Callable, Hashable, Optional, Sequence


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
