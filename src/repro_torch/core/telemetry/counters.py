"""Typed metric registry (DESIGN.md §15) — counters, gauges, histograms.

The registry is the unification point for the runtime's formerly
scattered telemetry (``Device.count_post``, ``rt.stats``, per-lock
contention counters, LCQ ``pop_yields``): hot paths increment
*per-thread shards* (a plain dict lookup, never a shared atomic or a
lock), and :meth:`MetricRegistry.snapshot` merges every shard on read.
A shard belongs to the thread that created it forever — dead threads'
shards stay in the merge, so no count is ever lost.

Histograms use fixed log2 buckets (bucket ``i`` holds values in
``[2^(i-1), 2^i)``), the classic HdrHistogram-lite shape: stage timers
record nanosecond durations and percentile *estimates* (p50/p99 as the
upper bound of the bucket where the cumulative count crosses the rank)
come out of 64 integers per stage — mergeable across threads, ranks and
processes by elementwise addition, which is exactly what the SPMD
fragment merge does.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

#: log2 histogram buckets; bucket i counts values with bit_length() == i
#: (value 0 lands in bucket 0).  2^63 ns ≈ 292 years — nothing overflows.
N_BUCKETS = 64


class Histogram:
    """One log2 histogram: count, sum, and 64 bucket counters."""

    __slots__ = ("count", "sum", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0
        self.buckets: List[int] = [0] * N_BUCKETS

    def record(self, value: int) -> None:
        self.count += 1
        self.sum += value
        idx = value.bit_length() if value > 0 else 0
        self.buckets[idx if idx < N_BUCKETS else N_BUCKETS - 1] += 1

    def as_dict(self) -> Dict:
        """Sparse JSON form: only populated buckets travel."""
        return {"count": self.count, "sum": self.sum,
                "buckets": {str(i): n for i, n in enumerate(self.buckets)
                            if n}}


def quantile_bound(buckets: Dict[str, int], q: float) -> float:
    """Upper bound (in recorded units) of the bucket where the cumulative
    count crosses quantile ``q`` — the histogram percentile estimate."""
    total = sum(buckets.values())
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0
    for i in sorted(buckets, key=int):
        seen += buckets[i]
        if seen >= rank:
            return float(2 ** int(i))
    return float(2 ** N_BUCKETS)


class _Shard:
    """One thread's private metric storage (uncontended by design)."""

    __slots__ = ("counters", "hists", "device")

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.hists: Dict[str, Histogram] = {}
        self.device: Dict[str, object] = {}      # name -> running tensor


class MetricRegistry:
    """Per-thread-sharded counters + histograms, merged on read.

    Writers call :meth:`add` / :meth:`observe` / :meth:`add_device`
    (shard-local, no shared state touched); readers call
    :meth:`snapshot` (locks only the shard *list*, then reads each shard
    racily — a torn read costs at most the in-flight increment, never a
    lost one).  Gauges are read-side callables sampled at snapshot time.
    """

    def __init__(self):
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._shards: List[_Shard] = []
        self._gauges: Dict[str, object] = {}

    def _shard(self) -> _Shard:
        shard = getattr(self._tls, "shard", None)
        if shard is None:
            shard = _Shard()
            with self._lock:
                self._shards.append(shard)
            self._tls.shard = shard
        return shard

    # -- write side (hot path) ----------------------------------------------
    def add(self, name: str, n: int = 1) -> None:
        c = self._shard().counters
        c[name] = c.get(name, 0) + n

    def observe(self, name: str, value: int) -> None:
        hists = self._shard().hists
        h = hists.get(name)
        if h is None:
            h = hists[name] = Histogram()
        h.record(value)

    def add_device(self, name: str, value) -> None:
        """Add a tensor into the running sum ``name`` where the tensor
        lives: one device add, no host read (the sum is read by
        :meth:`snapshot`)."""
        dev = self._shard().device
        acc = dev.get(name)
        value = value.detach()
        dev[name] = value if acc is None else acc + value

    # -- read side -----------------------------------------------------------
    def register_gauge(self, name: str, fn) -> None:
        self._gauges[name] = fn

    def snapshot(self) -> Dict:
        """Merge every shard: ``{"counters": {...}, "hists": {...}}``."""
        with self._lock:
            shards = list(self._shards)
        counters: Dict[str, int] = {}
        hists: Dict[str, Dict] = {}
        for shard in shards:
            for name, n in list(shard.counters.items()):
                counters[name] = counters.get(name, 0) + n
            for name, acc in list(shard.device.items()):
                counters[name] = counters.get(name, 0) + acc.item()
            for name, h in list(shard.hists.items()):
                merged = hists.get(name)
                if merged is None:
                    hists[name] = h.as_dict()
                else:
                    hists[name] = merge_hists(merged, h.as_dict())
        for name, fn in self._gauges.items():
            counters[name] = fn()
        return {"counters": counters, "hists": hists}


def merge_hists(a: Dict, b: Dict) -> Dict:
    """Elementwise histogram merge (threads, ranks, processes alike)."""
    buckets = dict(a.get("buckets", {}))
    for i, n in b.get("buckets", {}).items():
        buckets[i] = buckets.get(i, 0) + n
    return {"count": a.get("count", 0) + b.get("count", 0),
            "sum": a.get("sum", 0) + b.get("sum", 0),
            "buckets": buckets}


def merge_counters(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for name, v in b.items():
        if isinstance(v, (int, float)) and isinstance(out.get(name), (int, float)):
            out[name] = out[name] + v
        else:
            out.setdefault(name, v)
    return out


def merge_snapshots(snaps: Iterable[Dict]) -> Dict:
    """Merge raw telemetry snapshots (one per rank/process): counters and
    span histograms add elementwise; the effective level is the deepest."""
    from . import LEVELS      # local import: avoid a cycle at module load
    out: Dict = {"level": "off", "counters": {}, "spans": {}}
    for snap in snaps:
        if not snap:
            continue
        if LEVELS.index(snap.get("level", "off")) > LEVELS.index(out["level"]):
            out["level"] = snap["level"]
        out["counters"] = merge_counters(out["counters"],
                                         snap.get("counters", {}))
        for stage, h in snap.get("spans", {}).items():
            prev = out["spans"].get(stage)
            out["spans"][stage] = merge_hists(prev, h) if prev else dict(h)
    return out


def record_burst_mix(stats, protos, sizes, n: int,
                     registry: Optional[MetricRegistry] = None) -> None:
    """The ONE per-protocol byte-accounting helper (satellite of the
    telemetry PR): record the accepted prefix ``[0, n)`` of a burst onto
    a :class:`~repro_torch.core.protocol.ProtocolStats` — one ``record_many``
    bump per protocol class, identical arithmetic for the fused, scalar-
    burst and (via n=1) scalar paths, so the accounting can never drift
    between them.

    ``protos`` is a sequence of :class:`Protocol` (may be longer than
    ``n``); ``sizes`` is an int (uniform burst) or a per-row sequence.
    When ``registry`` is given the same totals are mirrored into the
    metric registry under ``proto.<name>.msgs`` / ``.bytes``.
    """
    if n <= 0:
        return
    first = protos[0]
    uniform = True
    for i in range(1, n):
        if protos[i] is not first:
            uniform = False
            break
    if uniform:
        total = sizes * n if isinstance(sizes, int) else sum(sizes[:n])
        stats.record_many(first, n, total)
        if registry is not None:
            registry.add(f"proto.{first.value}.msgs", n)
            registry.add(f"proto.{first.value}.bytes", total)
        return
    per: Dict = {}
    for i in range(n):
        proto = protos[i]
        size = sizes if isinstance(sizes, int) else sizes[i]
        msgs, nbytes = per.get(proto, (0, 0))
        per[proto] = (msgs + 1, nbytes + size)
    for proto, (msgs, nbytes) in per.items():
        stats.record_many(proto, msgs, nbytes)
        if registry is not None:
            registry.add(f"proto.{proto.value}.msgs", msgs)
            registry.add(f"proto.{proto.value}.bytes", nbytes)
