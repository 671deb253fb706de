"""K-mer counting mini-app (paper §5.3) — the HipMer stage on LCI-X.

Faithful structure: each rank reads its share of the error-prone reads;
every k-mer is statically mapped to an owner rank by hash; k-mers travel
as **active messages with per-destination aggregation buffers** (paper:
8 KB); all ranks serve incoming RPCs and periodically progress the
runtime (the *all-worker* setup).  Two traversals: (1) insert into a
two-layer Bloom filter, (2) exact counts into a hashmap for k-mers seen
at least twice (the Bloom layers drop the single-occurrence — likely
erroneous — k-mers without hashmap space).

``run_kmer_count`` executes on a :class:`LocalCluster` (ranks = the
paper's processes/threads in one address space) and returns the exact
histogram, which tests compare against a direct oracle count.

The mirror of :mod:`repro.apps.kmer` on the port's runtime.  The cluster
is bound to ``device`` (the card unless the caller asks for the CPU),
but the k-mers travel as host bytes, as the reference's do: no kernel is
on this path, and nothing here touches the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..core import LocalCluster, post_am_x

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def generate_reads(n_reads: int, read_len: int, *, seed: int = 0,
                   error_rate: float = 0.01, genome_len: int = 4096
                   ) -> List[bytes]:
    """Error-prone reads off a synthetic genome (errors -> unique k-mers)."""
    rng = np.random.default_rng(seed)
    genome = BASES[rng.integers(0, 4, genome_len)]
    reads = []
    for _ in range(n_reads):
        start = int(rng.integers(0, genome_len - read_len))
        read = genome[start:start + read_len].copy()
        errs = rng.random(read_len) < error_rate
        read[errs] = BASES[rng.integers(0, 4, int(errs.sum()))]
        reads.append(read.tobytes())
    return reads


def kmers_of(read: bytes, k: int):
    for i in range(len(read) - k + 1):
        yield read[i:i + k]


def owner_of(kmer: bytes, n_ranks: int) -> int:
    return int.from_bytes(hashlib.blake2b(kmer, digest_size=4).digest(),
                          "little") % n_ranks


class BloomPair:
    """Two-layer Bloom filter (paper: filters out count-1 k-mers)."""

    def __init__(self, n_bits: int = 1 << 18, seed: int = 0):
        self.n_bits = n_bits
        self.layer1 = np.zeros(n_bits, bool)
        self.layer2 = np.zeros(n_bits, bool)

    def _idx(self, kmer: bytes) -> Tuple[int, int]:
        h = hashlib.blake2b(kmer, digest_size=8).digest()
        return (int.from_bytes(h[:4], "little") % self.n_bits,
                int.from_bytes(h[4:], "little") % self.n_bits)

    def insert(self, kmer: bytes) -> None:
        i, j = self._idx(kmer)
        if self.layer1[i] and self.layer1[j]:
            self.layer2[i] = self.layer2[j] = True      # second sighting
        else:
            self.layer1[i] = self.layer1[j] = True

    def probably_repeated(self, kmer: bytes) -> bool:
        i, j = self._idx(kmer)
        return bool(self.layer2[i] and self.layer2[j])


@dataclasses.dataclass
class KmerStats:
    n_ranks: int
    elapsed_s: float
    messages: int
    bytes_sent: int
    aggregation_flushes: int


class _RankState:
    def __init__(self, rank: int, n_ranks: int, agg_bytes: int):
        self.rank = rank
        self.bloom = BloomPair(seed=rank)
        self.counts: Counter = Counter()
        self.agg: Dict[int, List[bytes]] = defaultdict(list)
        self.agg_sizes: Dict[int, int] = defaultdict(int)
        self.agg_bytes = agg_bytes
        self.flushes = 0


def run_kmer_count(reads: List[bytes], k: int, n_ranks: int, *,
                   agg_bytes: int = 8 * 1024, device=None
                   ) -> Tuple[Counter, KmerStats]:
    """Distributed two-pass k-mer count; returns (histogram, stats).
    ``device`` binds the cluster (the card unless the caller asks for
    the CPU); the payloads are host bytes either way."""
    cl = LocalCluster(n_ranks, attrs={"eager_max_bytes": 256,
                                      "rdv_threshold": 16 * 1024,
                                      "packet_bytes": 32 * 1024},
                      device=device)
    states = [_RankState(r, n_ranks, agg_bytes) for r in range(n_ranks)]
    cqs = [cl[r].alloc_cq() for r in range(n_ranks)]
    rcomps = [cl[r].register_rcomp(cqs[r]) for r in range(n_ranks)]
    t0 = time.perf_counter()

    def flush(src: int, dst: int, phase: int):
        st = states[src]
        if not st.agg[dst]:
            return
        payload = b"\0".join(st.agg[dst])
        status = post_am_x(cl[src], dst, np.frombuffer(payload, np.uint8),
                           None, None, rcomps[dst]).tag(phase)()
        while status.is_retry():                     # back-pressure: progress
            cl.progress_all()
            status = post_am_x(cl[src], dst,
                               np.frombuffer(payload, np.uint8),
                               None, None, rcomps[dst]).tag(phase)()
        st.agg[dst].clear()
        st.agg_sizes[dst] = 0
        st.flushes += 1

    def drain(rank: int, phase: int):
        """Serve incoming RPCs (the all-worker setup)."""
        while True:
            msg = cqs[rank].pop()
            if msg.is_retry():
                break
            data = bytes(np.asarray(msg.get_buffer()).tobytes())
            st = states[rank]
            for kmer in data.split(b"\0"):
                if not kmer:
                    continue
                if phase == 1:
                    st.bloom.insert(kmer)
                else:
                    if st.bloom.probably_repeated(kmer):
                        st.counts[kmer] += 1

    def traverse(phase: int):
        share = (len(reads) + n_ranks - 1) // n_ranks
        for r in range(n_ranks):
            st = states[r]
            for read in reads[r * share:(r + 1) * share]:
                for kmer in kmers_of(read, k):
                    dst = owner_of(kmer, n_ranks)
                    st.agg[dst].append(kmer)
                    st.agg_sizes[dst] += len(kmer) + 1
                    if st.agg_sizes[dst] >= st.agg_bytes:
                        flush(r, dst, phase)
                # all-worker: serve + progress while producing
                cl[r].progress()
                drain(r, phase)
        for r in range(n_ranks):
            for dst in range(n_ranks):
                flush(r, dst, phase)
        for _ in range(4):
            cl.progress_all()
            for r in range(n_ranks):
                drain(r, phase)
        cl.quiesce()
        for r in range(n_ranks):
            drain(r, phase)

    traverse(1)                                      # Bloom pass
    traverse(2)                                      # exact-count pass

    total = Counter()
    for st in states:
        total.update(st.counts)
    elapsed = time.perf_counter() - t0
    stats = KmerStats(
        n_ranks=n_ranks, elapsed_s=elapsed,
        messages=sum(cl[r].stats.total_msgs for r in range(n_ranks)),
        bytes_sent=sum(cl[r].stats.total_bytes for r in range(n_ranks)),
        aggregation_flushes=sum(st.flushes for st in states))
    return total, stats


def reference_count(reads: List[bytes], k: int) -> Counter:
    """Oracle: exact counts of k-mers occurring at least twice."""
    c = Counter()
    for read in reads:
        for kmer in kmers_of(read, k):
            c[kmer] += 1
    return Counter({km: n for km, n in c.items() if n >= 2})
