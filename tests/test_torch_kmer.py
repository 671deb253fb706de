"""The port's k-mer counting mini-app (``repro_torch/apps/kmer.py``, the
paper's Fig 6 HipMer stage) held against the JAX package's on the CPU.

The same seeded reads go through both packages' ``run_kmer_count``; the
port's histogram must equal the reference's and the oracle
``reference_count`` exactly, and its message and flush counts must equal
the reference's (the aggregation buffers are the reference's 8 KiB, or
a small size that forces many flushes).  The payloads are host bytes on
both sides: no kernel is on this path.
"""
import numpy as np
import pytest

from repro.apps import kmer as ref

from repro_torch.apps import kmer
from repro_torch.core import FatalError

K = 11
READ_LEN = 80


@pytest.fixture(scope="module")
def reads():
    out = kmer.generate_reads(150, READ_LEN, seed=5)
    assert out == ref.generate_reads(150, READ_LEN, seed=5)
    return out


def test_owner_and_bloom_match_reference(reads):
    rng = np.random.default_rng(0)
    bp, rbp = kmer.BloomPair(n_bits=1 << 10), ref.BloomPair(n_bits=1 << 10)
    for read in reads[:20]:
        for km in kmer.kmers_of(read, K):
            for n in (1, 2, 3, 7):
                assert kmer.owner_of(km, n) == ref.owner_of(km, n)
            if rng.random() < 0.7:
                bp.insert(km)
                rbp.insert(km)
            assert bp.probably_repeated(km) == rbp.probably_repeated(km)
    assert np.array_equal(bp.layer1, rbp.layer1)
    assert np.array_equal(bp.layer2, rbp.layer2)


@pytest.mark.parametrize("agg_bytes", [8 * 1024, 512])
@pytest.mark.parametrize("n_ranks", [2, 3, 4])
def test_histogram_matches_reference(reads, n_ranks, agg_bytes):
    hist, stats = kmer.run_kmer_count(reads, K, n_ranks,
                                      agg_bytes=agg_bytes, device="cpu")
    rhist, rstats = ref.run_kmer_count(reads, K, n_ranks,
                                       agg_bytes=agg_bytes)
    assert hist == rhist == kmer.reference_count(reads, K)
    assert hist == ref.reference_count(reads, K)
    assert len(hist) > 0
    assert (stats.n_ranks, stats.messages, stats.bytes_sent,
            stats.aggregation_flushes) == \
        (rstats.n_ranks, rstats.messages, rstats.bytes_sent,
         rstats.aggregation_flushes)


def test_cluster_defaults_to_the_card(reads):
    """``device=None`` binds the card, or refuses: never a silent CPU
    run."""
    import torch
    if torch.cuda.is_available():
        hist, _ = kmer.run_kmer_count(reads[:4], K, 2)
        assert hist == kmer.reference_count(reads[:4], K)
    else:
        with pytest.raises(FatalError, match="device='cpu'"):
            kmer.run_kmer_count(reads[:4], K, 2)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_quick_size_histogram_matches_reference(n_ranks):
    """At ``configs/paper.py``'s quick size (``kmer_reads // 4`` reads)
    and the reference benchmark's seed 3, both packages give the same
    histogram and counts, the Bloom filter's false positives included:
    the k-mers counted once beyond ``reference_count`` are the
    reference's own, and every repeated k-mer is exact."""
    from repro_torch.configs.paper import PAPER
    reads = kmer.generate_reads(PAPER.kmer_reads // 4, PAPER.kmer_read_len,
                                seed=3)
    assert reads == ref.generate_reads(PAPER.kmer_reads // 4,
                                       PAPER.kmer_read_len, seed=3)
    hist, stats = kmer.run_kmer_count(reads, PAPER.kmer_k, n_ranks,
                                      agg_bytes=PAPER.kmer_agg_bytes,
                                      device="cpu")
    rhist, rstats = ref.run_kmer_count(reads, PAPER.kmer_k, n_ranks,
                                       agg_bytes=PAPER.kmer_agg_bytes)
    assert hist == rhist
    assert (stats.messages, stats.bytes_sent, stats.aggregation_flushes) \
        == (rstats.messages, rstats.bytes_sent, rstats.aggregation_flushes)
    oracle = ref.reference_count(reads, PAPER.kmer_k)
    assert all(hist.get(k) == n for k, n in oracle.items())
    assert all(n == 1 for k, n in hist.items() if k not in oracle)
