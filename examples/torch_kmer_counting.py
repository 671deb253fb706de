"""K-mer counting (paper §5.3): the HipMer stage on the LCI-X runtime
(the PyTorch port).

    PYTHONPATH=src python examples/torch_kmer_counting.py [--reads 2000] \
        [--ranks 4] [--device cpu]

The mirror of ``examples/kmer_counting.py`` on ``repro_torch``: error-prone
synthetic reads; k-mers travel as aggregated active messages to
hash-owner ranks; two traversals (Bloom filter, then exact hashmap);
counts verified against a direct oracle.  The cluster binds ``--device``
(the card by default); the payloads are host bytes either way.
"""
import argparse
import json
import time

from repro_torch.apps.kmer import (generate_reads, reference_count,
                                   run_kmer_count)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=80)
    ap.add_argument("--k", type=int, default=11)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--agg-bytes", type=int, default=8 * 1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", action="store_true",
                    help="also print the whole histogram as one JSON line")
    args = ap.parse_args(argv)

    print(f"generating {args.reads} reads (len {args.read_len}, 1% errors)")
    reads = generate_reads(args.reads, args.read_len, seed=3)
    t0 = time.time()
    oracle = reference_count(reads, args.k)
    t_ref = time.time() - t0
    print(f"oracle: {len(oracle)} k-mers with >=2 occurrences "
          f"({t_ref:.2f}s single-threaded)")

    counts, stats = run_kmer_count(reads, args.k, args.ranks,
                                   agg_bytes=args.agg_bytes,
                                   device=args.device)
    wrong = sum(1 for k in oracle if counts.get(k, 0) != oracle[k])
    print(f"LCI-X {args.ranks} ranks on {args.device}: "
          f"{stats.elapsed_s:.2f}s, {stats.messages} messages, "
          f"{stats.aggregation_flushes} aggregation flushes")
    print(f"exactness: {len(oracle) - wrong}/{len(oracle)} counts correct")
    assert wrong == 0
    hist = {}
    for n in counts.values():
        hist[n] = hist.get(n, 0) + 1
    top = sorted(hist.items())[:8]
    print("histogram (count -> #kmers):", dict(top))
    if args.json:
        print(json.dumps({"histogram": sorted(hist.items())}))
    print("kmer example OK")


if __name__ == "__main__":
    main()
