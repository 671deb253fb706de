"""The readings that a cell's correctness limits are set from.

    python3 bench/calibrate.py --workload NAME --seeds 12 --control 3 \
        [--seconds 3] [--faults] [--control-mode bf16] [--out DIR]

For each seed, one short run of the cell as the benchmark runs it (a
window of ``--seconds``, then the comparison with the reference) gives
the program's numbers: their largest over the seeds is each limit's
lower reading.  The control (``--control`` seeds) is the reference put
in the program's place and computed with float8 products: its smallest
numbers are the upper readings.  ``--faults`` reads the faults the cell
can have, each planted in the program: an altered answer (prefill); a
step that leaves its state unchanged and half of the batch left out
(training).  ``--control-mode bf16`` reads a witness in place of the
control: the reference with its products on bfloat16 operands, which
shows what bf16 rounding alone gives.  One JSON line a reading on
standard output and in ``DIR/calibrate-<workload>.jsonl``.  Needs the card; the benchmark's own
runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--control-mode", default="fp8",
                    help="the products' precision of the control")
    ap.add_argument("--fault-names", default="",
                    help="comma-separated faults to read (default: all)")
    ap.add_argument("--out", default=str(ROOT / "build" / "calibrate"))
    args = ap.parse_args(argv)

    import torch
    from bench.harness import faults, runner
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log = open(out / f"calibrate-{args.workload}.jsonl", "a")

    def emit(kind, seed, numbers, t0):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "numbers": numbers, "s": time.perf_counter() - t0}
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    control = "control" + ("" if args.control_mode == "fp8"
                           else f"-{args.control_mode}")
    count = max(args.seeds, args.control, args.fault_seeds * args.faults)
    seeds = [args.first_seed + 7919 * k for k in range(count)]
    for seed in seeds[:args.seeds]:
        t0 = time.perf_counter()
        r = runner.run(args.workload, seed, args.seconds, False, every=True)
        emit("program", seed, {k: v["value"] for k, v in r["checks"].items()},
             t0)
    for seed in seeds[:args.control]:
        t0 = time.perf_counter()
        emit(control, seed, faults.control(args.workload, seed, args.seconds,
                                           mode=args.control_mode), t0)
    if args.faults:
        chosen = [n for n in args.fault_names.split(",") if n]
        for name in chosen or faults.names(args.workload):
            for seed in seeds[:args.fault_seeds]:
                t0 = time.perf_counter()
                r = runner.run(args.workload, seed, args.seconds, False,
                               entries=faults.entries(name), every=True)
                emit(name, seed,
                     {k: v["value"] for k, v in r["checks"].items()}, t0)
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
