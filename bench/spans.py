"""The program's spans and counters in a cell's traced stretch.

    python3 bench/spans.py --workload NAME --seed N > OUT.json

Sets the cell up as ``bench/run.py`` does (weights and traffic from the
seed, every shape warmed up), then runs its traced stretch under
``torch.profiler`` four times: with the program's telemetry hub off, as
the benchmark runs it, and with the hub active at ``trace`` level, so
that each span of the program is a ``repro:`` annotation in the trace,
in turn; then the stretch's calls with no profiler, the hub off and at
``timers`` level.
Prints one JSON object as the last line of standard output:

- ``off`` and ``on``: for each traced stretch, in turn, the host ms from
  a call's entry to its return (``dispatch_ms``) and the device's idle
  share (``idle_pct``): what the spans cost when they are on;
  ``unprofiled_ms``: the same host ms with no profiler, the hub off and
  at ``timers`` level; ``host_ms``: each span's host ms a call there;
- ``metrics``: the per-layer readings the spans and counters give
  (``moe_routing_share.prefill`` and the rest, by cell);
- ``device_pct``: the share of the busy time charged to each span
  (``bench/harness/spans.py``), ``unattributed`` among them;
  ``inclusive_pct``: each span's inclusive share; ``busy_ms``;
- ``checks``: the kernel launches of ``moe_gmm`` and ``ssd_scan`` all
  charged to the span that holds their call, and the MoE fill the
  counters give against the one rebuilt from the kernel calls;
- ``idle_gaps``: the idle gaps named by program span;
- ``counters``: the hub's counter snapshot; ``sites_per_call``: span
  sites entered per call or step; ``off_site_ns``: the host ns one span
  site costs with the hub off.

A program without the hub's ``activated`` gets the stretches with the
hub off alone.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the per-layer readings of the spans: name -> (kind, stages)
SHARES = {
    "moe_routing_share.prefill": ("prefill", ("moe.router", "moe.slots",
                                              "moe.dispatch",
                                              "moe.combine")),
    "ssm_passes_share.prefill": ("prefill", ("ssm.conv", "ssm.gate")),
    "optimizer_share.train": ("train", ("train.grad_sync", "train.clip",
                                        "train.adamw")),
    "backward_share.train": ("train", ("train.backward",)),
}


def off_site_ns(n: int = 200_000, repeats: int = 5) -> float:
    """The least host ns of one span site with no hub active, over
    ``repeats`` loops of ``n`` (the empty loop's time taken off)."""
    from repro_torch.core.telemetry import active
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with active().span("site"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t2 = time.perf_counter_ns()
        best = min(best, ((t1 - t0) - (t2 - t1)) / n)
    return best


def _setup(cell, device):
    """The program's configuration and the stretch: (cfg, plan, call(j),
    the first call j, the number of calls, the harness span of a
    call)."""
    import torch
    from bench.harness import model, runner
    from bench.harness import traffic as traffic_mod
    cfg = model.program_config(cell.config, cell.smoke)
    params, specs = model.make_weights(cfg, cell.seed, device,
                                       cell.config.get("init"))
    plan = traffic_mod.plan(cell.traffic, cfg.vocab, cell.seed, device)
    entries = runner.default_entries()
    tr = cell.traffic
    if tr["kind"] == "prefill":
        fn = entries["prefill"](cfg)
        for shape in plan.shapes():                     # warm-up
            for k in range(2):
                fn(params, plan.warm_batch(shape, k))
        n = int(tr.get("trace_blocks", 2)) * len(plan.block)

        def call(j):
            fn(params, plan.batch(j))
        return cfg, plan, call, 0, n, "serving.prefill"

    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainState
    opt = AdamWConfig(**tr["optimizer"])
    step = entries["train"](build_model(cfg, device=device), specs, opt)
    box = [TrainState(params, adamw_init(params, opt))]
    first = int(tr.get("checked_steps", 3))
    for i in range(first):                              # warm-up
        box[0], _ = step(box[0], plan.batch(i))
    del params
    if device.type == "cuda":
        torch.cuda.synchronize()

    def call(j):
        box[0], _ = step(box[0], plan.batch(j))
    return cfg, plan, call, first, int(tr.get("trace_steps", 2)), \
        "train.step"


def _calls(call, first, n, span, clock):
    """The calls of a stretch, each in its harness spans: host s of each
    call from its entry to its return."""
    from bench.harness import runner
    disp = []
    for j in range(first, first + n):
        with runner._span(span):
            t0 = clock.now()
            call(j)
            disp.append(clock.now() - t0)
        with runner._span("window.sync"):
            clock.sync()
    return disp


def _traced(call, first, n, span, clock, hub):
    """One traced stretch inside ``hub``, the kernel calls recorded as the
    benchmark's stretch records them: (Spans, host s of each call,
    KernelCalls)."""
    import torch
    from bench.harness import calls as calls_mod
    from bench.harness import runner
    from bench.harness import spans as spans_mod
    with calls_mod.KernelCalls() as kc:
        prof = torch.profiler.profile(activities=runner._activities(clock))
        prof.start()
        with hub, runner._span("stretch"):
            disp = _calls(call, first, n, span, clock)
        prof.stop()
    return spans_mod.from_profiler(prof), disp, kc


def _fill_from_calls(kc, cfg, plan, first, n) -> dict:
    """The MoE fill rebuilt from the recorded ``moe_gmm`` calls: their
    rows summed on the device over E·cap of each layer of each call."""
    from repro_torch.models.moe import capacity
    filled = sum(int(c[1]) for c, _ in kc.raw["moe_gmm"] if c)
    allotted = 0
    for j in range(first, first + n):
        b, s = plan.shape(j)
        allotted += cfg.n_layers * cfg.n_experts * capacity(b * s, cfg)
    return {"filled": filled, "allotted": allotted}


def _ms(disp) -> float:
    return 1e3 * sum(disp) / len(disp)


def measure(name: str, seed: int, *, device="cuda", smoke: bool = False,
            root=None) -> dict:
    import torch
    from bench.harness import readers, runner
    from bench.harness import spans as spans_mod
    from bench.harness import trace as trace_mod
    from repro_torch.core import telemetry

    dev = torch.device(device)
    clock = runner.Clock(dev)
    cell = runner.load(name, seed, smoke=smoke, root=root)
    cfg, plan, call, first, n, span = _setup(cell, dev)
    kind = cell.traffic["kind"]
    per = "prefill" if kind == "prefill" else "train.forward"
    hub_on = hasattr(telemetry, "activated")
    out = {"workload": name, "seed": seed,
           "device": torch.cuda.get_device_name(dev) if clock.cuda
           else "cpu", "calls": n, "off": [], "on": []}

    def summary(sp, disp):
        ctx = runner.Context(kind, {}, out["device"], 1.0, [], disp,
                             trace=sp.trace)
        return {"dispatch_ms": _ms(disp),
                "idle_pct": readers.idle_percent(ctx)}

    # traced stretches, the spans off and on in turn
    for _ in range(2):
        sp_off, disp, _ = _traced(call, first, n, span, clock,
                                  contextlib.nullcontext())
        out["off"].append(summary(sp_off, disp))
        if hub_on:
            tele = telemetry.Telemetry("trace", trace_capacity=1 << 16)
            sp, disp, kc = _traced(call, first, n, span, clock,
                                   telemetry.activated(tele))
            out["on"].append(summary(sp, disp))
    out["idle_gaps_off"] = trace_mod.idle_gaps(sp_off.trace)
    # host times with no profiler: the hub off, then at timers level
    out["unprofiled_ms"] = {"off": _ms(_calls(call, first, n, span, clock))}
    if not hub_on:
        return out
    timers = telemetry.Telemetry("timers")
    with telemetry.activated(timers):
        out["unprofiled_ms"]["timers"] = _ms(_calls(call, first, n, span,
                                                    clock))
    host = timers.snapshot()

    snap = tele.snapshot()                  # the last traced stretch's
    counters = snap["counters"]
    busy = trace_mod.busy_ns(sp.trace) or 0
    by = spans_mod.device_ns(sp)
    metrics = {}
    for mname, (mkind, stages) in SHARES.items():
        if mkind == kind and any(s in snap["spans"] for s in stages):
            metrics[mname] = spans_mod.share(sp, stages)
    if kind == "prefill" and counters.get("moe.slots_allotted"):
        metrics["moe_fill.prefill"] = spans_mod.fill_percent(counters)
        metrics["moe_host_ms.prefill"] = spans_mod.span_ms(host, "moe.",
                                                           "prefill")
    out["metrics"] = metrics
    out["busy_ms"] = busy / 1e6
    out["device_pct"] = {k: 100.0 * v / busy for k, v in
                         sorted(by.items(), key=lambda kv: -kv[1])} \
        if busy else {}
    out["inclusive_pct"] = {k: spans_mod.share(sp, [k])
                            for k in sorted(snap["spans"])}
    out["attributed_over_busy"] = sum(by.values()) / busy if busy else None
    out["self_pct"] = {per: out["device_pct"].get(per)}
    out["host_ms"] = {k: h["sum"] / 1e6 / n
                      for k, h in sorted(host["spans"].items())}
    out["sites_per_call"] = sum(h["count"] for h in
                                host["spans"].values()) / n
    checks = {}
    for layer, stage in (("moe_gmm", "moe.experts"),
                         ("ssd_scan", "ssm.scan")):
        pat = trace_mod.KERNELS[layer]
        hits = [s for ev, s in spans_mod.charged(sp) if pat.search(ev.name)]
        if hits:
            checks[layer] = {
                "launches": len(hits),
                "outside_" + stage: sum(s != stage for s in hits),
                "kernel_ms": trace_mod.kernel_ns(sp.trace, layer)[0] / 1e6,
                stage + "_ms": by.get(stage, 0) / 1e6}
    if kc.raw["moe_gmm"]:
        rebuilt = _fill_from_calls(kc, cfg, plan, first, n)
        checks["moe_fill"] = {
            "counters": [counters.get("moe.slots_filled"),
                         counters.get("moe.slots_allotted")],
            "calls": [rebuilt["filled"], rebuilt["allotted"]],
            "equal": counters.get("moe.slots_filled") == rebuilt["filled"]
            and counters.get("moe.slots_allotted") == rebuilt["allotted"]}
    out["checks"] = checks
    out["idle_gaps"] = spans_mod.idle_gaps(sp)
    out["counters"] = counters
    out["off_site_ns"] = off_site_ns()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench import run
    run._paths()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
