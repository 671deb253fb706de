"""One run of one cell: set-up, the measured window, the traced stretch,
then the comparison with the reference.

- Set-up: the weights from the seed on the device, the program's entry
  built, every shape of the cell's traffic warmed up (a training cell:
  the checked steps, which go through the window's own step and feed).
- The window: the cell's closed loop for ``seconds`` seconds.  A prefill
  cell runs whole blocks of its mix; each call is timed from its entry
  to the synchronize after it.  A training cell runs whole steps and
  ends in a synchronize.  Nothing is built or compiled in it.
- The traced stretch (``trace``): a few more blocks or steps under
  ``torch.profiler``, with the kernel calls recorded
  (:mod:`.calls`); the per-layer metrics are read from the window and
  the stretch by the readers under ``bench/metrics``.
- The comparison (:mod:`.correct`): once the window is over, its peak
  memory read and the program's state freed, the configuration's
  reference (under ``bench/reference``) works out the sampled answers
  again.

The program's entry points can be handed in (``entries``), so that a
test can drive a run with the program broken underneath.
"""
from __future__ import annotations

import dataclasses
import math
import random
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from . import calls as calls_mod
from . import correct, model, seeds, spec
from . import trace as trace_mod
from . import traffic as traffic_mod

GIB = float(1 << 30)
#: the train step recomputes each layer in the backward, as the
#: launcher runs it by default
REMAT = True


def default_entries() -> Dict[str, Callable]:
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.train.step import make_train_step
    return {"prefill": lambda cfg: make_prefill_step(cfg),
            "train": lambda mdl, specs, opt: make_train_step(
                mdl, specs, opt, remat=REMAT)}


class Clock:
    """Host time, and the device's synchronize when there is one."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @staticmethod
    def now() -> float:
        return time.perf_counter()


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    kind: str                          # prefill | train
    model: Dict[str, Any]              # the configuration's model fields
    device_name: str
    window_s: float
    work: List[tuple]                  # (batch, seq) of each window call
    dispatch_s: List[float]            # host time of each window call
    trace: Optional[trace_mod.Trace] = None
    calls: Optional[calls_mod.KernelCalls] = None


def _span(name: str):
    return torch.profiler.record_function(trace_mod.SPAN_PREFIX + name)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _prefill(cell, cfg, params, plan, seconds, do_trace, entries, clock,
             t_process, out):
    fn = entries["prefill"](cfg)
    for shape in plan.shapes():                       # warm-up
        for k in range(2):
            fn(params, plan.warm_batch(shape, k))
    clock.sync()
    block = len(plan.block)
    served: Dict[int, tuple] = {}
    inputs: Dict[int, torch.Tensor] = {}
    lat, disp, work = [], [], []
    i = 0
    t_first = None
    while True:
        for _ in range(block):
            batch = plan.batch(i)
            t0 = clock.now()
            if t_first is None:
                t_first = t0
            tok, last = fn(params, batch)
            t1 = clock.now()
            clock.sync()
            t2 = clock.now()
            lat.append(t2 - t0)
            disp.append(t1 - t0)
            work.append(plan.shape(i))
            # the answer alone: ``last`` may be a view that holds the
            # call's whole hidden state
            served[i] = (tok, last.clone())
            inputs[i] = batch["tokens"]
            i += 1
        if t2 - t_first >= seconds:
            break
    window = t2 - t_first
    tokens = sum(b * s for b, s in work)
    out["setup_s"] = t_first - t_process
    out["prefill_tok_s"] = tokens / window
    out["prefill_p95_ms"] = 1e3 * statistics.quantiles(
        lat, n=20, method="inclusive")[18]
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if clock.cuda else 0
    out["attempted"] = i
    ctx = Context("prefill", model.model_fields(cell.config, cell.smoke),
                  out["device_name"], window, work, disp)

    if do_trace:
        n = int(cell.traffic.get("trace_blocks", 2)) * block
        with calls_mod.KernelCalls() as kc:
            prof = torch.profiler.profile(activities=_activities(clock))
            prof.start()
            with _span("stretch"):
                for j in range(i, i + n):
                    batch = plan.batch(j)
                    with _span("serving.prefill"):
                        fn(params, batch)
                    with _span("window.sync"):
                        clock.sync()
            prof.stop()
        ctx.trace, ctx.calls = trace_mod.from_profiler(prof), kc
        del prof

    del fn
    if clock.cuda:
        torch.cuda.empty_cache()
    # the sample: one call of the longest shape, then calls drawn from
    # the seed until their sequences serve check_tokens tokens
    rng = random.Random(seeds.derive(cell.seed, "sample"))
    longest = max(s for _, s in work)
    order = list(range(i))
    rng.shuffle(order)
    first = next(j for j in order if work[j][1] == longest)
    picked, have = [first], work[first][0]
    for j in order:
        if have >= int(cell.traffic.get("check_tokens", 256)):
            break
        if j != first:
            picked.append(j)
            have += work[j][0]
    return ctx, [(served[j], inputs[j]) for j in picked]


def check_prefill(ref, params, m, sample, mode: str = "f32"):
    """The comparison's numbers over ``sample``: [((tok, last), tokens)],
    against the reference module ``ref``."""
    ref.no_tf32()
    refs = [ref.prefill_last(params, m, tokens, mode)
            for _, tokens in sample]
    return correct.prefill_numbers([s for s, _ in sample], refs)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train(cell, cfg, params, specs, plan, seconds, do_trace, entries,
           clock, t_process, out):
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainState

    tr = cell.traffic
    opt = AdamWConfig(**tr["optimizer"])
    mdl = build_model(cfg, device=plan.tokens.device)
    step = entries["train"](mdl, specs, opt)
    # what the reference needs is kept on the host, off the card's peak
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.leaves(params)}
    state = TrainState(params, adamw_init(params, opt))
    prog: Dict[str, Any] = {"loss": []}
    n_checked = int(tr.get("checked_steps", 3))
    for i in range(n_checked):                       # set-up and warm-up
        state, met = step(state, plan.batch(i))
        prog["loss"].append(met["loss"].detach().float())
        if i == 0:                 # the first gradient: mu / (1 - b1)
            first = {k: v.float() / (1 - opt.b1)
                     for k, v in model.leaves(state.opt.mu)}
            prog["grad"] = {k: v.norm() for k, v in first.items()}
            prog["grad_tensors"] = {k: v.to("cpu")
                                    for k, v in first.items()}
            del first
    final = state.opt.master if state.opt.master is not None \
        else state.params
    prog["change"] = {k: (v.float() - init[k].to(v.device).float()).norm()
                      for k, v in model.leaves(final)}
    clock.sync()
    setup_peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    disp, work = [], []
    i = n_checked
    t_first = clock.now()
    while True:
        batch = plan.batch(i)
        t0 = clock.now()
        state, _ = step(state, batch)
        disp.append(clock.now() - t0)
        work.append((plan.b, plan.s))
        i += 1
        if clock.now() - t_first >= seconds:
            break
    clock.sync()
    window = clock.now() - t_first
    out["setup_s"] = t_first - t_process
    out["train_tok_s"] = sum(b * s for b, s in work) / window
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    out["train_peak_gib"] = peak / GIB
    out["memory_peak_bytes"] = max(peak, setup_peak)
    out["attempted"] = len(work)
    ctx = Context("train", model.model_fields(cell.config, cell.smoke),
                  out["device_name"], window, work, disp)

    if do_trace:
        n = int(tr.get("trace_steps", 2))
        with calls_mod.KernelCalls() as kc:
            prof = torch.profiler.profile(activities=_activities(clock))
            prof.start()
            with _span("stretch"):
                for j in range(i, i + n):
                    batch = plan.batch(j)
                    with _span("train.step"):
                        state, _ = step(state, batch)
                    with _span("window.sync"):
                        clock.sync()
            prof.stop()
        ctx.trace, ctx.calls = trace_mod.from_profiler(prof), kc
        del prof

    prog = {"loss": [x.item() for x in prog["loss"]],
            "grad": {k: v.item() for k, v in prog["grad"].items()},
            "change": {k: v.item() for k, v in prog["change"].items()},
            "grad_tensors": prog["grad_tensors"]}
    del state, step, mdl, params
    if clock.cuda:
        torch.cuda.empty_cache()
    return ctx, (init, prog)


def check_train(cell, init, prog, m, plan, mode: str = "f32",
                rows: int = 2):
    """The comparison's numbers: the reference's checked steps from the
    same weights on the same batches against the program's readings."""
    ref = cell.ref
    ref.no_tf32()
    n = len(prog["loss"])
    batches = [plan.batch(i) for i in range(n)]
    dev = plan.tokens.device
    r = ref.train_steps({k: v.to(dev) for k, v in init.items()}, m, batches,
                        cell.traffic["optimizer"], mode, rows)
    return correct.train_numbers(prog, r), r


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _num(x: float):
    """A number for the JSON line: a non-finite one as its name."""
    return x if math.isfinite(x) else repr(x)


def _activities(clock):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def load(name: str, seed: int, *, smoke: bool = False, root=None):
    cell = spec.cell(name, root)
    cell.traffic = traffic_mod.resolve(cell.traffic, smoke)
    cell.smoke = smoke
    cell.seed = seed
    return cell


def run(name: str, seed: int, seconds: float, do_trace: bool, *,
        device="cuda", smoke: bool = False, root=None,
        entries: Optional[Dict[str, Callable]] = None,
        t_process: Optional[float] = None, every: bool = False
        ) -> Dict[str, Any]:
    """One run; returns the result's fields, ``checks`` last: the numbers
    compared with their limits (``every``: all the numbers read)."""
    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    clock = Clock(dev)
    entries = {**default_entries(), **(entries or {})}
    cell = load(name, seed, smoke=smoke, root=root)
    cfg = model.program_config(cell.config, smoke)
    m = cell.ref.Model.of(model.model_fields(cell.config, smoke))
    params, specs = model.make_weights(cfg, seed, dev,
                                       cell.config.get("init"))
    plan = traffic_mod.plan(cell.traffic, cfg.vocab, seed, dev)
    out: Dict[str, Any] = {
        "device_name": torch.cuda.get_device_name(dev) if clock.cuda
        else "cpu"}
    if cell.traffic["kind"] == "prefill":
        ctx, sample = _prefill(cell, cfg, params, plan, seconds, do_trace,
                               entries, clock, t_process, out)
        numbers = check_prefill(cell.ref, params, m, sample)
    else:
        ctx, (init, prog) = _train(cell, cfg, params, specs, plan, seconds,
                                   do_trace, entries, clock, t_process, out)
        del params
        numbers, _ = check_train(cell, init, prog, m, plan)
    ok, rows = correct.judge(numbers, cell.limits, every=every)

    if do_trace:
        metrics = {}
        for mt in cell.per_layer:
            v = spec.reader(mt["name"], cell.root)(ctx)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    else:
        metrics = {}
        for mt in cell.end_to_end:
            if mt["name"] not in out:
                raise KeyError(f"{name} reports no {mt['name']}")
            metrics[mt["name"]] = {"value": out[mt["name"]],
                                   "unit": mt["unit"]}
    device = {"platform": "gpu" if clock.cuda else "cpu",
              "kind": out["device_name"],
              "count": torch.cuda.device_count() if clock.cuda else 0,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if clock.cuda:
        device["count"] = cell.chips
    result = {"correct": ok, "attempted": out["attempted"], "failed": 0,
              "metrics": metrics, "device": device}
    if do_trace and ctx.trace is not None:
        win = ctx.trace.window
        busy = trace_mod.busy_ns(ctx.trace)
        if win is not None:
            device["busy_s"] = (busy or 0) / 1e9
            device["window_s"] = (win[1] - win[0]) / 1e9
        result["breakdown"] = {
            "device_ops": trace_mod.device_ops(ctx.trace),
            "idle_gaps": trace_mod.idle_gaps(ctx.trace)}
    result["checks"] = {n: {"value": _num(v), "limit": _num(lim)}
                        for n, v, lim in rows}
    return result
