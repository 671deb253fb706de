"""The port's telemetry hub on the model path (CPU): the process-wide hub
that ``activated`` installs, the spans of the prefill and the train
step, their profiler annotations and clock, and the device-side
counters of the MoE block."""
import threading

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import telemetry
from repro_torch.core.telemetry import (NULL_SPAN, NULL_TELEMETRY,
                                        PROFILER_PREFIX, Telemetry,
                                        activated, active)
from repro_torch.models import moe as moe_mod
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import make_prefill_step
from repro_torch.train import TrainState, make_train_step

MODEL_STAGES = ("prefill", "head", "embed", "norm")
STAGES = {
    "olmoe-1b-7b": MODEL_STAGES + ("attn", "moe.router", "moe.slots",
                                   "moe.dispatch", "moe.experts",
                                   "moe.combine"),
    "mamba2-370m": MODEL_STAGES + ("ssm.proj", "ssm.conv", "ssm.scan",
                                   "ssm.gate", "ssm.out"),
}
TRAIN_STAGES = ("train.forward", "train.backward", "train.grad_sync",
                "train.clip", "train.adamw", "train.metrics", "loss.head")


def _prefill(arch, b=2, s=16, seed=0):
    cfg = get_smoke(arch)
    params, _ = build_model(cfg, device="cpu").init(seed)
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (s, b), generator=gen)
    return cfg, make_prefill_step(cfg), params, {"tokens": tokens}


def _train(arch="mamba2-370m", b=2, s=16):
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    params, specs = model.init(0)
    opt = AdamWConfig()
    step = make_train_step(model, specs, opt, remat=True)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (s + 1, b), generator=gen)
    batch = {"tokens": tokens[:-1], "labels": tokens[1:]}
    return cfg, step, TrainState(params, adamw_init(params, opt)), batch


def _profiled(fn):
    """Run ``fn`` inside ``bench:call`` under the profiler; the host
    annotations as (name, start, end)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("bench:call"):
        out = fn()
    prof.stop()
    marks = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, marks


class _Spy(Telemetry):
    """A hub that notes what each span site was handed."""

    def __init__(self, level):
        super().__init__(level)
        self.handed = []

    def span(self, stage):
        out = super().span(stage)
        self.handed.append((stage, out))
        return out


def test_active_is_process_wide_and_restored():
    tele = Telemetry("timers")
    seen = []
    assert active() is NULL_TELEMETRY
    with activated(tele):
        t = threading.Thread(target=lambda: seen.append(active()))
        t.start()
        t.join()
        assert active() is tele
    assert seen == [tele] and active() is NULL_TELEMETRY


@pytest.mark.parametrize("arch", sorted(STAGES))
def test_off_sites_take_the_null_span(arch):
    _, fn, params, batch = _prefill(arch)
    spy = _Spy("off")
    with activated(spy):
        _, marks = _profiled(lambda: fn(params, batch))
    assert {s for s, _ in spy.handed} == set(STAGES[arch])
    assert all(out is NULL_SPAN for _, out in spy.handed)
    assert not [m for m in marks if m[0].startswith(PROFILER_PREFIX)]
    assert not spy.registry.snapshot()["hists"]


@pytest.mark.parametrize("arch", sorted(STAGES))
def test_trace_spans_are_profiler_annotations(arch):
    _, fn, params, batch = _prefill(arch)
    tele = Telemetry("trace")
    with activated(tele):
        _, marks = _profiled(lambda: fn(params, batch))
    (_, lo, hi), = [m for m in marks if m[0] == "bench:call"]
    inside = {n[len(PROFILER_PREFIX):] for n, s, e in marks
              if n.startswith(PROFILER_PREFIX) and lo <= s and e <= hi}
    assert inside == set(STAGES[arch])
    # the ring's stamps are the profiler's clock
    (_, p0, p1), = [m for m in marks if m[0] == PROFILER_PREFIX + "prefill"]
    ring, = [e for e in tele.trace.events() if e["name"] == "prefill"]
    assert abs(ring["ts_ns"] - p0) < 100_000
    assert abs(ring["ts_ns"] + ring["dur_ns"] - p1) < 100_000
    chrome = tele.chrome_trace()["traceEvents"]
    assert {e["name"] for e in chrome} == set(STAGES[arch])


def test_below_trace_no_annotation():
    _, fn, params, batch = _prefill("olmoe-1b-7b")
    tele = Telemetry("timers")
    with activated(tele):
        _, marks = _profiled(lambda: fn(params, batch))
    assert not [m for m in marks if m[0].startswith(PROFILER_PREFIX)]
    spans = tele.snapshot()["spans"]
    assert set(spans) == set(STAGES["olmoe-1b-7b"])
    assert spans["prefill"]["count"] == 1


def test_trace_without_profiler_annotates_nothing(monkeypatch):
    # with no profiler recording, a trace-level span enters no
    # record_function, and its duration ignores a step of the wall clock
    entered = []
    tele = Telemetry("trace")
    tele.record_function = lambda name: entered.append(name)
    wall = iter([10 ** 18, 0])
    with activated(tele), active().span("prefill"):
        monkeypatch.setattr(telemetry.timers.time, "time_ns",
                            lambda: next(wall))
    assert entered == []
    dur = tele.snapshot()["spans"]["prefill"]["sum"]
    ring, = tele.trace.events()
    assert 0 <= dur < 10 ** 9 and ring["dur_ns"] == dur


def test_train_step_spans_and_recompute():
    cfg, step, state, batch = _train()
    tele = Telemetry("trace")
    with activated(tele):
        _, marks = _profiled(lambda: step(state, batch))
    names = {n[len(PROFILER_PREFIX):] for n, _, _ in marks
             if n.startswith(PROFILER_PREFIX)}
    assert set(TRAIN_STAGES) <= names
    ev = tele.trace.events()
    back, = [e for e in ev if e["name"] == "train.backward"]
    fwd, = [e for e in ev if e["name"] == "train.forward"]

    def within(e, outer):
        return (outer["ts_ns"] <= e["ts_ns"] and e["ts_ns"] + e["dur_ns"]
                <= outer["ts_ns"] + outer["dur_ns"])

    scans = [e for e in ev if e["name"] == "ssm.scan"]
    # each layer's scan once in the forward, once more in its recompute
    assert sum(within(e, fwd) for e in scans) == cfg.n_layers
    assert sum(within(e, back) for e in scans) == cfg.n_layers
    assert sum(within(e, back) for e in ev
               if e["name"] == "loss.head") >= 1


def test_device_counters_stay_on_the_device(monkeypatch):
    cfg, fn, params, batch = _prefill("olmoe-1b-7b", b=4, s=32)
    routed = []
    orig = moe_mod.router_topk

    def spy(logits, c):
        out = orig(logits, c)
        routed.append(out[1])                   # (t, k) expert ids
        return out
    monkeypatch.setattr(moe_mod, "router_topk", spy)
    tele = Telemetry("counters")
    with activated(tele):
        fn(params, batch)
    shards = tele.registry._shards
    dev = {k: v for sh in shards for k, v in sh.device.items()}
    assert set(dev) == {"moe.slots_filled", "moe.dropped"}
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    t, k = batch["tokens"].numel(), cfg.top_k
    cap = moe_mod.capacity(t, cfg)
    filled = sum(int(torch.bincount(ex.reshape(-1), minlength=cfg.n_experts)
                     .clamp(max=cap).sum()) for ex in routed)
    counters = tele.snapshot()["counters"]
    assert len(routed) == cfg.n_layers
    assert counters["moe.slots_filled"] == filled
    assert counters["moe.dropped"] == cfg.n_layers * t * k - filled
    assert counters["moe.slots_allotted"] == \
        cfg.n_layers * cfg.n_experts * cap


def test_device_counter_sums_without_a_host_read():
    reg = telemetry.MetricRegistry()
    for v in (3, 4, 5):
        reg.add_device("x", torch.tensor(v))
    acc = reg._shard().device["x"]
    assert isinstance(acc, torch.Tensor) and int(acc) == 12
    assert reg.snapshot()["counters"]["x"] == 12
