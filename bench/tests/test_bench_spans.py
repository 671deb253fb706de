"""The program's spans in a trace: each device op charged to the span that
launched it, the idle gaps named by program span, and the span reader's
runs of each cell (with and without the program's hub)."""
import pytest
import torch

from bench import spans as spans_tool
from bench.harness import runner, spans, spec, trace
from bench.tests.test_bench_trace import ADD, FLASH, MUL, Ev
from repro_torch.core import telemetry

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
GMM = "void gmm_wgmma_kernel<128, 2>(CUtensorMap, int const*)"
COPY = "Memcpy DtoD (Device -> Device)"
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


class KEv(Ev):
    """A kineto event with a correlation id and a thread."""

    def __init__(self, name, dev, start, dur, mark=False, corr=0, tid=1):
        super().__init__(name, dev, start, dur, mark)
        self._c, self._t = corr, tid

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def launched(kernel, corr, t_launch, start, dur, tid=1,
             call="cudaLaunchKernel"):
    return [KEv(call, CPU, t_launch, 5, corr=corr, tid=tid),
            KEv(kernel, CUDA, start, dur, corr=corr)]


def program():
    """A call with program spans on two threads: the caller's (1) and a
    backward thread (2) with a span of its own at 390-420."""
    return spans.from_events([
        KEv("bench:stretch", CPU, 0, 1000, True),
        KEv("bench:serving.prefill", CPU, 0, 600, True),
        KEv("bench:window.sync", CPU, 600, 400, True),
        KEv("repro:prefill", CPU, 10, 580, True),
        KEv("repro:moe.experts", CPU, 100, 100, True),
        KEv("repro:moe.combine", CPU, 200, 100, True),
        KEv("repro:ssm.scan", CPU, 390, 30, True, tid=2),
        KEv("repro:prefill", CUDA, 260, 240, True),   # the mirrored mark
        KEv("aten::mm", CPU, 900, 5, corr=7),          # an op's own id
        *launched(FLASH, 11, 50, 260, 30),             # prefill's own
        *launched(GMM, 7, 150, 300, 100, call="cuLaunchKernelEx"),
        *launched(ADD, 8, 250, 400, 50, tid=2),        # no span on 2
        *launched(MUL, 9, 400, 450, 50, tid=2),        # 2's own span
        *launched(COPY, 10, 620, 700, 50, call="cudaMemcpyAsync"),
    ])


def test_device_ops_charged_to_the_innermost_span():
    sp = program()
    assert [s.name for s in sp.program] == ["prefill", "moe.experts",
                                            "moe.combine", "ssm.scan"]
    by = spans.device_ns(sp)
    assert by == {"prefill": 30, "moe.experts": 100, "moe.combine": 50,
                  "ssm.scan": 50, spans.UNATTRIBUTED: 50}
    assert sum(by.values()) == trace.busy_ns(sp.trace) == 280
    assert dict((e.name, s) for e, s in spans.charged(sp))[GMM] \
        == "moe.experts"
    assert spans.share(sp, ["moe.experts"]) == 100.0 * 100 / 280
    # inclusive, on any thread: all but the copy launched after prefill
    assert spans.share(sp, ["prefill"]) == 100.0 * 230 / 280
    assert spans.share(sp, ["moe.combine", "ssm.scan"]) == \
        100.0 * 100 / 280


def test_span_ms_from_the_hub():
    snap = {"spans": {"prefill": {"count": 2, "sum": 9_000_000},
                      "moe.router": {"count": 32, "sum": 3_000_000},
                      "moe.slots": {"count": 32, "sum": 1_000_000},
                      "norm": {"count": 64, "sum": 5_000_000}}}
    assert spans.span_ms(snap, "moe.", "prefill") == 2.0
    assert spans.span_ms({}, "moe.", "prefill") is None


def test_gaps_named_by_program_span():
    gaps = dict(spans.idle_gaps(program()))
    assert gaps == {
        "serving.prefill -> flash_attention: flash_fwd_tc_kernel": 260e-9,
        "moe.combine -> moe_gmm: gmm_wgmma_kernel": 10e-9,
        "prefill -> " + COPY: 200e-9,
        "window.sync -> end": 250e-9}


def test_without_program_spans_reads_as_the_trace_does():
    from bench.tests.test_bench_trace import sample
    events = [
        Ev("bench:stretch", CPU, 0, 1000, True),
        Ev("bench:serving.prefill", CPU, 0, 500, True),
        Ev("bench:window.sync", CPU, 500, 500, True),
        Ev("bench:serving.prefill", CUDA, 0, 900),
        Ev("aten::add", CPU, 10, 5),
        Ev(FLASH, CUDA, 100, 200),
        Ev(ADD, CUDA, 250, 100),
        Ev(MUL, CUDA, 600, 100),
        Ev(COPY, CUDA, 800, 50),
    ]
    sp = spans.from_events(events)       # no correlation ids, no threads
    base = sample()
    assert sp.trace == base and sp.program == []
    assert spans.idle_gaps(sp) == trace.idle_gaps(base)
    assert spans.device_ns(sp) == {spans.UNATTRIBUTED: trace.busy_ns(base)}
    assert spans.share(sp, ["prefill"]) is None
    assert spans.fill_percent({}) is None


@pytest.mark.parametrize("name", CELLS)
def test_benchmark_reads_the_same_with_the_hub_on(name, monkeypatch):
    """The benchmark's traced run prints the same metric keys and
    breakdown names whether the program's spans are on, off, or absent
    (a program without ``activated``, as at the parent commit)."""
    def line():
        r = runner.run(name, 2 ** 31 + 11, 0.05, True, device="cpu",
                       smoke=True)
        return (sorted(r["metrics"]), {k: [g[0] for g in v]
                                       for k, v in r["breakdown"].items()})
    off = line()
    with telemetry.activated(telemetry.Telemetry("trace")):
        on = line()
    monkeypatch.delattr(telemetry, "activated")
    assert on == off == line()


#: the readings of the spans and counters in each cell
READINGS = {
    "olmoe-prefill-mix": {"moe_routing_share.prefill", "moe_fill.prefill",
                          "moe_host_ms.prefill"},
    "mamba2-prefill-mix": {"ssm_passes_share.prefill"},
    "mamba2-train-32x2048": {"optimizer_share.train",
                             "backward_share.train"},
}


@pytest.mark.parametrize("name", CELLS)
def test_span_reader_runs_each_cell(name):
    out = spans_tool.measure(name, 2 ** 31 + 5, device="cpu", smoke=True)
    assert set(out["metrics"]) == READINGS[name]
    if name.startswith("olmoe"):
        assert out["checks"]["moe_fill"]["equal"]
        assert set(out["counters"]) == {"moe.slots_allotted",
                                        "moe.slots_filled", "moe.dropped"}
    assert out["sites_per_call"] > 0 and out["off_site_ns"] > 0
    assert len(out["off"]) == len(out["on"]) == 2
    assert set(out["unprofiled_ms"]) == {"off", "timers"}


def test_span_reader_on_a_program_without_the_hub(monkeypatch):
    monkeypatch.delattr(telemetry, "activated")
    out = spans_tool.measure(CELLS[0], 3, device="cpu", smoke=True)
    assert out["on"] == [] and "metrics" not in out
    assert len(out["off"]) == 2 and set(out["unprofiled_ms"]) == {"off"}
