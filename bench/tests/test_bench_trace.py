"""Reading a trace: busy time, kernel time by layer, readable names, idle
gaps by what the host was doing, and the readers built on them."""
import torch

from bench.harness import calls, readers, runner, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
FLASH = ("void flash_fwd_tc_kernel<128, true>(CUtensorMap, CUtensorMap, "
         "float)")
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >"
       "(int, at::native::CUDAFunctor_add<c10::BFloat16>, "
       "std::array<char*, 3ul>)")
MUL = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::BinaryFunctor<float, float, float, "
       "at::native::binary_internal::MulFunctor<float> >, "
       "std::array<char*, 3ul> >(int, ...)")


class Ev:
    def __init__(self, name, dev, start, dur, mark=False):
        self._n, self._d, self._m = name, dev, mark
        self._s, self._u = start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._m


def sample():
    return trace.from_events([
        Ev("bench:stretch", CPU, 0, 1000, True),
        Ev("bench:serving.prefill", CPU, 0, 500, True),
        Ev("bench:window.sync", CPU, 500, 500, True),
        Ev("bench:serving.prefill", CUDA, 0, 900),     # the mirrored mark
        Ev("aten::add", CPU, 10, 5),
        Ev(FLASH, CUDA, 100, 200),
        Ev(ADD, CUDA, 250, 100),                         # overlaps flash
        Ev(MUL, CUDA, 600, 100),
        Ev("Memcpy DtoD (Device -> Device)", CUDA, 800, 50),
    ])


def test_busy_and_kernels():
    t = sample()
    assert [e.name for e in t.device][0] == FLASH       # the mark is gone
    assert t.window == (0, 1000)
    assert trace.busy_ns(t) == 250 + 100 + 50
    assert trace.kernel_ns(t, "flash_attention") == (200, 1)
    assert trace.kernel_ns(t, "moe_gmm") == (0, 0)


def test_names_read_apart():
    a, m = trace.short_name(ADD), trace.short_name(MUL)
    assert a != m and a.startswith("aten: ") and "MulFunctor" in m
    assert trace.short_name(FLASH) == "flash_attention: flash_fwd_tc_kernel"
    ops = dict(trace.device_ops(sample()))
    assert ops["flash_attention: flash_fwd_tc_kernel"] == 200e-9


def test_idle_gaps_by_host_span():
    gaps = dict(trace.idle_gaps(sample()))
    assert gaps["serving.prefill -> flash_attention: flash_fwd_tc_kernel"] \
        == 100e-9
    assert sum(gaps.values()) == (1000 - 400) / 1e9


def test_readers_need_something_to_read():
    ctx = runner.Context("prefill", {}, "NVIDIA H100 80GB HBM3", 2.0,
                         [(2, 8)], [0.001])
    assert readers.idle_percent(ctx) is None
    assert readers.roofline_percent(ctx, "flash_attention") is None
    ctx.trace = sample()
    assert abs(readers.idle_percent(ctx) - 60.0) < 1e-9
    assert readers.dispatch_ms(ctx) == 1.0


def test_uncosted_call_leaves_roofline_unread():
    q = torch.zeros(8, 2, 4, 16)                       # seq-major
    ctx = runner.Context("prefill", {}, "NVIDIA H100 80GB HBM3", 2.0,
                         [(2, 8)], [0.001], trace=sample(),
                         calls=calls.KernelCalls())
    rec = ctx.calls.raw["flash_attention"]
    rec.append((calls._flash(q, q, q), True))
    assert readers.roofline_percent(ctx, "flash_attention") > 0
    rec.append((calls._flash(q, q, q, window=4), True))   # not costed
    assert readers.roofline_percent(ctx, "flash_attention") is None
