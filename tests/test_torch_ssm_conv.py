"""The SSM conv-stage kernel's wrapper (``repro_torch.kernels.ssm_conv``).

On the CPU the wrapper is its plain version, which is the mixer's stage
as it was written before the kernel: the causal conv as the reference's
shifted sum, SiLU in float32, the dt softplus.  Here:

* the wrapper equals that composition (``models/ssm.py``'s
  ``_causal_conv``, ``F.silu``, ``softplus_dt``) bit for bit, on column
  views of a fused ``[z|x|dt]`` product in mamba2-370m's layout (2048 of
  4160 columns, dt 32) and hymba-1.5b's (3200 of 6464, dt 50), s in
  {1, 2, 3, 4, 11} (K = 4: s < K - 1 too), float32 and bf16;
* gradients through the wrapper, and through the CUDA route's
  ``autograd.Function`` with the plain forward in the kernel's place,
  equal plain autograd's;
* the meta dispatch gives the kernel's outputs (shapes, dtypes,
  contiguous strides); one ``record_cost`` a call, 0 FLOPs, the stated
  bytes; a view the kernel cannot read raises.

The tests marked ``gpu`` hold the kernel against its plain version on
the card and skip here.  This file imports no JAX, so on the card's
machine ``python -m pytest -q -m gpu tests/test_torch_ssm_conv.py`` runs
them.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_conv import ops as conv_ops
from repro_torch.kernels.ssm_conv import row_stride, ssm_conv, ssm_conv_ref
from repro_torch.kernels.ssm_conv.ref import causal_conv
from repro_torch.launch.costs import count_costs
from repro_torch.models.ssm import _causal_conv, softplus_dt

#: (name, d_inner, fused row width, dt heads): the mixer's fused
#: [z | x | dt] product, padded to a multiple of 64 columns
LAYOUTS = [("mamba2", 2048, 4160, 32), ("hymba", 3200, 6464, 50)]
K = 4


def _fused(s, bs, di, row, h, dtype, device="cpu", seed=0):
    """(zxdt, xs, dt_raw, conv_w, dt_bias): xs and dt_raw the column
    views of a fresh (s, bs, row) product, as the mixer cuts them."""
    g = torch.Generator().manual_seed(seed)
    zxdt = torch.randn(s, bs, row, generator=g).to(dtype).to(device)
    xs = zxdt[..., di:2 * di]
    dt_raw = zxdt[..., 2 * di:2 * di + h]
    conv_w = (torch.randn(K, di, generator=g) * 0.5).to(dtype).to(device)
    dt_bias = (torch.randn(h, generator=g) - 2).to(device)
    return zxdt, xs, dt_raw, conv_w, dt_bias


def _today(xs, dt_raw, conv_w, dt_bias):
    """The mixer's stage as it was written before the kernel."""
    y = _causal_conv(xs, conv_w)
    return F.silu(y.float()).to(xs.dtype), softplus_dt(dt_raw, dt_bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 11])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: t[0])
def test_plain_equals_the_stage_it_replaces(layout, s, dtype):
    _, di, row, h = layout
    _, xs, dt_raw, conv_w, dt_bias = _fused(s, 2, di, row, h, dtype)
    assert not xs.is_contiguous() and row_stride(xs) == row
    y, dt = ssm_conv(xs, dt_raw, conv_w, dt_bias)
    want_y, want_dt = _today(xs, dt_raw, conv_w, dt_bias)
    assert y.dtype == dtype and dt.dtype == torch.float32
    assert y.is_contiguous() and dt.is_contiguous()
    assert torch.equal(y, want_y) and torch.equal(dt, want_dt)


def _grads(fn, zxdt, conv_w, dt_bias, di, h, seed=3):
    """Gradients of fn's two outputs, pulled back from fixed cotangents,
    with respect to the fused product, conv_w and dt_bias."""
    leaves = [t.detach().clone().requires_grad_() for t in
              (zxdt, conv_w, dt_bias)]
    z, w, b = leaves
    y, dt = fn(z[..., di:2 * di], z[..., 2 * di:2 * di + h], w, b)
    g = torch.Generator().manual_seed(seed)
    cts = [torch.randn(t.shape, generator=g).to(t.dtype).to(t.device)
           for t in (y, dt)]
    return torch.autograd.grad((y, dt), leaves, cts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_gradients_equal_plain_autograd(dtype, monkeypatch):
    """Through the wrapper (the CPU route) and through the CUDA route's
    ``autograd.Function`` with the plain forward in the kernel's place:
    the gradients of the product, conv_w and dt_bias equal plain
    autograd's of the stage it replaces."""
    di, row, h = 64, 192, 8
    zxdt, _, _, conv_w, dt_bias = _fused(7, 3, di, row, h, dtype)
    want = _grads(_today, zxdt, conv_w, dt_bias, di, h)
    got = _grads(ssm_conv, zxdt, conv_w, dt_bias, di, h)
    monkeypatch.setattr(conv_ops, "_run", ssm_conv_ref)
    fn = _grads(conv_ops._SsmConvFn.apply, zxdt, conv_w, dt_bias, di, h)
    for a, b, c in zip(got, fn, want):
        assert a.dtype == c.dtype
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, c, rtol=0, atol=0)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: t[0])
def test_meta_gives_the_kernels_outputs(layout):
    """On meta views of the fused product: the kernel's outputs (xs's
    shape and dtype, dt float32, both contiguous), and a recorded
    backward whose gradients have the inputs' shapes."""
    _, di, row, h = layout
    zxdt, xs, dt_raw, conv_w, dt_bias = _fused(5, 2, di, row, h,
                                               torch.bfloat16, "meta")
    y, dt = ssm_conv(xs, dt_raw, conv_w, dt_bias)
    assert y.is_meta and dt.is_meta
    assert (y.shape, y.dtype, y.stride()) == (
        xs.shape, xs.dtype, (2 * di, di, 1))
    assert (dt.shape, dt.dtype, dt.stride()) == (
        dt_raw.shape, torch.float32, (2 * h, h, 1))
    leaves = [t.requires_grad_() for t in (zxdt, conv_w, dt_bias)]
    z, w, b = leaves
    y, dt = ssm_conv(z[..., di:2 * di], z[..., 2 * di:2 * di + h], w, b)
    grads = torch.autograd.grad((y.float().sum() + dt.sum()), leaves)
    assert [g.shape for g in grads] == [t.shape for t in leaves]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_one_cost_record_a_call(device):
    """One ``record_cost`` a call: 0 FLOPs, the bytes of reading xs,
    dt_raw, conv_w and dt_bias once and writing the activation and the
    float32 dt once; on the CPU the plain version adds no count."""
    s, bs, di, row, h = 9, 2, 2048, 4160, 32
    _, xs, dt_raw, conv_w, dt_bias = _fused(s, bs, di, row, h,
                                            torch.bfloat16, device)
    _, c = count_costs(ssm_conv, xs, dt_raw, conv_w, dt_bias)
    nbytes = (2 * s * bs * di * 2 + s * bs * h * 2 + K * di * 2 + h * 4
              + s * bs * h * 4)
    assert c.kernels == {"ssm_conv": {"launches": 1, "flops": 0.0,
                                      "bytes": float(nbytes)}}
    assert c.flops == 0


def test_views_the_kernel_cannot_read_raise():
    """A non-unit last stride, rows not evenly spaced, a base off 16
    bytes, a conv width the kernel is not built for: each raises on meta
    (where a CUDA call would launch), and a CPU tensor never reaches a
    launch."""
    zxdt, xs, dt_raw, conv_w, dt_bias = _fused(6, 2, 64, 192, 8,
                                               torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="unit stride"):
        ssm_conv(zxdt[..., 0:128:2], dt_raw, conv_w, dt_bias)
    with pytest.raises(ValueError, match="evenly spaced"):
        ssm_conv(xs.transpose(0, 1).contiguous().transpose(0, 1), dt_raw,
                 conv_w, dt_bias)
    with pytest.raises(ValueError, match="16 bytes"):
        ssm_conv(zxdt[..., 1:65], dt_raw, conv_w, dt_bias)
    with pytest.raises(ValueError, match="conv_w"):
        ssm_conv(xs, dt_raw, conv_w.repeat(2, 1), dt_bias)
    _, xs, dt_raw, conv_w, dt_bias = _fused(6, 2, 64, 192, 8,
                                            torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        conv_ops._launch(xs, dt_raw, conv_w, dt_bias)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernel "
                    "on the card")
    return torch.device("cuda")


#: (name, bs, s, d_inner, row, dt heads): mamba2-370m's prefill shapes
#: of the benchmark's sweep and its training shape, hymba-1.5b's width,
#: sequences shorter than the kernel (s < K - 1) and ragged walks
CARD_SHAPES = [
    ("mamba2_32x512", 32, 512, 2048, 4160, 32),
    ("mamba2_16x1024", 16, 1024, 2048, 4160, 32),
    ("mamba2_8x2048", 8, 2048, 2048, 4160, 32),
    ("mamba2_4x4096", 4, 4096, 2048, 4160, 32),
    ("mamba2_train_32x2048", 32, 2048, 2048, 4160, 32),
    ("hymba_4x2048", 4, 2048, 3200, 6464, 50),
    ("short_s1", 3, 1, 2048, 4160, 32),
    ("short_s2", 3, 2, 3200, 6464, 50),
    ("ragged_s37", 2, 37, 2048, 4160, 32),
    ("ragged_s133", 3, 133, 3200, 6464, 50),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda t: t[0])
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    """The kernel against the float32 plain version on the same values:
    float32 within a few ulps of the output (the conv is the plain
    version's float32 arithmetic in its order; only another build's
    ``expf`` could round apart), bf16 within one bf16 ulp (that float32
    result rounded once: an ulp of float32 can tip the rounding); against
    the plain version in the call's own dtype (bf16: within the plain
    version's own roundings, 2K - 1 bf16 unit roundoffs, 2^-8, of the
    conv's absolute sum, times SiLU's slope of at most 1.1, plus an ulp
    of the output); dt within a few float32 ulps (softplus as torch
    computes it).  One launch a call."""
    _, bs, s, di, row, h = shape
    _, xs, dt_raw, conv_w, dt_bias = _fused(s, bs, di, row, h, dtype, cuda)
    before = ssm_conv.launches
    y, dt = ssm_conv(xs, dt_raw, conv_w, dt_bias)
    assert ssm_conv.launches == before + 1
    torch.cuda.synchronize()
    y32, dt32 = ssm_conv_ref(xs.float(), dt_raw.float(), conv_w.float(),
                             dt_bias)
    rel = 4e-7 if dtype == torch.float32 else 2 ** -7
    err = (y.float() - y32).abs()
    assert bool((err <= rel * y32.abs() + 1e-30).all()), float(err.max())
    assert bool((((dt - dt32).abs()) <= 4e-7 * dt32.abs() + 1e-30).all())
    plain_y, _ = ssm_conv_ref(xs, dt_raw, conv_w, dt_bias)
    if dtype == torch.bfloat16:
        absum = causal_conv(xs.float().abs(), conv_w.float().abs())
        limit = 1.1 * (2 * K - 1) * 2 ** -8 * absum + 2 ** -7 * y32.abs()
        assert bool(((y.float() - plain_y.float()).abs() <= limit).all())
    else:
        assert bool(((y - plain_y).abs() <= 4e-7 * y32.abs() + 1e-30)
                    .all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_autograd_function_gradients_on_card(cuda, dtype):
    """On CUDA tensors that require a gradient the wrapper runs the
    kernel inside its ``autograd.Function``; the gradients of the fused
    product, conv_w and dt_bias equal plain autograd's of the plain
    version (the backward is that autograd, recomputed)."""
    di, row, h = 2048, 4160, 32
    zxdt, _, _, conv_w, dt_bias = _fused(64, 4, di, row, h, dtype, cuda)
    before = ssm_conv.launches
    got = _grads(ssm_conv, zxdt, conv_w, dt_bias, di, h)
    assert ssm_conv.launches == before + 1
    want = _grads(ssm_conv_ref, zxdt, conv_w, dt_bias, di, h)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_is_the_plain_float32_arithmetic_on_card(cuda):
    """float32: the kernel's outputs are the plain version's bit for bit
    (the conv in its order, SiLU's exp and correctly rounded division,
    softplus as torch computes them), on 33M values spread over [-100,
    100] and on the edges of SiLU's division: zeros of both signs,
    subnormals, values where ``1 + expf(-x)`` passes 2^64 (x < -44.4) and
    where ``expf(-x)`` overflows (x < -88.7), large values, infinities
    and NaN (rows holding them make later rows NaN through ``0 * inf``,
    in both)."""
    g = torch.Generator().manual_seed(7)
    di, row, h = 2048, 4160, 32
    z = torch.randn(4096, 4, row, generator=g) * 20
    edges = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1.0, -1.0,
                          -44.3, -44.4, -44.5, -60.0, -88.7, -88.8, -100.0,
                          -1e30, 30.0, 1e30, 3.4e38, -3.4e38, float("inf"),
                          float("-inf"), float("nan")])
    z[:, :, di:di + edges.numel()] = edges
    z[:, :, 2 * di:2 * di + edges.numel()] = edges
    z = z.to(cuda)
    w = torch.randn(K, di, generator=g)
    w[:, :edges.numel()] = torch.tensor([0.0, 0.0, 0.0, 1.0])[:, None]
    w, b = w.to(cuda), torch.randn(h, generator=g).to(cuda)
    xs, dt_raw = z[..., di:2 * di], z[..., 2 * di:2 * di + h]
    got = ssm_conv(xs, dt_raw, w, b)
    want = ssm_conv_ref(xs, dt_raw, w, b)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0, equal_nan=True)
        m = ~torch.isnan(e)
        assert torch.equal(torch.signbit(a[m]), torch.signbit(e[m]))
