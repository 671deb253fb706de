"""Public wrapper of the SSM conv-stage kernel.

For CUDA tensors :func:`ssm_conv` launches the hand-written Hopper
kernel (``csrc/ssm_conv.cu``) once on the current stream, without
synchronising, or raises; for CPU tensors it takes the plain version in
:mod:`.ref`.  There is no fallback.  The kernel reads ``xs`` and
``dt_raw`` through their row stride, so the mixer hands it the column
views of its fused ``[z|x|dt]`` product as they are: each view's last
dim must be contiguous, its (time, batch) rows evenly spaced
(:func:`row_stride`) and ``xs``'s base, row stride and width multiples of
16 bytes (the kernel's loads and stores), or the call raises; nothing is
copied.
``ssm_conv.launches`` counts the launches, ``ssm_conv.launches_by_shape``
the same by ``(s, bs, ch, h)`` and ``ssm_conv.launches_by_thread`` by
thread.  When an input requires a gradient, the call records a backward:
the autograd of :func:`.ref.ssm_conv_ref`, recomputed from the saved
views and weights.  On the meta device it returns the outputs' shapes,
dtypes and strides and runs nothing; every call records :func:`cost`
(package docstring).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import (_build, apply, cost_paused, count_launch, grad_wanted, nbytes,
                plain_vjp, record_cost)
from .ref import ssm_conv_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the conv width the kernel is built for (every config's
#: ``ssm_conv_kernel``)
CONV_WIDTH = 4


def _kernel():
    fn = _build.load("ssm_conv").repro_ssm_conv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 +
                       [ctypes.c_int, ctypes.c_void_p])
    return fn


def cost(xs, dt_raw, conv_w, dt_bias) -> tuple:
    """(flops, bytes) of one call: no products (the kernel's few
    operations a value are not counted), the bytes of reading xs, dt_raw
    and the weights once and writing the activation (xs's dtype) and dt
    (float32) once."""
    return 0, (2 * nbytes(xs) + nbytes(dt_raw, conv_w, dt_bias)
               + 4 * dt_raw.numel())


def row_stride(t: torch.Tensor) -> int:
    """The element stride between successive rows of ``t`` (s, bs, c),
    row ``(time, batch)`` at ``time * bs + batch``: ``t``'s last dim
    contiguous and its rows evenly spaced, or raise."""
    s, bs, c = t.shape
    if c > 1 and t.stride(2) != 1:
        raise ValueError(f"ssm_conv: the last dim must have unit stride, "
                         f"got strides {t.stride()}")
    if s > 1 and bs > 1 and t.stride(0) != bs * t.stride(1):
        raise ValueError(f"ssm_conv: rows must be evenly spaced (stride(0) "
                         f"= bs * stride(1)), got strides {t.stride()} at "
                         f"shape {tuple(t.shape)}")
    return t.stride(1) if bs > 1 else t.stride(0) if s > 1 else c


def _check(xs, dt_raw, conv_w, dt_bias) -> Tuple[int, int]:
    """What a launch needs of the inputs but their device being CUDA;
    returns the row strides of xs and dt_raw."""
    if any(t.device != xs.device for t in (dt_raw, conv_w, dt_bias)):
        raise ValueError("ssm_conv: every tensor must be on one device")
    if xs.dtype not in _DTYPES or dt_raw.dtype != xs.dtype or \
            conv_w.dtype != xs.dtype or dt_bias.dtype != torch.float32:
        raise ValueError(f"ssm_conv: xs, dt_raw and conv_w must share "
                         f"float32 or bfloat16 and dt_bias be float32, got "
                         f"{xs.dtype}, {dt_raw.dtype}, {conv_w.dtype}, "
                         f"{dt_bias.dtype}")
    if xs.dim() != 3 or dt_raw.dim() != 3 or \
            dt_raw.shape[:2] != xs.shape[:2]:
        raise ValueError(f"ssm_conv: xs (s, bs, ch) and dt_raw (s, bs, h), "
                         f"got {tuple(xs.shape)} and {tuple(dt_raw.shape)}")
    ch, h = xs.shape[2], dt_raw.shape[2]
    if conv_w.shape != (CONV_WIDTH, ch) or dt_bias.shape != (h,):
        raise ValueError(f"ssm_conv: conv_w ({CONV_WIDTH}, {ch}) and dt_bias "
                         f"({h},), got {tuple(conv_w.shape)} and "
                         f"{tuple(dt_bias.shape)}")
    if not (conv_w.is_contiguous() and dt_bias.is_contiguous()):
        raise ValueError("ssm_conv: conv_w and dt_bias must be contiguous")
    x_row, dt_row = row_stride(xs), row_stride(dt_raw)
    es = xs.element_size()
    if xs.data_ptr() % 16 or x_row * es % 16 or ch * es % 16:
        raise ValueError(f"ssm_conv: xs's base, row stride and width must "
                         f"be multiples of 16 bytes, got offset "
                         f"{xs.data_ptr() % 16}, row {x_row * es} and width "
                         f"{ch * es} bytes")
    return x_row, dt_row


def _outputs(xs, dt_raw):
    s, bs, _ = xs.shape
    return (torch.empty(xs.shape, dtype=xs.dtype, device=xs.device),
            torch.empty((s, bs, dt_raw.shape[2]), dtype=torch.float32,
                        device=xs.device))


def _run(xs, dt_raw, conv_w, dt_bias):
    """The kernel launch, or on the meta device its outputs alone (after
    the launch's checks)."""
    if xs.device.type == "meta":
        _check(xs, dt_raw, conv_w, dt_bias)
        return _outputs(xs, dt_raw)
    return _launch(xs, dt_raw, conv_w, dt_bias)


def _launch(xs, dt_raw, conv_w, dt_bias):
    """One kernel launch on CUDA tensors, or raise."""
    if xs.device.type != "cuda":
        raise ValueError(f"ssm_conv: a launch needs CUDA tensors, got "
                         f"{xs.device}")
    x_row, dt_row = _check(xs, dt_raw, conv_w, dt_bias)
    y, dt = _outputs(xs, dt_raw)
    s, bs, ch = xs.shape
    h = dt_raw.shape[2]
    if s * bs == 0 or ch + h == 0:
        return y, dt
    with torch.cuda.device(xs.device):
        rc = _kernel()(xs.data_ptr(), dt_raw.data_ptr(), conv_w.data_ptr(),
                       dt_bias.data_ptr(), y.data_ptr(), dt.data_ptr(),
                       s, bs, ch, h, x_row, dt_row,
                       int(xs.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_conv kernel launch failed: CUDA error {rc}")
    count_launch(ssm_conv)
    by = ssm_conv.launches_by_shape
    by[s, bs, ch, h] = by.get((s, bs, ch, h), 0) + 1
    return y, dt


class _SsmConvFn(torch.autograd.Function):
    """The kernel forward; the backward of the plain version."""

    @staticmethod
    def forward(ctx, xs, dt_raw, conv_w, dt_bias):
        ctx.save_for_backward(xs, dt_raw, conv_w, dt_bias)
        return _run(xs, dt_raw, conv_w, dt_bias)

    @staticmethod
    def backward(ctx, g_act, g_dt):
        return tuple(plain_vjp(ssm_conv_ref, ctx.saved_tensors,
                               ctx.needs_input_grad, (g_act, g_dt)))


def ssm_conv(xs: torch.Tensor, dt_raw: torch.Tensor, conv_w: torch.Tensor,
             dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (s, bs, ch); dt_raw (s, bs, h); conv_w (K, ch); dt_bias (h,) ->
    (``silu(causal_conv(xs, conv_w))`` contiguous in xs's dtype,
    ``softplus(dt_raw + dt_bias)`` contiguous in float32).  The kernel
    takes the conv's products and sums in float32 in the plain version's
    order and rounds once to xs's dtype."""
    if xs.numel() or dt_raw.numel():
        record_cost("ssm_conv", *cost(xs, dt_raw, conv_w, dt_bias),
                    reads=(xs, dt_raw, conv_w, dt_bias))
    if xs.device.type == "cpu":
        with cost_paused():
            return ssm_conv_ref(xs, dt_raw, conv_w, dt_bias)
    if grad_wanted(xs, dt_raw, conv_w, dt_bias):
        return apply(_SsmConvFn, xs, dt_raw, conv_w, dt_bias)
    return _run(xs, dt_raw, conv_w, dt_bias)


ssm_conv.launches = 0
ssm_conv.launches_by_thread = {}
ssm_conv.launches_by_shape = {}
