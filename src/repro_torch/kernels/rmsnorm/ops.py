"""Public wrapper of the RMSNorm kernel.

For a CUDA tensor :func:`rmsnorm` launches the hand-written Hopper
kernel (``csrc/rmsnorm.cu``) on the current stream, without
synchronising, or raises; for a CPU tensor it takes the plain version in
:mod:`.ref`.  There is no fallback.  ``rmsnorm.launches`` counts the
kernel launches, ``rmsnorm.launches_by_shape`` the same launches by
``(rows, d)`` and ``rmsnorm.launches_by_thread`` by thread.  When x or
w requires a gradient, the call records a backward: the autograd of
:func:`.ref.rmsnorm_ref`, recomputed from the saved x and w.  On the meta
device it returns ``x``'s shape and runs nothing; every call records
:func:`cost` (package docstring).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import (_build, apply, cost_paused, count_launch, grad_wanted, nbytes,
                plain_vjp, record_cost)
from .ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: weight kinds of the C interface
_W_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}


#: the C entry point of csrc/rmsnorm.cu and its argument types
_ARGTYPES = {
    "repro_rmsnorm": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def _bind(lib: ctypes.CDLL, name: str = "repro_rmsnorm"):
    """``lib``'s C entry ``name`` (a build of csrc/rmsnorm.cu) with its
    argument types set."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _kernel():
    return _bind(_build.load("rmsnorm"))


def cost(x: torch.Tensor, w: Optional[torch.Tensor]) -> tuple:
    """(flops, bytes) of one call: no products (the kernel's few
    operations a value are not counted), the bytes of reading x and w
    and writing the output once."""
    return 0, 2 * nbytes(x) + nbytes(w)


def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor] = None, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d); w (d,) or None -> x's shape and dtype.  Statistics in
    float32: ``x * rsqrt(mean(x²) + eps) [* w]``."""
    if x.numel():
        record_cost("rmsnorm", *cost(x, w), reads=(x, w))
    if x.device.type == "cpu":
        with cost_paused():
            return rmsnorm_ref(x, w, eps=eps)
    if grad_wanted(x, w):
        return apply(_RmsNormFn, x, w, eps)
    return _run(x, w, eps)


def _run(x, w, eps):
    """The kernel launch, or on the meta device its output alone (after
    the launch's checks)."""
    if x.device.type == "meta":
        _check(x, w)
        return torch.empty_like(x)
    return _launch(x, w, eps)


def _check(x: torch.Tensor, w: Optional[torch.Tensor]) -> None:
    """What a launch needs of x and w but their device."""
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    if w is not None:
        if w.shape != (d,) or w.dtype not in _DTYPES:
            raise ValueError(f"rmsnorm: w must be ({d},) float32 or "
                             f"bfloat16, got {tuple(w.shape)} {w.dtype}")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("rmsnorm: w must be contiguous on x's device")


class _RmsNormFn(torch.autograd.Function):
    """The kernel forward; the backward of the plain version."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _run(x, w, eps)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = plain_vjp(lambda x_, w_: rmsnorm_ref(x_, w_, eps=ctx.eps),
                           (x, w), ctx.needs_input_grad[:2], (gy,))
        return gx, gw, None


def _launch(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
            ) -> torch.Tensor:
    """One kernel launch on CUDA tensors, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _check(x, w)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows and d:
        with torch.cuda.device(x.device):
            rc = _kernel()(x.data_ptr(),
                           None if w is None else w.data_ptr(),
                           out.data_ptr(), rows, d,
                           int(x.dtype == torch.bfloat16),
                           _W_KIND[None if w is None else w.dtype], eps,
                           torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                               f"{rc}")
        count_launch(rmsnorm)
        by = rmsnorm.launches_by_shape
        by[rows, d] = by.get((rows, d), 0) + 1
    return out


rmsnorm.launches = 0
rmsnorm.launches_by_thread = {}
rmsnorm.launches_by_shape = {}
