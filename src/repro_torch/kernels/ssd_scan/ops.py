"""Public wrappers of the SSD-scan kernel.

For CUDA tensors :func:`ssd_scan_bhsp` (the kernel's layout) and
:func:`ssd_scan` (the model's seq-major layout) launch the hand-written
Hopper kernel (``csrc/ssd_scan.cu``) on the current stream, without
synchronising, or raise; for CPU tensors they take the plain recurrence
in :mod:`.ref`.  There is no fallback.  The kernel reads every tensor
through its strides, so the seq-major adapter hands it permuted views
and writes y straight into a seq-major tensor: no transposing copy on
either side.  ``ssd_scan_bhsp.launches`` counts the kernel launches of
both wrappers.

The kernel chooses its own chunk length (64, see the source); the
``chunk`` argument is the reference's tiling hint and changes only the
rounding of the result.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the largest state size the kernel's shared memory takes
MAX_N = 256


def _kernel():
    fn = _build.load("ssd_scan").repro_ssd_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6 +
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(x, dt, a_log, b, c, d_skip, h0) -> None:
    """Validate a CUDA call on the kernel's layout (views allowed)."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (dt, a_log, b, c, d_skip)) or \
            (h0 is not None and h0.device != dev):
        raise ValueError("ssd_scan: every tensor must be on one CUDA device")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, b, c must share float32 or "
                         f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32 or \
            d_skip.dtype != torch.float32 or \
            (h0 is not None and h0.dtype != torch.float32):
        raise ValueError("ssd_scan: dt, a_log, d_skip and h0 must be "
                         "float32")
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("ssd_scan: x (bs, h, s, p), dt (bs, h, s), b/c "
                         "(bs, g, s, n)")
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if dt.shape != (bs, h, s) or b.shape != (bs, g, s, n) or \
            c.shape != b.shape or a_log.shape != (h,) or \
            d_skip.shape != (h,):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a_log {tuple(a_log.shape)}, "
                         f"d_skip {tuple(d_skip.shape)} do not fit")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: heads {h} not a multiple of groups {g}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"ssd_scan: state size {n} outside 1..{MAX_N}")
    if h0 is not None and (h0.shape != (bs, h, n, p) or
                           not h0.is_contiguous()):
        raise ValueError(f"ssd_scan: h0 must be a contiguous "
                         f"({bs}, {h}, {n}, {p}) float32 tensor")
    if not (a_log.is_contiguous() and d_skip.is_contiguous()):
        raise ValueError("ssd_scan: a_log and d_skip must be contiguous")


def _launch(x, dt, a_log, b, c, d_skip, h0, y) -> torch.Tensor:
    """One kernel launch on (bs, h, s, p)-shaped views; writes ``y`` (a
    view of x's shape and dtype) and returns h_final."""
    _check(x, dt, a_log, b, c, d_skip, h0)
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    h_final = torch.empty((bs, h, n, p), dtype=torch.float32,
                          device=x.device)
    strides = (ctypes.c_int64 * 19)(*x.stride(), *dt.stride(), *b.stride(),
                                    *c.stride(), *y.stride())
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                       b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
                       None if h0 is None else h0.data_ptr(), y.data_ptr(),
                       h_final.data_ptr(), bs, h, s, p, g, n, strides,
                       int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_bhsp.launches += 1
    return h_final


def ssd_scan_bhsp(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
                  chunk: int = 128, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (bs, h, s, p); dt (bs, h, s) float32; b/c (bs, g, s, n); a_log/
    d_skip (h,) float32; h0 (bs, h, n, p) float32 or None -> (y (bs, h,
    s, p) in x.dtype, h_final (bs, h, n, p) float32)."""
    del chunk
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a_log, b, c, d_skip, h0=h0)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return y, _launch(x, dt, a_log, b, c, d_skip, h0, y)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 128, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The seq-major adapter (``repro/kernels/ssd_scan/ops.py:12``): x
    (s, bs, h, p); dt (s, bs, h); b/c (s, bs, g, n) -> (y (s, bs, h, p),
    h_final (bs, h, n, p)).  The reference's adapter returns y alone; the
    final state comes along here because the model's scan returns it."""
    del chunk
    xt, dtt = x.permute(1, 2, 0, 3), dt.permute(1, 2, 0)
    bt, ct = b.permute(1, 2, 0, 3), c.permute(1, 2, 0, 3)
    if x.device.type == "cpu":
        y, h_final = ssd_scan_ref(xt, dtt, a_log, bt, ct, d_skip, h0=h0)
        return y.permute(2, 0, 1, 3).contiguous(), h_final
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h_final = _launch(xt, dtt, a_log, bt, ct, d_skip, h0,
                      y.permute(1, 2, 0, 3))
    return y, h_final


ssd_scan_bhsp.launches = 0
