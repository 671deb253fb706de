"""Public wrappers of the flash-attention kernel.

:func:`flash_attention_bhsd` works in the kernel's (b, h, s, dh) layout,
as the reference's ``flash_attention_tpu`` does; :func:`flash_attention`
is the seq-major adapter of ``repro/kernels/flash_attention/ops.py:24``
((s, b, h, dh) in and out).  For CUDA tensors the hand-written Hopper
kernel (``csrc/flash_attention.cu``) runs on the current stream, without
synchronising, or the call raises; CPU tensors take the plain version in
:mod:`.ref`.  There is no fallback.  ``flash_attention_bhsd.launches``
counts the kernel launches.

The kernel is instantiated for head dims 16/32/64/128/256; any other dh up
to 256 is zero-padded to the next of them (zeros add nothing to q.k, and
the padded output columns are dropped) and the softmax scale stays
``1/sqrt(dh)`` of the true head dim.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build
from .ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the kernel reads 16-byte vectors of q, k and v
_ALIGN = 16


def _kernel():
    fn = _build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_void_p]
    return fn


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (b, hq, sq, dh) and k, v "
                         f"(b, hkv, skv, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (hq % hkv must be 0)")
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < dh <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head dim {dh} outside 1.."
                         f"{HEAD_DIMS[-1]}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             "and 16-byte aligned")


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q (b, hq, sq, dh); k/v (b, hkv, skv, dh) -> (b, hq, sq, dh) in
    q.dtype.  ``window`` > 0 limits key j to ``j > q_pos - window``;
    ``q_offset`` is the global position of q row 0."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    _check(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0:
        return torch.empty_like(q)
    if skv == 0:
        raise ValueError("flash_attention: no keys")
    dk = next(h for h in HEAD_DIMS if h >= dh)
    if dk != dh:                       # zero-pad to an instantiated dh
        q, k, v = (F.pad(t, (0, dk - dh)) for t in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, hq, hkv, sq, skv, dk,
                       int(q.dtype == torch.bfloat16), int(causal),
                       int(window), int(q_offset), 1.0 / math.sqrt(dh),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bhsd.launches += 1
    return out if dk == dh else out[..., :dh].contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Seq-major API: q (sq, b, hq, dh); k/v (skv, b, hkv, dh) ->
    (sq, b, hq, dh)."""
    qt = q.permute(1, 2, 0, 3).contiguous()
    kt = k.permute(1, 2, 0, 3).contiguous()
    vt = v.permute(1, 2, 0, 3).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                               q_offset=q_offset)
    return out.permute(2, 0, 1, 3)


flash_attention_bhsd.launches = 0
