"""Public wrappers of the flash-attention kernel.

:func:`flash_attention_bhsd` works in the kernel's (b, h, s, dh) layout,
as the reference's ``flash_attention_tpu`` does; :func:`flash_attention`
is the seq-major adapter of ``repro/kernels/flash_attention/ops.py:24``
((s, b, h, dh) in and out).  For CUDA tensors one of the two hand-written
Hopper variants of ``csrc/flash_attention.cu`` runs on the current
stream, without synchronising, or the call raises; CPU tensors take the
plain version in :mod:`.ref`.  There is no fallback.  :func:`variant`
picks the variant from dtype and head dim: ``"tc"`` (wgmma + TMA on the
tensor cores, P rounded to bf16 for the second product) for bf16 whose
padded head dim is 64, 128 or 256, ``"simt"`` (float32 CUDA-core
products) for everything else.  Both wrappers launch through one
function, :func:`_attend`.  ``flash_attention_bhsd.launches`` counts
their kernel launches, ``flash_attention_bhsd.launches_by_variant`` the
same by variant (``.launches_by_thread`` by thread), and :func:`variant_of` tells which variant a call took.

The kernel is instantiated for head dims 16/32/64/128/256; any other dh up
to 256 is zero-padded to the next of them (zeros add nothing to q.k, and
the padded output columns are dropped) and the softmax scale stays
``1/sqrt(dh)`` of the true head dim.  On ``"tc"`` the kernel reads q, k
and v in place through their strides (the seq-major wrapper's views
too), and writes the output in place; a view that a TMA map cannot
address (off a 16-byte boundary) is copied first.  On ``"simt"`` the
operands and the output go through dense copies in the kernel layout.

When q, k or v requires a gradient, a CUDA call records a backward: the
autograd of the plain version of the variant that ran
(``flash_attention_ref(..., p_dtype=torch.bfloat16)`` for ``"tc"``, the
reference's arithmetic for ``"simt"``), recomputed from the saved q, k
and v; it launches no kernel.  On the meta device either wrapper
returns q's shape and runs nothing; every call records :func:`cost`
(package docstring).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import (_build, apply, cost_paused, count_launch, grad_wanted, nbytes,
                plain_vjp, record_cost)
from .ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: padded head dims of the tensor-core variant
TC_HEAD_DIMS = (64, 128, 256)
#: variant names, in the order of the launch counts
VARIANTS = ("simt", "tc")
#: TMA and the simt kernel's vector loads need 16-byte addresses
_ALIGN = 16
#: (q rows, keys) of a tile, by variant and padded head dim
#: (csrc/flash_attention.cu: tc::BM and Tc<DH>::BK; Tile<DH>)
TILES = {"tc": {64: (128, 128), 128: (128, 128), 256: (128, 64)},
         "simt": {16: (64, 64), 32: (64, 64), 64: (64, 64),
                  128: (64, 32), 256: (32, 32)}}


def _simt_kernel():
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


def _tc_kernel():
    fn = _build.load("flash_attention").repro_flash_attention_tc
    if fn.argtypes is None:
        geom = ctypes.POINTER(ctypes.c_int64)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, geom, ctypes.c_void_p, geom,
                       ctypes.c_void_p, geom, ctypes.c_void_p, geom,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_float, ctypes.c_void_p]
    return fn


def padded_head_dim(dh: int) -> int:
    """The instantiated head dim a call with head dim ``dh`` runs at."""
    return next(h for h in HEAD_DIMS if h >= dh)


def tma_geometry(t: torch.Tensor) -> Tuple[int, ...]:
    """The 4-D TMA tensor map over a (b, h, s, dh) view ``t``: its dims
    innermost first, ``(dh, s, h, b)``, then the byte strides of s, h
    and b.  s keeps a dimension of its own, so a tile that runs past s
    reads zeros, never the next head's rows.  A dimension of size 1 is
    never stepped along; it gets the stride of one row of dh.  Raises
    ``ValueError`` when TMA cannot address the view: dh not contiguous,
    or a stride or the base address off a 16-byte boundary."""
    b, h, s, dh = t.shape
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention: the head dim must be "
                         f"contiguous, got strides {tuple(t.stride())}")
    strides = tuple(t.stride(i) * es if t.shape[i] > 1 else dh * es
                    for i in (2, 1, 0))
    if t.data_ptr() % _ALIGN or any(x <= 0 or x % _ALIGN for x in strides):
        raise ValueError(f"flash_attention: a TMA map needs a 16-byte "
                         f"aligned base and strides, got {t.data_ptr()} "
                         f"and {strides} bytes")
    return (dh, s, h, b) + strides


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel variant a CUDA call takes: ``"tc"`` for bf16 q, k and v
    whose head dim pads to 64, 128 or 256, else ``"simt"``.  Layout plays
    no part: a view that a TMA map cannot address is copied first."""
    dh = q.shape[-1]
    if q.dtype == k.dtype == v.dtype == torch.bfloat16 and \
            0 < dh <= HEAD_DIMS[-1] and padded_head_dim(dh) in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (b, hq, sq, dh) and k, v "
                         f"(b, hkv, skv, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (hq % hkv must be 0)")
    if q.device.type not in ("cuda", "meta") or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device (or the meta device)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < dh <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head dim {dh} outside 1.."
                         f"{HEAD_DIMS[-1]}")
    if q.numel() and k.shape[2] == 0:
        raise ValueError("flash_attention: no keys")


def _pad(t: torch.Tensor, dk: int) -> torch.Tensor:
    return t if t.shape[-1] == dk else F.pad(t, (0, dk - t.shape[-1]))


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous and 16-byte aligned, else a fresh copy."""
    if t.is_contiguous() and t.data_ptr() % _ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` if a TMA map can address it, else a fresh dense copy."""
    try:
        tma_geometry(t)
    except ValueError:
        return _dense(t)
    return t


def _geom(vals) -> ctypes.Array:
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(kind: str, q, k, v, out, *, causal: bool, window: int,
            q_offset: int, scale: float) -> None:
    """One launch of variant ``kind`` on (b, h, s, dk) views; ``out`` (the
    same shape as q) receives the result.  simt needs all four contiguous
    and aligned."""
    b, hq, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "tc":
            rc = _tc_kernel()(q.data_ptr(), _geom(tma_geometry(q)),
                              k.data_ptr(), _geom(tma_geometry(k)),
                              v.data_ptr(), _geom(tma_geometry(v)),
                              out.data_ptr(), _geom(out.stride()[:3]),
                              int(causal), int(window), int(q_offset),
                              scale, stream)
        else:
            rc = _simt_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b, hq, hkv, sq, skv, dk,
                                int(q.dtype == torch.bfloat16), int(causal),
                                int(window), int(q_offset), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({kind}) launch failed: "
                           f"CUDA error {rc}")
    count_launch(flash_attention_bhsd)
    flash_attention_bhsd.launches_by_variant[kind] += 1


def _attend(q, k, v, out, *, causal: bool, window: int,
            q_offset: int) -> torch.Tensor:
    """Attention of the (b, hq, sq, dh) view ``q`` over the (b, hkv, skv,
    dh) views ``k`` and ``v``, written into ``out`` (a view of q's shape
    whose head dim is contiguous); returns ``out``.  The one launch site
    of both wrappers: check, pad, variant, launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: a launch needs CUDA tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    if q.numel() == 0:
        return out
    kind = variant(q, k, v)
    dh = q.shape[-1]
    dk = padded_head_dim(dh)
    q, k, v = (_pad(t, dk) for t in (q, k, v))
    q, k, v = (_tma_view(t) if kind == "tc" else _dense(t)
               for t in (q, k, v))
    direct = dk == dh and (kind == "tc" or out.is_contiguous())
    o = out if direct else torch.empty(q.shape, dtype=q.dtype,
                                       device=q.device)
    _launch(kind, q, k, v, o, causal=causal, window=window,
            q_offset=q_offset, scale=1.0 / math.sqrt(dh))
    if not direct:
        out.copy_(o[..., :dh])
    return out


def visited_pairs(sq: int, skv: int, bq: int, bk: int, *, causal: bool,
                  window: int, q_offset: int) -> int:
    """The (q, k) pairs of the tiles the kernel computes, partial tiles
    counted whole: each q tile of ``bq`` rows visits the ``bk``-key tiles
    that cover the union of its rows' visible ranges ``[q_pos - window +
    1, q_pos]`` (causal; ``[.., skv - 1]`` unmasked), or every key tile
    when one of its rows sees no key (csrc/flash_attention.cu's
    ``visible_lo`` / ``visible_hi``)."""
    def lo(p):
        return max(p - window + 1, 0) if window > 0 else 0

    def hi(p):
        return p if causal and p < skv - 1 else skv - 1
    n_kt = -(-skv // bk)
    total = 0
    for q0 in range(0, sq, bq):
        first, last = q_offset + q0, q_offset + min(q0 + bq, sq) - 1
        if window > 0 and last >= skv + window - 1:   # a row sees no key
            nt = n_kt
        else:
            nt = hi(last) // bk - lo(first) // bk + 1
        total += bq * nt * bk
    return total


def cost(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int,
         q_offset: int, seq_major: bool) -> tuple:
    """(flops, bytes) of one call.  FLOPs: ``4 b hq dk`` (two products of
    ``2 dk`` a pair, ``dk`` the padded head dim the kernel runs at) times
    :func:`visited_pairs` at the variant's tiles: the masked tiles the
    kernel skips are not counted, partial tiles are counted whole.
    Bytes: q, k and v read once, the output written once."""
    if seq_major:
        sq, b, hq, dh = q.shape
        skv = k.shape[0]
    else:
        b, hq, sq, dh = q.shape
        skv = k.shape[2]
    dk = padded_head_dim(dh) if 0 < dh <= HEAD_DIMS[-1] else dh
    kind = variant(q, k, k)
    bq, bk = TILES[kind].get(dk, (64, 64))
    pairs = visited_pairs(sq, skv, bq, bk, causal=causal, window=window,
                          q_offset=q_offset)
    return 4 * b * hq * dk * pairs, nbytes(q, k, k, q)


def _record(q, k, v, causal, window, q_offset, seq_major) -> None:
    if q.numel() and k.numel():
        record_cost("flash_attention", *cost(
            q, k, causal=causal, window=window, q_offset=q_offset,
            seq_major=seq_major), reads=(q, k, v))


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q (b, hq, sq, dh); k/v (b, hkv, skv, dh) -> (b, hq, sq, dh) in
    q.dtype.  ``window`` > 0 limits key j to ``j > q_pos - window``;
    ``q_offset`` is the global position of q row 0."""
    _record(q, k, v, causal, window, q_offset, False)
    if q.device.type == "cpu":
        with cost_paused():
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)
    if grad_wanted(q, k, v):
        return apply(_FlashFn, q, k, v, causal, window, q_offset, False)
    return _bhsd_call(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)


def _meta_scratch(q, k, v) -> None:
    """On the meta device, the padded copies a call whose head dim is not
    instantiated makes (q, k, v and the output, at the padded dh)."""
    dh = q.shape[-1]
    if 0 < dh <= HEAD_DIMS[-1] and padded_head_dim(dh) != dh:
        dk = padded_head_dim(dh)
        [t.new_empty(t.shape[:-1] + (dk,)) for t in (q, k, v, q)]


def _bhsd_call(q, k, v, *, causal, window, q_offset):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        _check(q, k, v)
        _meta_scratch(q, k, v)
        return out
    return _attend(q, k, v, out, causal=causal, window=window,
                   q_offset=q_offset)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Seq-major API: q (sq, b, hq, dh); k/v (skv, b, hkv, dh) ->
    (sq, b, hq, dh), contiguous.  On ``"tc"`` the kernel reads q, k, v
    and writes the output in place through their strides (but a padded
    head dim); on ``"simt"`` the operands and the output are copied
    through the kernel layout."""
    _record(q, k, v, causal, window, q_offset, True)
    if q.device.type == "cpu":
        with cost_paused():
            out = flash_attention_ref(*(t.permute(1, 2, 0, 3).contiguous()
                                        for t in (q, k, v)),
                                      causal=causal, window=window,
                                      q_offset=q_offset)
        return out.permute(2, 0, 1, 3)
    if grad_wanted(q, k, v):
        return apply(_FlashFn, q, k, v, causal, window, q_offset, True)
    return _seq_call(q, k, v, causal=causal, window=window,
                     q_offset=q_offset)


def _seq_call(q, k, v, *, causal, window, q_offset):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        _check(*(t.permute(1, 2, 0, 3) for t in (q, k, v)))
        _meta_scratch(q, k, v)
        return out
    _attend(*(t.permute(1, 2, 0, 3) for t in (q, k, v, out)),
            causal=causal, window=window, q_offset=q_offset)
    return out


class _FlashFn(torch.autograd.Function):
    """The kernel forward (either layout); the backward of the plain
    version of the variant that ran."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, seq_major):
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.seq_major = seq_major
        # the variant rule reads dtype and head dim only: either layout
        ctx.p_dtype = (torch.bfloat16 if variant(q, k, v) == "tc"
                       else None)
        ctx.save_for_backward(q, k, v)
        call = _seq_call if seq_major else _bhsd_call
        return call(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, go):
        def plain(q, k, v):
            if ctx.seq_major:
                q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
            o = flash_attention_ref(q, k, v, p_dtype=ctx.p_dtype, **ctx.args)
            return o.permute(2, 0, 1, 3) if ctx.seq_major else o
        grads = plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:3],
                          (go,))
        return (*grads, None, None, None, None)


def variant_of(call):
    """Run ``call`` (one call of a wrapper above) and return (its result,
    the variant it launched); raises unless exactly one variant
    launched."""
    before = dict(flash_attention_bhsd.launches_by_variant)
    result = call()
    ran = [k for k, n in flash_attention_bhsd.launches_by_variant.items()
           if n != before[k]]
    if len(ran) != 1:
        raise AssertionError(f"flash_attention: variants {ran} launched in "
                             "one call")
    return result, ran[0]


flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_thread = {}
flash_attention_bhsd.launches_by_variant = dict.fromkeys(VARIANTS, 0)
