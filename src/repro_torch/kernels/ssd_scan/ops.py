"""Public wrappers of the SSD-scan kernel.

For CUDA tensors :func:`ssd_scan_bhsp` (the kernel's layout) and
:func:`ssd_scan` (the model's seq-major layout) launch one of the two
hand-written Hopper variants of ``csrc/ssd_scan.cu`` on the current
stream, without synchronising, or raise; for CPU tensors they take the
plain recurrence in :mod:`.ref`.  There is no fallback.
:func:`variant` picks the variant from dtype and shape: ``"tc"`` (the
chunk-parallel form on the tensor cores, three launches a call, chunk
:data:`TC_CHUNK`) for bf16 whose head dim P and state size N are
multiples of 16 up to 128 and 256, ``"simt"`` (one launch, float32
CUDA-core products, chunk 64) for everything else.  Both read every
tensor through its strides, so the seq-major adapter hands the kernel
permuted views and writes y straight into a seq-major tensor: no
transposing copy on either side.  "tc" reads the rows of x, B and C with
16-byte ``cp.async``: a view whose rows are not contiguous and 16-byte
aligned (:func:`rows_aligned`) is copied first and stays on "tc".
``ssd_scan_bhsp.launches`` counts the wrapper calls that launched a
variant, ``ssd_scan_bhsp.launches_by_variant`` the same by variant and
``ssd_scan_bhsp.launches_by_thread`` by thread.

The kernel chooses its own chunk length; the ``chunk`` argument is the
reference's tiling hint and changes only the rounding of the result.

When x, dt, a_log, b, c, d_skip or h0 requires a gradient, a CUDA call
records a backward: the autograd of the plain version of the variant
that ran (:func:`.ref.ssd_scan_tc_ref` for ``"tc"``, the per-step
:func:`.ref.ssd_scan_ref` for ``"simt"``), recomputed from the saved
inputs, for y and the final state alike.  On the meta device either
wrapper returns y and the float32 final state ``(bs, h, n, p)`` (and
allocates the "tc" scratch there) and runs nothing; every call records
:func:`cost` (package docstring).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import (_build, apply, cost_paused, count_launch, grad_wanted, nbytes,
                plain_vjp, record_cost)
from .ref import ssd_scan_ref, ssd_scan_tc_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the largest state size the kernel's shared memory takes
MAX_N = 256
#: variant names, in the order of the launch counts
VARIANTS = ("simt", "tc")
#: the tensor-core variant's chunk length (csrc/ssd_scan.cu, tc::kL)
TC_CHUNK = 128
#: the CUDA-core variant's chunk length (csrc/ssd_scan.cu, kL) and the
#: state columns one of its blocks owns (each block recomputes C.B^T)
SIMT_CHUNK, SIMT_COLS = 64, 32
#: the largest head dim and state size the tensor-core variant takes
TC_MAX_P, TC_MAX_N = 128, 256
#: cp.async moves 16 bytes from a 16-byte address
_ALIGN = 16


def _simt_kernel():
    fn = _build.load("ssd_scan").repro_ssd_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6 +
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return fn


def _tc_kernel():
    fn = _build.load("ssd_scan").repro_ssd_scan_tc
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int64] * 7 +
                       [ctypes.c_void_p, ctypes.c_void_p])
    return fn


def variant(x: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel variant a CUDA call on x (bs, h, s, p) and b (bs, g, s,
    n) takes: ``"tc"`` for bf16 with p and n multiples of 16, p <= 128
    and n <= 256, else ``"simt"``.  Layout plays no part: a view whose
    rows ``cp.async`` cannot read is copied first."""
    p, n = x.shape[-1], b.shape[-1]
    if x.dtype == b.dtype == torch.bfloat16 and 0 < p <= TC_MAX_P and \
            p % 16 == 0 and 0 < n <= TC_MAX_N and n % 16 == 0:
        return "tc"
    return "simt"


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether the tensor-core variant reads the view ``t`` in place: its
    last dim contiguous, its base address and the byte stride of every
    other dim longer than 1 multiples of 16."""
    es = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % _ALIGN == 0 and all(
        t.stride(i) * es % _ALIGN == 0 for i in range(t.dim() - 1)
        if t.shape[i] > 1)


def _tc_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` if :func:`rows_aligned`, else a fresh contiguous copy."""
    return t if rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


def tc_scratch_bytes(bs: int, h: int, s: int, p: int, g: int,
                     n: int) -> int:
    """Bytes of scratch a tensor-core call allocates: the chunk states
    (bs, h, chunks, n, p) in float32 and the incoming states H_in in bf16
    (the same shape), the shared C.B^T (bs, g, chunks, TC_CHUNK,
    TC_CHUNK) and each chunk's decay sum (bs, h, chunks) in float32."""
    nc = -(-s // TC_CHUNK)
    return nc * (6 * bs * h * n * p + 4 * bs * g * TC_CHUNK ** 2 +
                 4 * bs * h)


def cost(x, dt, a_log, b, c, d_skip, h0, *, seq_major: bool) -> tuple:
    """(flops, bytes) of one call: the chunked algorithm's products at the
    variant's chunk L (:data:`TC_CHUNK` on "tc", :data:`SIMT_CHUNK` on
    "simt"), a ragged last chunk counted whole and every product over its
    whole L x L tile (the kernel skips tiles above the diagonal, which are
    counted): a chunk's ``C Bᵀ`` (``2 L² n``, once a group on "tc", once
    a block of :data:`SIMT_COLS` state columns of a head on "simt"), and
    for each head its state ``Bᵀ (w x)`` and ``C H_in`` (``2 L n p``
    each) and ``M x`` (``2 L² p``).  Bytes: every input read once, y and
    the final state written once (the "tc" scratch not counted)."""
    if seq_major:
        s, bs, h, p = x.shape
    else:
        bs, h, s, p = x.shape
    g, n = (b.shape[2] if seq_major else b.shape[1]), b.shape[3]
    tc = variant(x, b) == "tc"
    L = TC_CHUNK if tc else SIMT_CHUNK
    nc = -(-s // L)
    cb = g if tc else h * -(-p // SIMT_COLS)
    flops = 2 * bs * nc * (cb * L * L * n + h * (2 * L * n * p + L * L * p))
    moved = nbytes(x, dt, a_log, b, c, d_skip, h0, x) + 4 * bs * h * n * p
    return flops, moved


def _record(x, dt, a_log, b, c, d_skip, h0, seq_major) -> None:
    if x.numel():
        record_cost("ssd_scan", *cost(x, dt, a_log, b, c, d_skip, h0,
                                      seq_major=seq_major),
                    reads=(x, dt, a_log, b, c, d_skip, h0))


def _meta(x, b) -> torch.Tensor:
    """On the meta device: the final state, and the "tc" scratch of
    :func:`tc_scratch_bytes` (allocated and dropped, as a call does)."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    h_final = torch.empty((bs, h, n, p), dtype=torch.float32,
                          device=x.device)
    if variant(x, b) == "tc":
        nc = -(-s // TC_CHUNK)
        f32 = dict(dtype=torch.float32, device=x.device)
        [torch.empty((bs, h, nc, n, p), **f32),
         torch.empty((bs, h, nc, n, p), dtype=torch.bfloat16,
                     device=x.device),
         torch.empty((bs, g, nc, TC_CHUNK, TC_CHUNK), **f32),
         torch.empty((bs, h, nc), **f32)]
    return h_final


def _strides(*ts) -> ctypes.Array:
    """The tensors' element strides, outermost first, a dim of size 1 at
    stride 0 (never stepped along, so any stride reads the same)."""
    vals = [st if size > 1 else 0 for t in ts
            for st, size in zip(t.stride(), t.shape)]
    return (ctypes.c_int64 * len(vals))(*vals)


def _check(x, dt, a_log, b, c, d_skip, h0) -> None:
    """Validate a CUDA (or meta) call on the kernel's layout (views
    allowed)."""
    dev = x.device
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in
                                               (dt, a_log, b, c, d_skip)) \
            or (h0 is not None and h0.device != dev):
        raise ValueError("ssd_scan: every tensor must be on one CUDA device "
                         "(or the meta device)")
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
    """One call of the variant :func:`variant` picks, on (bs, h, s,
    p)-shaped views; writes ``y`` (x's shape and dtype, a fresh
    allocation or a permuted view of one) and returns h_final.  The one
    launch site of both wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: a launch needs CUDA tensors, got "
                         f"{x.device}")
    _check(x, dt, a_log, b, c, d_skip, h0)
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    kind = variant(x, b)
    h_final = torch.empty((bs, h, n, p), dtype=torch.float32,
                          device=x.device)
    h0_ptr = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "tc":
            x, b, c = (_tc_view(t) for t in (x, b, c))
            nc = -(-s // TC_CHUNK)
            f32 = dict(dtype=torch.float32, device=x.device)
            states = torch.empty((bs, h, nc, n, p), **f32)
            h_in = torch.empty((bs, h, nc, n, p), dtype=torch.bfloat16,
                               device=x.device)
            cbt = torch.empty((bs, g, nc, TC_CHUNK, TC_CHUNK), **f32)
            decay = torch.empty((bs, h, nc), **f32)
            rc = _tc_kernel()(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), d_skip.data_ptr(), h0_ptr, y.data_ptr(),
                h_final.data_ptr(), states.data_ptr(), h_in.data_ptr(),
                cbt.data_ptr(), decay.data_ptr(), bs, h, s, p, g, n,
                TC_CHUNK,
                _strides(x, dt, b, c, y), stream)
        else:
            rc = _simt_kernel()(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), d_skip.data_ptr(), h0_ptr, y.data_ptr(),
                h_final.data_ptr(), bs, h, s, p, g, n,
                _strides(x, dt, b, c, y), int(x.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel ({kind}) launch failed: CUDA "
                           f"error {rc}")
    count_launch(ssd_scan_bhsp)
    ssd_scan_bhsp.launches_by_variant[kind] += 1
    return h_final


def ssd_scan_bhsp(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
                  chunk: int = 128, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (bs, h, s, p); dt (bs, h, s) float32; b/c (bs, g, s, n); a_log/
    d_skip (h,) float32; h0 (bs, h, n, p) float32 or None -> (y (bs, h,
    s, p) in x.dtype, h_final (bs, h, n, p) float32)."""
    del chunk
    _record(x, dt, a_log, b, c, d_skip, h0, False)
    if x.device.type == "cpu":
        with cost_paused():
            return ssd_scan_ref(x, dt, a_log, b, c, d_skip, h0=h0)
    if grad_wanted(x, dt, a_log, b, c, d_skip, h0):
        return apply(_SsdScanFn, x, dt, a_log, b, c, d_skip, h0, False)
    return _bhsp_call(x, dt, a_log, b, c, d_skip, h0)


def _bhsp_call(x, dt, a_log, b, c, d_skip, h0):
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        _check(x, dt, a_log, b, c, d_skip, h0)
        return y, _meta(x, b)
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
    _record(x, dt, a_log, b, c, d_skip, h0, True)
    if x.device.type == "cpu":
        xt, dtt, bt, ct = _seq_major(x, dt, b, c)
        with cost_paused():
            y, h_final = ssd_scan_ref(xt, dtt, a_log, bt, ct, d_skip,
                                      h0=h0)
            return y.permute(2, 0, 1, 3).contiguous(), h_final
    if grad_wanted(x, dt, a_log, b, c, d_skip, h0):
        return apply(_SsdScanFn, x, dt, a_log, b, c, d_skip, h0, True)
    return _seq_call(x, dt, a_log, b, c, d_skip, h0)


def _seq_major(x, dt, b, c):
    """The kernel-layout views of seq-major x, dt, b and c."""
    return (x.permute(1, 2, 0, 3), dt.permute(1, 2, 0), b.permute(1, 2, 0, 3),
            c.permute(1, 2, 0, 3))


def _seq_call(x, dt, a_log, b, c, d_skip, h0):
    xt, dtt, bt, ct = _seq_major(x, dt, b, c)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        _check(xt, dtt, a_log, bt, ct, d_skip, h0)
        return y, _meta(xt, bt)
    h_final = _launch(xt, dtt, a_log, bt, ct, d_skip, h0,
                      y.permute(1, 2, 0, 3))
    return y, h_final


class _SsdScanFn(torch.autograd.Function):
    """The kernel forward (either layout); the backward of the plain
    version of the variant that ran, for y and the final state."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, h0, seq_major):
        ctx.seq_major = seq_major
        # the variant rule reads dtype and the last dims: either layout
        ctx.plain = (ssd_scan_tc_ref if variant(x, b) == "tc"
                     else ssd_scan_ref)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, h0)
        call = _seq_call if seq_major else _bhsp_call
        y, h_final = call(x, dt, a_log, b, c, d_skip, h0)
        return y, h_final

    @staticmethod
    def backward(ctx, gy, gh):
        def plain(x, dt, a_log, b, c, d_skip, h0):
            if ctx.seq_major:
                x, dt, b, c = _seq_major(x, dt, b, c)
            y, h_final = ctx.plain(x, dt, a_log, b, c, d_skip, h0=h0)
            return (y.permute(2, 0, 1, 3) if ctx.seq_major else y), h_final
        grads = plain_vjp(plain, ctx.saved_tensors,
                          ctx.needs_input_grad[:7], (gy, gh))
        return (*grads, None)


def variant_of(call):
    """Run ``call`` (one call of a wrapper above) and return (its result,
    the variant it launched); raises unless exactly one variant
    launched."""
    before = dict(ssd_scan_bhsp.launches_by_variant)
    result = call()
    ran = [k for k, n in ssd_scan_bhsp.launches_by_variant.items()
           if n != before[k]]
    if len(ran) != 1:
        raise AssertionError(f"ssd_scan: variants {ran} launched in one "
                             "call")
    return result, ran[0]


ssd_scan_bhsp.launches = 0
ssd_scan_bhsp.launches_by_thread = {}
ssd_scan_bhsp.launches_by_variant = dict.fromkeys(VARIANTS, 0)
