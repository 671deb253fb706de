"""Public wrapper of the MoE grouped-matmul kernel.

For CUDA tensors :func:`moe_gmm` launches one of the two hand-written
Hopper variants of ``csrc/moe_gmm.cu`` on the current stream, without
synchronising, or raises; for CPU tensors it takes the plain version in
:mod:`.ref`.  There is no fallback.  :func:`variant` picks the variant
from dtype and shape: ``"tc"`` (the tensor cores, h rounded to bf16)
for bf16 whose d and f are multiples of 8 with 16-byte-aligned tensors,
``"simt"`` (float32 CUDA-core products, h in float32) for everything
else.  Either runs as two launches inside one C call (the first product
with the activation into a scratch ``h`` that this wrapper allocates,
then the second product).  ``moe_gmm.launches`` counts wrapper calls
that launched the kernel, ``moe_gmm.launches_by_variant`` the same by
variant and ``moe_gmm.launches_by_thread`` by thread.

When x, w1 or w2 requires a gradient, a CUDA call records a backward: the
autograd of the plain version of the variant that ran (``moe_gmm_ref``
with h rounded once to bf16 after the float32 activation for ``"tc"``, h
in float32 for ``"simt"``), recomputed from the saved operands.  On the
meta device it returns the ``(E, C, d)`` output (and allocates the
scratch ``h`` there) after the launch's checks and runs nothing; every
call records :func:`cost` (package docstring).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import (_build, apply, cost_paused, count_launch, grad_wanted, nbytes,
                plain_vjp, record_cost)
from .ref import ACTS, moe_gmm_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: activation codes of the C interface
_ACT = {a: i for i, a in enumerate(ACTS)}
#: variant codes of the C interface
VARIANTS = ("simt", "tc")


def _kernel():
    fn = _build.load("moe_gmm").repro_moe_gmm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(x, w1, w2, act, rows) -> int:
    """Validate a CUDA (or meta) call; returns f (the expert FFN
    width)."""
    if act not in _ACT:
        raise ValueError(f"moe_gmm: act must be one of {ACTS}, got {act!r}")
    if x.device.type not in ("cuda", "meta") or w1.device != x.device or \
            w2.device != x.device:
        raise ValueError("moe_gmm: x, w1, w2 must be on one CUDA device "
                         "(or the meta device)")
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"moe_gmm: x, w1, w2 must share float32 or "
                         f"bfloat16, got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError("moe_gmm: x (E, C, d), w1 (E, d, m·f), w2 "
                         "(E, f, d)")
    e, _, d = x.shape
    f = w2.shape[1]
    mult = 2 if act in ("swiglu", "geglu") else 1
    if w1.shape != (e, d, mult * f) or w2.shape != (e, f, d):
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not "
                         f"fit (E, C, d), (E, d, {mult}·f), (E, f, d)")
    if f % 8:
        raise ValueError(f"moe_gmm: f must be a multiple of 8, got {f}")
    if not (x.is_contiguous() and w1.is_contiguous() and
            w2.is_contiguous()):
        raise ValueError("moe_gmm: x, w1, w2 must be contiguous")
    if rows is not None and (rows.device != x.device or
                             rows.dtype != torch.int32 or
                             rows.shape != (e,) or
                             not rows.is_contiguous()):
        raise ValueError(f"moe_gmm: rows must be a contiguous int32 ({e},) "
                         f"tensor on {x.device}")
    return f


def variant(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> str:
    """The kernel variant a CUDA call takes: ``"tc"`` for bf16 with d and
    f multiples of 8 (16-byte rows, which ``cp.async`` needs) and
    16-byte-aligned tensors, else ``"simt"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w1, w2))
    return "tc" if _tc_dtype(x, w2) and aligned else "simt"


def _tc_dtype(x: torch.Tensor, w2: torch.Tensor) -> bool:
    """bf16 with d and f multiples of 8: the dtype and shape half of the
    variant rule."""
    return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and \
        w2.shape[1] % 8 == 0


def moe_gmm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
            act: str = "swiglu", block_c: int = 128,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, d); w1 (E, d, m·f); w2 (E, f, d) -> (E, C, d) in x.dtype:
    ``act(x[e] @ w1[e]) @ w2[e]``.  ``rows`` (optional, int32 (E,) on x's
    device) gives each expert's filled rows: rows at or past ``rows[e]``
    come out zero, and an expert with none reads no weight.  The kernel
    reads it itself, with no host sync.  ``block_c`` is the reference's
    TPU tiling hint; the CUDA kernel picks its own tile from C."""
    del block_c
    if x.numel():
        record_cost("moe_gmm", *cost(x, w1, w2, act),
                    reads=(x, w1, w2, rows))
    if x.device.type == "cpu":
        with cost_paused():
            return moe_gmm_ref(x, w1, w2, act=act, rows=rows)
    if grad_wanted(x, w1, w2):
        return apply(_MoeGmmFn, x, w1, w2, act, rows)
    return _run(x, w1, w2, act, rows)


def cost(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
         act: str) -> tuple:
    """(flops, bytes) of one call.  FLOPs: ``2 E C d f`` a product, three
    products for a gated activation (swiglu, geglu: ``w1`` holds gate
    and up) and two otherwise, over all ``C`` capacity rows: the data
    decides which rows ``rows`` lets the card skip, so the count does not
    follow it, and a meta count equals a card count.  Bytes: x, w1 and w2
    read once, the output written once (the scratch ``h`` not counted)."""
    e, c, d = x.shape
    f = w2.shape[1]
    mult = 3 if act in ("swiglu", "geglu") else 2
    return 2 * e * c * d * f * mult, nbytes(x, w1, w2, x)


def _run(x, w1, w2, act, rows):
    """The kernel call, or on the meta device its output and scratch."""
    if x.device.type != "meta":
        return _launch(x, w1, w2, act, rows)
    _check(x, w1, w2, act, rows)
    e, c, _ = x.shape
    torch.empty((e, c, w2.shape[1]), device=x.device,
                dtype=torch.bfloat16 if _tc_dtype(x, w2) else torch.float32)
    return torch.empty_like(x)


class _MoeGmmFn(torch.autograd.Function):
    """The kernel forward; the backward of the plain version of the
    variant that ran."""

    @staticmethod
    def forward(ctx, x, w1, w2, act, rows):
        ctx.act = act
        ctx.h_dtype = (torch.bfloat16 if variant(x, w1, w2) == "tc"
                       else None)
        ctx.save_for_backward(x, w1, w2, rows)
        return _run(x, w1, w2, act, rows)

    @staticmethod
    def backward(ctx, go):
        x, w1, w2, rows = ctx.saved_tensors
        grads = plain_vjp(
            lambda x_, w1_, w2_: moe_gmm_ref(x_, w1_, w2_, act=ctx.act,
                                             rows=rows,
                                             h_dtype=ctx.h_dtype),
            (x, w1, w2), ctx.needs_input_grad[:3], (go,))
        return (*grads, None, None)


def _launch(x, w1, w2, act, rows) -> torch.Tensor:
    """One call of the variant :func:`variant` picks (two launches in one
    C call), or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: a launch needs CUDA tensors, got "
                         f"{x.device}")
    f = _check(x, w1, w2, act, rows)
    e, c, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    kind = variant(x, w1, w2)
    h = torch.empty((e, c, f), device=x.device,
                    dtype=torch.bfloat16 if kind == "tc" else torch.float32)
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                       h.data_ptr(), out.data_ptr(),
                       None if rows is None else rows.data_ptr(), e, c, d,
                       f, _ACT[act], int(x.dtype == torch.bfloat16),
                       VARIANTS.index(kind),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel ({kind}) launch failed: CUDA "
                           f"error {rc}")
    count_launch(moe_gmm)
    moe_gmm.launches_by_variant[kind] += 1
    return out


moe_gmm.launches = 0
moe_gmm.launches_by_thread = {}
moe_gmm.launches_by_variant = dict.fromkeys(VARIANTS, 0)
