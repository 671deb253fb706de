"""Public wrappers of the doorbell stage-copy kernel (DESIGN.md §13).

For a CUDA tensor each wrapper launches the hand-written Hopper kernel
(``csrc/doorbell.cu``) on the current stream, without synchronising, or
raises; for a CPU tensor it takes the plain version in :mod:`.ref`.
There is no fallback: a build or launch failure is an exception.

Each wrapper counts its launches in a plain integer attribute
(``stage_copy.launches``, ``stage_copy_rows.launches``,
``stage_copy_push.launches``, and by thread in ``.launches_by_thread``)
so that a run can show its main path went through the kernel.  The main path (a fused doorbell of CUDA tensors,
``core/progress/fabric.py::pack_payloads``) calls
:func:`stage_copy_rows`.  On the meta device each wrapper returns the
wire image's shape and runs nothing; every call records :func:`cost`
(bytes only: the payload read once, the wire image written once) with
the launches the card would make.
"""
from __future__ import annotations

import array
import ctypes
from functools import reduce
from itertools import repeat
from operator import attrgetter, or_

import torch

from ...core.packet_pool import SlotPool, pool_get_n
from .. import _build, cost_paused, count_launch, record_cost
from .ref import (stage_copy_push_ref, stage_copy_ref, stage_copy_rows_ref,
                  wire_rows)

#: rows one gather launch takes: the pointers ride in the kernel's
#: parameters (``kMaxRows`` in csrc/doorbell.cu)
ROWS_PER_LAUNCH = 256


#: the C entry points of csrc/doorbell.cu and their argument types
_ARGTYPES = {
    "repro_stage_copy": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_void_p],
    "repro_stage_copy_rows": [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_void_p],
}


def _bind(lib: ctypes.CDLL, name: str):
    """``lib``'s C entry ``name`` (a build of csrc/doorbell.cu) with its
    argument types set."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _kernel(name: str = "repro_stage_copy"):
    return _bind(_build.load("doorbell"), name)


def _check_payloads(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: payloads must be (k, e), got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def cost(read: int, written: int) -> tuple:
    """(flops, bytes) of a copy: no products; ``read`` payload bytes and
    ``written`` wire bytes."""
    return 0, read + written


def _launch(src: torch.Tensor, dst: torch.Tensor, ids, n_slots: int,
            rows: int, src_row_bytes: int, row_bytes: int, dst_stride: int,
            cast: bool) -> None:
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("stage_copy: tensors must be contiguous")
    if src.data_ptr() % src.element_size():
        raise ValueError("stage_copy: payloads are not aligned to their "
                         "element size")
    with torch.cuda.device(src.device):
        rc = _kernel()(src.data_ptr(), dst.data_ptr(),
                       None if ids is None else ids.data_ptr(), n_slots,
                       rows, src_row_bytes, row_bytes, dst_stride,
                       int(cast), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage_copy kernel launch failed: CUDA error "
                           f"{rc}")


def stage_copy(payloads: torch.Tensor, *, wire_bf16: bool = False
               ) -> torch.Tensor:
    """(k, e) payloads -> (k, row_bytes) packed uint8 wire image in one
    launch: the kernel applies the wire-dtype cast (f32 -> bf16 when
    ``wire_bf16``) as it copies.  The result is a fresh tensor."""
    _check_payloads(payloads, "stage_copy")
    cast, row_bytes = wire_rows(payloads, wire_bf16)
    k, e = payloads.shape
    if k * row_bytes:
        record_cost("stage_copy", *cost(
            k * e * payloads.element_size(), k * row_bytes),
            reads=(payloads,))
    if payloads.device.type == "cpu":
        with cost_paused():
            return stage_copy_ref(payloads, wire_bf16=wire_bf16)
    out = torch.empty((k, row_bytes), dtype=torch.uint8,
                      device=payloads.device)
    if out.numel() and payloads.device.type == "cuda":
        # source and wire image are both contiguous: one flat segment
        total = k * row_bytes
        _launch(payloads, out, None, 1, 1, k * e * payloads.element_size(),
                total, total, cast)
        count_launch(stage_copy)
    return out


#: what every row of a gather shares
_ROW_META = attrgetter("dtype", "shape", "device")


def uniform_rows(rows) -> bool:
    """Whether ``rows`` is one or more tensors of one dtype, shape and
    device: the rows :func:`stage_copy_rows` takes.  The maps run at C
    speed (a fused doorbell calls this once for each of its K rows)."""
    return (len(rows) > 0
            and all(map(isinstance, rows, repeat(torch.Tensor)))
            and len(set(map(_ROW_META, rows))) == 1)


def stage_copy_rows(rows, *, wire_bf16: bool = False,
                    uniform: bool = False) -> torch.Tensor:
    """K tensors of one dtype, shape and device -> the ``(K, row_bytes)``
    uint8 wire image of :func:`stage_copy` of them stacked, in one pass:
    the kernel reads each row at its own address (no ``torch.stack``
    first), one launch for each :data:`ROWS_PER_LAUNCH` rows.  A row that
    is not contiguous is made contiguous first.  The result is a fresh
    tensor.  ``uniform=True`` says the caller has already checked the
    rows with :func:`uniform_rows`, and skips that check."""
    if not (uniform or uniform_rows(rows)):
        raise ValueError(
            "stage_copy_rows: a doorbell needs one or more tensors of one "
            "dtype, shape and device, got " + ", ".join(sorted({
                f"{getattr(r, 'dtype', type(r).__name__)} "
                f"{tuple(getattr(r, 'shape', ()))} on "
                f"{getattr(r, 'device', None)}" for r in rows})))
    first = rows[0]
    k = len(rows)
    cast, row_bytes = wire_rows(first.reshape(1, -1), wire_bf16)
    if row_bytes:
        record_cost("stage_copy_rows", *cost(
            k * first.numel() * first.element_size(), k * row_bytes),
            launches=-(-k // ROWS_PER_LAUNCH), reads=rows)
    if first.device.type == "cpu":
        with cost_paused():
            return stage_copy_rows_ref(rows, wire_bf16=wire_bf16)
    if first.device.type not in ("cuda", "meta"):
        raise ValueError(f"stage_copy_rows: unsupported device "
                         f"{first.device}")
    out = torch.empty((k, row_bytes), dtype=torch.uint8, device=first.device)
    if not out.numel() or first.device.type == "meta":
        return out
    if not all(map(torch.Tensor.is_contiguous, rows)):
        rows = [r.contiguous() for r in rows]
    ptrs = list(map(torch.Tensor.data_ptr, rows))
    # the element size is a power of two: one OR finds any misaligned row
    if reduce(or_, ptrs) % first.element_size():
        raise ValueError("stage_copy_rows: a row is not aligned to its "
                         "element size")
    table = array.array("q", ptrs)      # the C side reads k pointers
    with torch.cuda.device(first.device):
        rc = _kernel("repro_stage_copy_rows")(
            table.buffer_info()[0], k, out.data_ptr(), row_bytes, int(cast),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage_copy_rows kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(stage_copy_rows, -(-k // ROWS_PER_LAUNCH))
    return out


def stage_copy_push(pool: SlotPool, buf: torch.Tensor, lane,
                    payloads: torch.Tensor, steal_seed, *,
                    wire_bf16: bool = False):
    """The fused stage-copy-push: pop up to k packet slots from the
    functional pool (tensor ops on the pool's device, no host sync) and
    stage the doorbell's rows straight into ``buf[ids]``, zero-padded to
    ``packet_bytes``, in one kernel launch.  ``buf`` is written in place
    (the reference returns an updated copy).  Returns ``(pool', buf,
    ids, got, status)`` with
    :func:`repro_torch.core.packet_pool.pool_get_copy_n`'s contract — on
    a short grab only the allocated prefix is written."""
    _check_payloads(payloads, "stage_copy_push")
    k, e = payloads.shape
    n_packets, packet_bytes = buf.shape
    cast, row_bytes = wire_rows(payloads, wire_bf16)
    if k and packet_bytes:
        record_cost("stage_copy_push", *cost(
            k * e * payloads.element_size(), k * packet_bytes),
            reads=(payloads,))
    if payloads.device.type == "cpu":
        with cost_paused():
            return stage_copy_push_ref(pool, buf, lane, payloads,
                                       steal_seed, wire_bf16=wire_bf16)
    for name, t in (("buf", buf), ("pool.slots", pool.slots),
                    ("pool.count", pool.count)):
        if t.device != payloads.device:
            raise ValueError(f"stage_copy_push: {name} is on {t.device}, "
                             f"payloads on {payloads.device}")
    if buf.dtype != torch.uint8 or pool.slots.dtype != torch.int32:
        raise ValueError("stage_copy_push: buf must be uint8 and the pool "
                         "int32")
    if row_bytes > packet_bytes:
        raise ValueError(f"pool_get_copy_n: payload rows of {row_bytes} "
                         f"bytes exceed packet_bytes={packet_bytes}")
    if cast and (packet_bytes % 2 or buf.data_ptr() % 2):
        raise ValueError("stage_copy_push: bf16 rows need 2-byte aligned "
                         "packets")
    pool, ids, got, status = pool_get_n(pool, lane, k, steal_seed)
    if k and packet_bytes and payloads.device.type == "cuda":
        _launch(payloads, buf, ids, n_packets, k,
                e * payloads.element_size(), row_bytes, packet_bytes, cast)
        count_launch(stage_copy_push)
    return pool, buf, ids, got, status


for _fn in (stage_copy, stage_copy_rows, stage_copy_push):
    _fn.launches = 0
    _fn.launches_by_thread = {}
