"""Public wrappers of the doorbell stage-copy kernel (DESIGN.md §13).

For a CUDA tensor each wrapper launches the hand-written Hopper kernel
(``csrc/doorbell.cu``) on the current stream, without synchronising, or
raises; for a CPU tensor it takes the plain version in :mod:`.ref`.
There is no fallback: a build or launch failure is an exception.

Each wrapper counts its launches in a plain integer attribute
(``stage_copy.launches``, ``stage_copy_push.launches``) so that a run can
show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.packet_pool import SlotPool, pool_get_n
from .. import _build
from .ref import stage_copy_push_ref, stage_copy_ref, wire_rows

#: scatter rows ride gridDim.y
_MAX_ROWS = 65535


def _kernel():
    lib = _build.load("doorbell")
    fn = lib.repro_stage_copy
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
    return fn


def _check_payloads(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: payloads must be (k, e), got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


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
    if payloads.device.type == "cpu":
        return stage_copy_ref(payloads, wire_bf16=wire_bf16)
    cast, row_bytes = wire_rows(payloads, wire_bf16)
    k, e = payloads.shape
    out = torch.empty((k, row_bytes), dtype=torch.uint8,
                      device=payloads.device)
    if out.numel():
        # source and wire image are both contiguous: one flat segment
        total = k * row_bytes
        _launch(payloads, out, None, 1, 1, k * e * payloads.element_size(),
                total, total, cast)
        stage_copy.launches += 1
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
    if payloads.device.type == "cpu":
        return stage_copy_push_ref(pool, buf, lane, payloads, steal_seed,
                                   wire_bf16=wire_bf16)
    k, e = payloads.shape
    n_packets, packet_bytes = buf.shape
    cast, row_bytes = wire_rows(payloads, wire_bf16)
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
    if k > _MAX_ROWS:
        raise ValueError(f"stage_copy_push: at most {_MAX_ROWS} rows a "
                         f"doorbell, got {k}")
    if cast and (packet_bytes % 2 or buf.data_ptr() % 2):
        raise ValueError("stage_copy_push: bf16 rows need 2-byte aligned "
                         "packets")
    pool, ids, got, status = pool_get_n(pool, lane, k, steal_seed)
    if k and packet_bytes:
        _launch(payloads, buf, ids, n_packets, k,
                e * payloads.element_size(), row_bytes, packet_bytes, cast)
        stage_copy_push.launches += 1
    return pool, buf, ids, got, status


stage_copy.launches = 0
stage_copy_push.launches = 0
