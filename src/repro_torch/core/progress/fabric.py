"""Fabric-facing state: pending ops, registered memory, payload staging.

The wire types (:class:`WireMsg`, :class:`PackedBurst`, :data:`WireKind`)
and the fabric implementation itself now live in
:mod:`repro_torch.core.transport` (DESIGN.md §14) — the simulated in-process
fabric is the ``sim`` backend of the pluggable :class:`Transport` ABC,
and ``shm``/``socket`` backends carry the same messages between OS
processes.  This module keeps the *progress-engine side* of the story —
source-side pending state, memory registration (§3.3.1), and the payload
staging helpers for doorbell fusion (§4.3) — and re-exports the moved
names so every existing import keeps working.

Payloads are numpy arrays, bytes, or tensors.  Where a buffer lives
decides the path: numpy and bytes take the reference's host path byte
for byte, and tensors stay tensors on their own device — a fused
doorbell of CUDA tensors is staged on the card by the doorbell kernel
(:func:`repro_torch.kernels.doorbell.stage_copy_rows`).  Sizes and split
points stay host ``int64`` numpy, computed from shapes, so no per-burst
step reads the card back.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..completion import CompletionObject
from ..post import CommKind
from ..status import FatalError
from ..transport import (FABRIC_ATTRS, PACKED_KINDS, PackedBurst, WireKind,
                         WireMsg, msg_weight)
from ..transport.sim import Fabric
from ..transport.wire import f32_to_bf16_bits, to_card, to_host

__all__ = [
    "FABRIC_ATTRS", "PACKED_KINDS", "PackedBurst", "WireKind", "WireMsg",
    "msg_weight", "Fabric", "PendingOp", "PendingBurst", "next_op_id",
    "MemoryRegion", "as_bytes_view", "payload_to_bytes",
    "payloads_to_bytes", "pack_payloads", "check_device", "copy_prefix",
]


@dataclasses.dataclass
class PendingOp:
    """Source-side state for a posted (not yet complete) operation."""
    kind: CommKind
    buf: Any
    size: int
    tag: int
    peer: int
    local_comp: Optional[CompletionObject]
    packet: int = -1               # bufcopy: packet id to return to the pool
    lane: int = 0
    user_context: Any = None


@dataclasses.dataclass
class PendingBurst:
    """Source-side state for ONE fused bufcopy doorbell: K packets and K
    deferred completions under a single pending-op id.  The progress
    sweep returns all packets with one ``put_n`` and signals the
    completions in row (FIFO) order, matching the per-op scalar path.
    ``comps`` is either one completion object shared by every row or a
    per-row list aligned with ``tags``."""
    kind: CommKind
    peer: int
    lane: int
    packets: List[int]
    tags: List[int]
    comps: Any = None


_op_ids = itertools.count()


def next_op_id() -> int:
    return next(_op_ids)


# ---------------------------------------------------------------------------
# memory registration (paper §3.3.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemoryRegion:
    """Registered memory: mandatory for remote buffers (RMA targets)."""
    rid: int
    buf: Any                       # 1-D uint8 view (ndarray or tensor)


def check_device(t: torch.Tensor, device: Optional[torch.device]) -> None:
    """A CUDA payload must live on the runtime's card: one posted on a
    runtime bound to the CPU, or on another card, is refused (a CPU
    tensor is a host buffer and is accepted anywhere)."""
    if device is not None and t.is_cuda and t.device != device:
        raise FatalError(f"payload on {t.device} posted on a runtime bound "
                         f"to {device}")


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise FatalError("tensor payloads and buffers must be contiguous")
    return t


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    return _contiguous(t).reshape(-1).view(torch.uint8)


def as_bytes_view(buf: Any):
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    if isinstance(buf, (bytearray, memoryview)):
        return np.frombuffer(buf, dtype=np.uint8)
    if isinstance(buf, torch.Tensor):
        return _flat_bytes(buf)
    raise FatalError(f"cannot register memory of type {type(buf)}")


def copy_prefix(view, payload, n: int) -> None:
    """``view[:n] = payload[:n]`` for byte views that are ndarrays or
    tensors.  Like to like copies in place (tensor to tensor on the
    device); when the buffer and the payload live in different places
    the bytes cross in one copy, counted by :func:`to_card` /
    :func:`to_host`."""
    if isinstance(view, torch.Tensor):
        src = (payload[:n] if isinstance(payload, torch.Tensor)
               else to_card(payload[:n], view.device))
        view[:n].copy_(src)
    elif isinstance(payload, torch.Tensor):
        view[:n] = to_host(payload[:n])
    else:
        view[:n] = payload[:n]


def payload_to_bytes(buf: Any, device: Optional[torch.device] = None):
    """Materialize a payload (or buffer list, §3.3.1) as bytes: an
    ndarray for host payloads, a uint8 tensor on the payload's own
    device for a tensor."""
    if isinstance(buf, (list, tuple)):
        parts = [payload_to_bytes(b, device) for b in buf]
        if parts and all(isinstance(p, torch.Tensor) for p in parts):
            return torch.cat(parts)
        parts = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p
                 for p in parts]
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.uint8))
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8).copy()
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(buf), dtype=np.uint8)
    if isinstance(buf, torch.Tensor):
        check_device(buf, device)
        return _flat_bytes(buf).clone()
    raise FatalError(f"unsupported payload type {type(buf)}")


def payloads_to_bytes(bufs: Sequence[Any],
                      device: Optional[torch.device] = None) -> List[Any]:
    """Stage a burst's payloads — ONE stacked copy instead of K.

    When every payload is an ``np.ndarray`` sharing one dtype and shape
    (the windowed-benchmark common case), the whole burst is materialized
    with a single ``np.stack(bufs)`` — one vectorized memcpy, no
    per-element Python conversion at all — and each message gets a row
    view of the stacked array (rows are independent snapshots, so source
    buffers stay reusable exactly like :func:`payload_to_bytes`).
    Same-sized arrays of *mixed* dtype stack through per-item flat byte
    views (still one burst-sized copy, byte-exact per payload); ragged
    or non-array bursts fall back to per-payload copies.  Tensors of one
    dtype and shape stack the same way with ``torch.stack``."""
    if len(bufs) <= 1:
        return [payload_to_bytes(b, device) for b in bufs]
    first = bufs[0]
    if isinstance(first, np.ndarray):
        dt, shape, nbytes = first.dtype, first.shape, first.nbytes
        if all(isinstance(b, np.ndarray) and b.dtype == dt
               and b.shape == shape for b in bufs):
            stacked = np.stack(bufs)                  # the ONE copy
            return list(stacked.reshape(len(bufs), -1).view(np.uint8))
        if all(isinstance(b, np.ndarray) and b.nbytes == nbytes
               for b in bufs):
            # mixed dtype/shape but same byte size: np.stack reads
            # per-item flat byte views and performs the single copy
            stacked = np.stack([
                b if b.dtype == np.uint8 and b.ndim == 1
                else b.reshape(-1).view(np.uint8)
                for b in bufs])
            return list(stacked)                      # row views, no copy
    elif isinstance(first, torch.Tensor):
        check_device(first, device)
        if _uniform_rows(bufs):
            stacked = torch.stack(bufs)               # the ONE copy
            return list(stacked.reshape(len(bufs), -1).view(torch.uint8))
    return [payload_to_bytes(b, device) for b in bufs]


def _uniform_rows(bufs: Sequence[Any]) -> bool:
    """Whether ``bufs`` are tensors of one dtype, shape and device
    (imported here: the kernels package imports this module's package)."""
    from ...kernels.doorbell import uniform_rows
    return uniform_rows(bufs)


def pack_payloads(bufs: Sequence[Any], wire_bf16: bool = False,
                  device: Optional[torch.device] = None
                  ) -> Tuple[Any, np.ndarray, Optional[str]]:
    """Stage a fused doorbell: ONE dtype-normalized copy builds the
    packed wire image (DESIGN.md §13).  Returns ``(data, sizes,
    wire_dtype)`` for a :class:`PackedBurst`: ``data`` is ``(K,
    row_bytes)`` uint8 (an ndarray for host payloads, a tensor on the
    payloads' device for tensors), ``sizes[i]`` the delivered byte size
    of row ``i`` (host ``int64``).

    Fast paths, in order:

    * every element is the SAME array object (a repeated payload — the
      message-rate hot loop): one row snapshot, broadcast K ways with no
      further copying;
    * uniform dtype+shape: one ``np.stack`` for ndarrays; for tensors
      the doorbell stage-copy gathers the K rows from their own addresses
      in one pass (the kernel on the card, its plain version on the CPU);
    * anything else: per-row byte staging into a zero-padded matrix.

    ``wire_bf16`` compresses float32 bursts to bf16 on the wire at zero
    marginal cost (the cast IS the staging copy); it applies only on the
    uniform-f32 fast paths — mixed bursts ship uncompressed — and
    ``sizes`` always reports the *delivered* (f32) byte size.  ``device``
    is the runtime's device: a CUDA payload elsewhere raises."""
    k = len(bufs)
    first = bufs[0]
    if isinstance(first, torch.Tensor):
        check_device(first, device)
        sizes = np.full(k, first.nbytes, np.int64)
        bf16 = wire_bf16 and first.dtype == torch.float32
        if len(set(map(id, bufs))) == 1:
            row = _stage_rows([_contiguous(first)], bf16, uniform=True)
            return row.expand(k, -1), sizes, "bf16" if bf16 else None
        if _uniform_rows(bufs):
            return (_stage_rows(bufs, bf16, uniform=True), sizes,
                    "bf16" if bf16 else None)
    elif isinstance(first, np.ndarray):
        # identity probe runs at C speed: 64-element bursts are common
        # and a Python-level ``all(b is first ...)`` genexpr shows up in
        # the message-rate profile
        if len(set(map(id, bufs))) == 1:
            flat = first.reshape(-1)
            if wire_bf16 and first.dtype == np.float32:
                row = f32_to_bf16_bits(flat).view(np.uint8)
                wire_dtype = "bf16"
            else:
                row = flat.view(np.uint8).copy()      # the one snapshot
                wire_dtype = None
            data = np.broadcast_to(row, (k, row.size))
            return data, np.full(k, first.nbytes, np.int64), wire_dtype
        dt, shape = first.dtype, first.shape
        if all(isinstance(b, np.ndarray) and b.dtype == dt
               and b.shape == shape for b in bufs):
            flat = np.stack(bufs).reshape(k, -1)      # the ONE copy
            if wire_bf16 and dt == np.float32:
                return (f32_to_bf16_bits(flat).view(np.uint8),
                        np.full(k, first.nbytes, np.int64), "bf16")
            return (flat.view(np.uint8),
                    np.full(k, first.nbytes, np.int64), None)
    rows = [payload_to_bytes(b, device) for b in bufs]
    sizes = np.fromiter((r.nbytes for r in rows), np.int64, k)
    width = int(sizes.max(initial=0))
    on = next((r.device for r in rows if isinstance(r, torch.Tensor)), None)
    if on is None:
        data = np.zeros((k, width), np.uint8)
    else:
        # a ragged burst holding tensors is staged on their device;
        # host rows among them are copied over explicitly
        data = torch.zeros((k, width), dtype=torch.uint8, device=on)
        rows = [r if isinstance(r, torch.Tensor)
                else torch.tensor(r, device=on) for r in rows]
    for i, r in enumerate(rows):
        data[i, :r.nbytes] = r
    return data, sizes, None


def _stage_rows(bufs: Sequence[torch.Tensor], bf16: bool,
                uniform: bool = False) -> torch.Tensor:
    """One doorbell stage-copy of K tensors of one dtype and shape into
    ``(K, row_bytes)`` uint8 wire rows, each row read where it lies: the
    kernel for CUDA tensors, its plain version for CPU ones."""
    from ...kernels.doorbell import stage_copy_rows
    return stage_copy_rows(bufs, wire_bf16=bf16, uniform=uniform)
