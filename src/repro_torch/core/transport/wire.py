"""The wire format — messages every transport backend carries.

:class:`WireMsg` is the unit of transfer between ranks: eager payloads,
rendezvous handshakes (RTS/CTS/RDMA), and RMA put/get all ride it.  A
:class:`PackedBurst` is one fused doorbell's wire image (DESIGN.md §13):
K eager payload rows packed into one 2-D byte matrix so the whole burst
weighs ``count`` messages but pays descriptor costs once.

These types used to live in ``repro_torch.core.progress.fabric`` next to the
simulated fabric; the transport subsystem (DESIGN.md §14) hoists them
here so the shm and socket backends — and the stable binary codec in
:mod:`.codec` — share one definition.  ``progress.fabric`` re-exports
everything for compatibility.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from ..matching import MatchingPolicy


class WireKind:
    EAGER_SEND = "eager_send"      # send-recv eager payload
    EAGER_AM = "eager_am"          # active-message eager payload
    # fused doorbells (DESIGN.md §13): ONE descriptor carries a whole
    # burst's payloads as a packed 2-D byte array
    EAGER_PACKED_SEND = "eager_packed_send"
    EAGER_PACKED_AM = "eager_packed_am"
    RTS = "rts"                    # rendezvous request-to-send
    CTS = "cts"                    # rendezvous clear-to-send
    RDMA_PAYLOAD = "rdma_payload"  # rendezvous data movement (zero-copy)
    PUT = "put"                    # RMA put (optionally with signal)
    GET_REQ = "get_req"            # RMA get request
    GET_RESP = "get_resp"          # RMA get response
    ACK = "ack"                    # reliability cumulative ack (§16)


#: packed wire kinds — each such message weighs ``payload.count`` toward
#: the stream depth bound (and every message-counting telemetry)
PACKED_KINDS = frozenset((WireKind.EAGER_PACKED_SEND,
                          WireKind.EAGER_PACKED_AM))


@dataclasses.dataclass
class WireMsg:
    kind: str
    src: int
    dst: int
    tag: int = 0
    payload: Any = None
    size: int = 0
    rcomp: Optional[int] = None
    matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG
    # rendezvous bookkeeping
    op_id: int = -1                # source-side pending-op id
    remote_buf: Any = None         # (region_id, offset) for RMA
    device_index: int = 0          # which device stream this rides
    ready_at: float = 0.0          # wire-latency model: drainable after this
    # reliability protocol (DESIGN.md §16): per-(dst, device) stream
    # sequence number for retransmit/dedup; -1 = untracked control
    # traffic (rides the reliable connection, never chaos-faulted)
    seq: int = -1
    epoch: int = 0                 # bumps on elastic shrink / peer restart


def msg_weight(msg: WireMsg) -> int:
    """How many messages ``msg`` weighs toward depth accounting — a
    packed doorbell counts its row count, everything else counts 1."""
    if msg.kind in PACKED_KINDS:
        return msg.payload.count
    return 1


@dataclasses.dataclass
class PackedBurst:
    """One fused eager doorbell's wire image (DESIGN.md §13).

    The whole burst rides a single :class:`WireMsg` whose payload is this
    descriptor: ``data`` holds the K wire rows as one packed 2-D byte
    array (one stacked copy staged them), ``sizes[i]`` is row *i*'s
    delivered payload size in bytes, and ``tags[i]`` its message tag.
    ``wire_dtype == "bf16"`` marks rows carrying bf16-compressed float32
    payloads — :meth:`delivered_payloads` restores them to f32 bytes, so
    receivers observe flat uint8 arrays exactly like the scalar path.
    A tensor ``data`` yields tensor rows on the same device.
    """

    data: Any                      # (count, row_bytes) uint8 wire bytes:
    #                                an ndarray, or a tensor (on the card
    #                                when the burst was staged there)
    sizes: np.ndarray              # (count,) delivered bytes per row
    tags: List[int]                # per-row message tags
    count: int
    wire_dtype: Optional[str] = None

    def prefix(self, n: int) -> "PackedBurst":
        """The first ``n`` rows — a fabric prefix-accept split point."""
        return PackedBurst(self.data[:n], self.sizes[:n], self.tags[:n],
                           n, self.wire_dtype)

    def to(self, device) -> "PackedBurst":
        """This burst with its wire image on ``device`` (one copy of the
        rows between host and card, :func:`to_card`): a frame received
        over ``shm`` or ``socket`` lands on the card this way when its
        rows fill pre-posted CUDA recv buffers."""
        return PackedBurst(to_card(self.data, device), self.sizes,
                           self.tags, self.count, self.wire_dtype)

    def delivered_payloads(self) -> List[np.ndarray]:
        """Per-row payload byte arrays as the receiver must observe them
        (bf16 rows decompressed back to float32 bytes in ONE vectorized
        cast for the whole burst)."""
        if self.wire_dtype == "bf16":
            rows = bf16_rows_to_f32_bytes(self.data)
        else:
            rows = self.data
        width = rows.shape[1]
        sizes = self.sizes
        if sizes.size and int(sizes[0]) == width \
                and bool((sizes == width).all()):
            return list(rows)              # uniform full-width: row views
        return [rows[i, :int(s)] for i, s in enumerate(sizes)]


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 ndarray -> bf16 bit patterns (uint16, same shape), rounding
    to nearest even; NaN becomes the quiet NaN of its sign.  The host
    spelling of the ``ml_dtypes.bfloat16`` cast the reference uses."""
    u = np.ascontiguousarray(x).view(np.uint32)
    out = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(
        np.uint16)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000) | 0x7FC0
    return out


def bf16_rows_to_f32_bytes(data):
    """``(k, 2e)`` uint8 bf16 wire rows -> ``(k, 4e)`` uint8 float32 bytes
    (widening is exact: the bf16 bits become the high half).  An ndarray
    stays an ndarray; a tensor stays on its device.  Both give a dense
    result for a broadcast burst (stride 0 on dim 0): ``order="C"`` and
    ``float()`` do not keep the overlapping strides, which the uint8
    view would reject."""
    if isinstance(data, np.ndarray):
        bits = data.view(np.uint16).astype(np.uint32, order="C") << 16
        return bits.view(np.uint8)
    return data.view(torch.bfloat16).float().view(torch.uint8)


def to_host(data) -> np.ndarray:
    """A payload or wire image as a C-contiguous host ndarray, for the
    codec.  A CUDA tensor crosses to the host in ONE copy, counted in
    ``to_host.copies``: a broadcast burst (stride 0 on dim 0) copies its
    one row and repeats it on the host.  The copy is a blocking
    ``Tensor.cpu()`` on the current stream, so it runs after the
    doorbell kernel that staged the rows there and the host reads no
    stale bytes.  ndarrays and CPU tensors need no copy between host
    and card."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data)
    if data.is_cuda:
        to_host.copies += 1
        if data.dim() == 2 and data.shape[0] > 1 and data.stride(0) == 0:
            row = data[0].cpu().numpy()
            return np.ascontiguousarray(np.broadcast_to(row, data.shape))
        return data.cpu().numpy()
    return np.ascontiguousarray(data.numpy())


def to_card(data, device) -> torch.Tensor:
    """A copy of host ndarray ``data`` as a tensor on ``device``; a copy
    from host to card is ONE blocking copy, counted in
    ``to_card.copies``."""
    out = torch.tensor(np.ascontiguousarray(data), device=device)
    if out.is_cuda:
        to_card.copies += 1
    return out


to_host.copies = 0
to_card.copies = 0
