"""Stable binary wire codec for :class:`WireMsg` / :class:`PackedBurst`.

The shm and socket backends move messages between OS processes, so the
in-memory dataclasses need a stable byte encoding.  Pickle would work
but pins the wire format to Python internals; instead the codec writes
an explicit little-endian layout (struct header + raw numpy row bytes)
that a reader in any process — or any language — can parse:

    [u16 magic][u8 version][u8 kind-code]
    [i32 src][i32 dst][i64 tag][i64 size][i64 op_id]
    [i32 rcomp+1 (0 = None)][u8 matching-code][i32 device_index]
    [f64 ready_at]
    [u8 remote-buf-tag][i64 region_id][i64 offset]      (tag 0 = None)
    [i64 seq][i32 epoch][u32 body-crc32]
    [u8 payload-tag][...payload body...]

Payload bodies by tag:

* ``_P_NONE``   — empty;
* ``_P_BYTES``  — ``[i64 nbytes][raw bytes]`` (flat uint8 eager payload);
* ``_P_INTS``   — ``[i32 n][n × i64]`` (tuple-of-ints, e.g. the CTS
  landing-count handshake payload);
* ``_P_PACKED`` — a :class:`PackedBurst`: ``[i32 count][i32 row_bytes]``
  ``[u8 wire-dtype-code][count × i64 sizes][count × i64 tags]``
  ``[count*row_bytes raw row bytes]``.

Round-tripping preserves delivered semantics exactly: flat uint8 views
come back as flat uint8 arrays, packed bursts keep their per-row sizes,
tags, and bf16 wire dtype (``delivered_payloads`` equality is the
contract the property test pins).  Broadcast stride-0 rows are
materialized on encode — the wire carries bytes, not strides.

The frames are byte for byte the reference's (``repro``'s codec): each
package decodes the other's.  A payload or wire image may also be a
tensor.  A CPU tensor encodes to the same bytes as the equal ndarray; a
CUDA one (the ``(K, row_bytes)`` image the doorbell kernel staged on the
card) crosses to the host in ONE copy a frame
(:func:`~repro_torch.core.transport.wire.to_host`, which counts it).
``encode_msg.frames`` counts the frames encoded and
``encode_msg.cuda_frames`` those whose payload lay on the card, so a
caller can hold the copies to the host against the frames; a transport
that may refuse a frame asks :func:`frame_bytes` first, so a refused
frame costs no copy.  The decoder returns host arrays, copied out of the ring or socket
buffer before the transport reuses it.

Version 2 hardens the decoder for the chaos plane (DESIGN.md §16): the
header carries the reliability (seq, epoch) stamp plus a CRC32 over the
payload body, and every malformed input — truncated header or body, bad
magic, wrong version, unknown codes, negative lengths, bit-flipped
bytes — raises the typed :class:`CodecError` instead of leaking a bare
``struct.error`` / ``IndexError`` out of the parser.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, Tuple

import numpy as np
import torch

from ..matching import MatchingPolicy
from ..status import FatalError
from .wire import PackedBurst, WireKind, WireMsg, to_host


class CodecError(FatalError):
    """A wire frame failed to parse or verify — torn, foreign, or
    corrupted bytes.  Typed so transports can fail the *stream* (not the
    process) and the chaos tests can assert on it."""


_MAGIC = 0x5C17          # "LCI7"-ish; catches torn/foreign frames early
_VERSION = 2             # v2: (seq, epoch) stamp + body crc32

# stable one-byte codes; append only — never renumber a released code
_KIND_TO_CODE = {
    WireKind.EAGER_SEND: 1,
    WireKind.EAGER_AM: 2,
    WireKind.EAGER_PACKED_SEND: 3,
    WireKind.EAGER_PACKED_AM: 4,
    WireKind.RTS: 5,
    WireKind.CTS: 6,
    WireKind.RDMA_PAYLOAD: 7,
    WireKind.PUT: 8,
    WireKind.GET_REQ: 9,
    WireKind.GET_RESP: 10,
    WireKind.ACK: 11,
}
_CODE_TO_KIND = {v: k for k, v in _KIND_TO_CODE.items()}

_POLICY_TO_CODE = {
    MatchingPolicy.RANK_TAG: 1,
    MatchingPolicy.RANK_ONLY: 2,
    MatchingPolicy.TAG_ONLY: 3,
}
_CODE_TO_POLICY = {v: k for k, v in _POLICY_TO_CODE.items()}

# payload body tags
_P_NONE = 0
_P_BYTES = 1
_P_INTS = 2
_P_PACKED = 3

# packed-burst wire dtypes
_WD_TO_CODE = {None: 0, "bf16": 1}
_CODE_TO_WD = {v: k for k, v in _WD_TO_CODE.items()}

_HDR = struct.Struct("<HBB iiqqq iBi d Bqq qiI B")


def _nbytes(data) -> int:
    """Bytes of an ndarray or tensor, without reading them."""
    if isinstance(data, np.ndarray):
        return int(data.nbytes)
    return data.numel() * data.element_size()


def frame_bytes(msg: WireMsg) -> int:
    """The length of ``encode_msg(msg)``, computed without encoding (and
    so without copying a CUDA payload to the host)."""
    payload = msg.payload
    if payload is None:
        body = 0
    elif isinstance(payload, PackedBurst):
        count = int(payload.data.shape[0])
        row_bytes = _nbytes(payload.data) // count if count else 0
        body = 9 + 16 * count + count * row_bytes
    elif isinstance(payload, tuple):
        body = 4 + 8 * len(payload)
    else:
        body = 8 + _nbytes(payload)
    return _HDR.size + body


def _payload_bytes(payload) -> bytes:
    arr = to_host(payload)
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    return arr.tobytes()


def encode_msg(msg: WireMsg) -> bytes:
    """Serialize one :class:`WireMsg` to a self-delimiting byte frame."""
    kind_code = _KIND_TO_CODE.get(msg.kind)
    if kind_code is None:
        raise FatalError(f"codec: unknown wire kind {msg.kind!r}")
    if msg.remote_buf is None:
        rb_tag, rb0, rb1 = 0, 0, 0
    else:
        rb_tag, (rb0, rb1) = 1, msg.remote_buf

    payload = msg.payload
    data = payload.data if isinstance(payload, PackedBurst) else payload
    encode_msg.frames += 1
    if isinstance(data, torch.Tensor) and data.is_cuda:
        encode_msg.cuda_frames += 1
    if payload is None:
        p_tag, body = _P_NONE, b""
    elif isinstance(payload, PackedBurst):
        p_tag = _P_PACKED
        rows = to_host(payload.data)    # materialize stride-0; one copy
        #                                 from the card for a CUDA image
        if rows.dtype != np.uint8:
            rows = rows.view(np.uint8)
        count, row_bytes = (int(rows.shape[0]),
                            int(rows.shape[1]) if rows.ndim > 1 else 0)
        body = struct.pack("<iiB", count, row_bytes,
                           _WD_TO_CODE[payload.wire_dtype])
        body += np.asarray(payload.sizes, dtype="<i8").tobytes()
        body += np.asarray(payload.tags, dtype="<i8").tobytes()
        body += rows.tobytes()
    elif isinstance(payload, tuple):
        p_tag = _P_INTS
        body = struct.pack("<i", len(payload))
        body += np.asarray(payload, dtype="<i8").tobytes()
    else:
        p_tag = _P_BYTES
        raw = _payload_bytes(payload)
        body = struct.pack("<q", len(raw)) + raw

    hdr = _HDR.pack(_MAGIC, _VERSION, kind_code,
                    msg.src, msg.dst, msg.tag, msg.size, msg.op_id,
                    0 if msg.rcomp is None else msg.rcomp + 1,
                    _POLICY_TO_CODE[msg.matching_policy],
                    msg.device_index, msg.ready_at,
                    rb_tag, rb0, rb1,
                    msg.seq, msg.epoch, zlib.crc32(body) & 0xFFFFFFFF,
                    p_tag)
    return hdr + body


encode_msg.frames = 0
encode_msg.cuda_frames = 0


def _need(view: memoryview, off: int, n: int, what: str) -> None:
    if n < 0 or off + n > len(view):
        raise CodecError(f"codec: truncated frame ({what}: need {n} bytes "
                         f"at offset {off}, have {len(view) - off})")


def decode_msg(buf: Any, offset: int = 0) -> Tuple[WireMsg, int]:
    """Parse one frame from ``buf`` at ``offset``; returns the message
    and the offset one past its last byte.  Malformed or corrupted
    frames raise :class:`CodecError` — never a bare struct/IndexError."""
    view = memoryview(buf)
    _need(view, offset, _HDR.size, "header")
    (magic, version, kind_code, src, dst, tag, size, op_id,
     rcomp1, policy_code, device_index, ready_at,
     rb_tag, rb0, rb1, seq, epoch, crc, p_tag) = \
        _HDR.unpack_from(view, offset)
    if magic != _MAGIC:
        raise CodecError(f"codec: bad frame magic 0x{magic:04x}")
    if version != _VERSION:
        raise CodecError(f"codec: unsupported wire version {version}")
    kind = _CODE_TO_KIND.get(kind_code)
    if kind is None:
        raise CodecError(f"codec: unknown wire kind code {kind_code}")
    policy = _CODE_TO_POLICY.get(policy_code)
    if policy is None:
        raise CodecError(f"codec: unknown matching code {policy_code}")
    off = body_start = offset + _HDR.size

    if p_tag == _P_NONE:
        payload: Any = None
    elif p_tag == _P_BYTES:
        _need(view, off, 8, "bytes length")
        (nbytes,) = struct.unpack_from("<q", view, off)
        off += 8
        _need(view, off, nbytes, "bytes body")
        payload = np.frombuffer(view, np.uint8, nbytes, off).copy()
        off += nbytes
    elif p_tag == _P_INTS:
        _need(view, off, 4, "ints count")
        (n,) = struct.unpack_from("<i", view, off)
        off += 4
        _need(view, off, 8 * n if n >= 0 else -1, "ints body")
        payload = tuple(
            int(v) for v in np.frombuffer(view, "<i8", n, off))
        off += 8 * n
    elif p_tag == _P_PACKED:
        _need(view, off, 9, "packed header")
        count, row_bytes, wd_code = struct.unpack_from("<iiB", view, off)
        off += 9
        if count < 0 or row_bytes < 0:
            raise CodecError(f"codec: negative packed dims "
                             f"({count}, {row_bytes})")
        if wd_code not in _CODE_TO_WD:
            raise CodecError(f"codec: unknown wire dtype code {wd_code}")
        _need(view, off, 16 * count + count * row_bytes, "packed body")
        sizes = np.frombuffer(view, "<i8", count, off).copy()
        off += 8 * count
        tags = [int(t) for t in np.frombuffer(view, "<i8", count, off)]
        off += 8 * count
        rows = (np.frombuffer(view, np.uint8, count * row_bytes, off)
                .copy().reshape(count, row_bytes))
        off += count * row_bytes
        payload = PackedBurst(rows, sizes, tags, count,
                              _CODE_TO_WD[wd_code])
    else:
        raise CodecError(f"codec: unknown payload tag {p_tag}")

    body_crc = zlib.crc32(view[body_start:off]) & 0xFFFFFFFF
    if body_crc != crc:
        raise CodecError(f"codec: payload crc mismatch "
                         f"(frame 0x{crc:08x} != body 0x{body_crc:08x})")

    msg = WireMsg(kind=kind, src=src, dst=dst,
                  tag=tag, payload=payload, size=size,
                  rcomp=None if rcomp1 == 0 else rcomp1 - 1,
                  matching_policy=policy,
                  op_id=op_id,
                  remote_buf=None if rb_tag == 0 else (rb0, rb1),
                  device_index=device_index, ready_at=ready_at,
                  seq=seq, epoch=epoch)
    return msg, off
