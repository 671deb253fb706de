"""Rendezvous (RTS/CTS/RDMA) and RMA handling — the zero-copy protocol.

The paper's §4.3 zero-copy path: a large send posts an **RTS** carrying
only metadata; the receiver matches it, pins a landing zone, and answers
**CTS**; the sender then moves the payload with a single RDMA write into
the landing zone.  RMA put/get ride the same machinery minus matching:
the remote buffer is a registered :class:`~.fabric.MemoryRegion`.

All per-handshake state (the CTS landing zones and the shared pending-op
table) lives on the owning :class:`~repro_torch.core.runtime.Runtime`, so any
number of :class:`~.engine.ProgressEngine` instances — one shared engine
or one per device — can drive the reactions without coordination.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..post import CommKind
from ..protocol import Protocol
from ..status import FatalError, Status, done, posted
from .fabric import (MemoryRegion, PendingOp, WireKind, WireMsg,
                     as_bytes_view, copy_prefix, next_op_id,
                     payload_to_bytes)


class RendezvousManager:
    """Owns the CTS landing zones and reacts to handshake/RMA messages."""

    def __init__(self, runtime):
        self.rt = runtime
        self.landing: list = []    # rendezvous landing zones (CTS state)

    # -- source side ---------------------------------------------------------
    def post_rts(self, engine, kind: CommKind, rank: int, buf: Any,
                 tag: int, size: int, local_comp, remote_comp,
                 matching_policy, dev, allow_retry: bool,
                 user_context: Any) -> Status:
        """Start a zero-copy transfer: register the pending op, wire an RTS."""
        rt = self.rt
        op_id = next_op_id()
        rt.pending_ops[op_id] = PendingOp(kind, buf, size, tag, rank,
                                          local_comp, lane=dev.lane,
                                          user_context=user_context)
        msg = WireMsg(WireKind.RTS, rt.rank, rank, tag=tag, size=size,
                      rcomp=remote_comp, matching_policy=matching_policy,
                      op_id=op_id, device_index=dev.index)
        rt.stats.handshakes += 1
        st = engine.submit(msg, dev, allow_retry)
        if st.is_retry():
            del rt.pending_ops[op_id]
        else:
            rt.stats.record(Protocol.ZEROCOPY, size)
        return st

    def post_put(self, engine, kind: CommKind, rank: int, buf: Any,
                 tag: int, size: int, local_comp, remote_buf, remote_comp,
                 dev, allow_retry: bool) -> Status:
        rt = self.rt
        op_id = next_op_id()
        rt.pending_ops[op_id] = PendingOp(kind, buf, size, tag, rank,
                                          local_comp, lane=dev.lane)
        msg = WireMsg(WireKind.PUT, rt.rank, rank, tag=tag,
                      payload=payload_to_bytes(buf, rt.device), size=size,
                      rcomp=remote_comp, remote_buf=remote_buf,
                      op_id=op_id, device_index=dev.index)
        st = engine.submit(msg, dev, allow_retry)
        if st.is_retry():
            del rt.pending_ops[op_id]
            return st
        rt.stats.record(Protocol.ZEROCOPY, size)
        return posted(ctx=op_id)

    def post_get(self, engine, rank: int, buf: Any, tag: int, size: int,
                 local_comp, remote_buf, dev, allow_retry: bool) -> Status:
        rt = self.rt
        op_id = next_op_id()
        rt.pending_ops[op_id] = PendingOp(CommKind.GET, buf, size, tag, rank,
                                          local_comp, lane=dev.lane)
        msg = WireMsg(WireKind.GET_REQ, rt.rank, rank, tag=tag, size=size,
                      remote_buf=remote_buf, op_id=op_id,
                      device_index=dev.index)
        st = engine.submit(msg, dev, allow_retry)
        if st.is_retry():
            del rt.pending_ops[op_id]
            return st
        rt.stats.record(Protocol.ZEROCOPY, size)
        return posted(ctx=op_id)

    # -- target side ---------------------------------------------------------
    def reply_cts(self, rts: WireMsg, recv_buf: Any, recv_comp, dev) -> None:
        cts = WireMsg(WireKind.CTS, self.rt.rank, rts.src, tag=rts.tag,
                      op_id=rts.op_id, device_index=rts.device_index)
        cts.payload = (len(self.landing),)
        self.landing.append((recv_buf, recv_comp, dev))
        self.rt.stats.handshakes += 1
        if not self.rt.fabric.try_push(cts):
            dev.backlog.push(("wire", cts))
        else:
            dev.count_push()

    # -- reactions (called from ProgressEngine._react) -----------------------
    def on_rts(self, engine, msg: WireMsg, dev) -> None:
        from ..matching import MatchKind, make_key
        if msg.rcomp is not None:           # zero-copy active message
            # allocate a landing buffer and CTS straight away
            landing = np.zeros(msg.size, np.uint8)
            comp = self.rt.rcomp_registry[msg.rcomp]
            self.reply_cts(msg, landing, comp, dev)
            return
        key = make_key(msg.src, msg.tag, msg.matching_policy)
        match = self.rt.matching.insert(key, MatchKind.SEND, ("rts", msg))
        if match is not None:
            _, buf, comp, rdev = match
            self.reply_cts(msg, buf, comp, dev)

    def on_cts(self, engine, msg: WireMsg, dev) -> None:
        op = self.rt.pending_ops.pop(msg.op_id, None)
        if op is None:
            raise FatalError("CTS for unknown op")
        landing_idx = msg.payload[0]
        data = payload_to_bytes(op.buf, self.rt.device)
        rdma = WireMsg(WireKind.RDMA_PAYLOAD, self.rt.rank, msg.src,
                       tag=op.tag, payload=data, size=op.size,
                       op_id=landing_idx, device_index=msg.device_index)
        if not self.rt.fabric.try_push(rdma):
            dev.backlog.push(("wire", rdma))
        else:
            dev.count_push()
        engine.signal(op.local_comp, done(rank=op.peer, tag=op.tag), dev)

    def on_rdma_payload(self, engine, msg: WireMsg, dev) -> None:
        buf, comp, rdev = self.landing[msg.op_id]
        engine.deliver_recv(buf, msg.payload, comp, msg.src, msg.tag, dev)

    def on_put(self, engine, msg: WireMsg, dev) -> None:
        region_id, offset = msg.remote_buf
        region: MemoryRegion = self.rt.memory_regions[region_id]
        copy_prefix(region.buf[offset:offset + msg.size], msg.payload,
                    msg.size)
        if msg.rcomp is not None:           # put with signal
            comp = self.rt.rcomp_registry[msg.rcomp]
            engine.signal(comp, done(msg.payload, rank=msg.src, tag=msg.tag),
                          dev)

    def on_get_req(self, engine, msg: WireMsg, dev) -> None:
        region_id, offset = msg.remote_buf
        region = self.rt.memory_regions[region_id]
        data = payload_to_bytes(region.buf[offset:offset + msg.size])
        resp = WireMsg(WireKind.GET_RESP, self.rt.rank, msg.src,
                       tag=msg.tag, payload=data, size=msg.size,
                       op_id=msg.op_id, device_index=msg.device_index)
        if not self.rt.fabric.try_push(resp):
            dev.backlog.push(("wire", resp))
        else:
            dev.count_push()

    def on_get_resp(self, engine, msg: WireMsg, dev) -> None:
        op = self.rt.pending_ops.pop(msg.op_id, None)
        if op is None:
            raise FatalError("GET_RESP for unknown op")
        copy_prefix(as_bytes_view(op.buf), msg.payload, msg.size)
        engine.signal(op.local_comp, done(msg.payload, rank=op.peer,
                                          tag=op.tag), dev)
