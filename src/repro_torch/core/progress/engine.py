"""The progress engine — posting plus the paper's Figure-1 reaction chain.

Progress (§3.2.6) is explicit: nothing moves unless someone drives a
:class:`ProgressEngine` over a device.  One progress pass implements the
reaction chain:

    drain backlog -> poll source completions -> poll incoming -> react
    (match, signal, rendezvous, replenish)

Engines are *drivers*, not state: the pending-op table, matching engine,
packet pool and landing zones all live on the owning ``Runtime``, so a
single shared engine and a fleet of dedicated per-device engines (the
paper's shared/dedicated resource split, :class:`~repro_torch.core.modes.CommMode`)
are interchangeable — an :class:`~.endpoint.Endpoint`'s progress policy
picks between them per workload.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..completion import CompletionObject
from ..concurrency.atomics import AtomicCounter
from ..matching import MatchKind, MatchingPolicy, make_key
from ..post import CommKind
from ..protocol import Protocol, select_protocol
from ..status import ErrorCode, FatalError, Status, done, err, posted, retry
from ..telemetry import NULL_TELEMETRY, record_burst_mix
from .fabric import (PackedBurst, PendingBurst, PendingOp, WireKind, WireMsg,
                     as_bytes_view, copy_prefix, next_op_id, pack_payloads,
                     payload_to_bytes, payloads_to_bytes)

#: wire kinds whose reactions batch their completion signals
_EAGER_KINDS = frozenset((WireKind.EAGER_AM, WireKind.EAGER_SEND,
                          WireKind.EAGER_PACKED_AM,
                          WireKind.EAGER_PACKED_SEND))


def _row_stride(data) -> int:
    """Dim-0 stride of a burst's uint8 wire image (0 = one row
    broadcast K ways)."""
    if isinstance(data, torch.Tensor):
        return data.stride(0)
    return data.strides[0]


class _SignalBatch:
    """Per-pass accumulator: completions grouped by target comp object so
    one ``signal_many`` amortizes the admission cost (paper §4.3's
    batched-CQ-poll analogue).  Per-comp order equals accumulation order,
    so FIFO delivery per completion object is preserved."""

    __slots__ = ("_groups",)

    def __init__(self):
        self._groups: Dict[int, Tuple[CompletionObject, List[Status]]] = {}

    def add(self, comp: Optional[CompletionObject], st: Status) -> None:
        if comp is None:
            return
        group = self._groups.get(id(comp))
        if group is None:
            self._groups[id(comp)] = (comp, [st])
        else:
            group[1].append(st)

    def add_many(self, comp: Optional[CompletionObject],
                 sts: List[Status]) -> None:
        """A fused doorbell's worth of completions for one comp object —
        one dict probe and one extend instead of K ``add`` calls."""
        if comp is None or not sts:
            return
        group = self._groups.get(id(comp))
        if group is None:
            self._groups[id(comp)] = (comp, list(sts))
        else:
            group[1].extend(sts)

    def flush(self, engine: "ProgressEngine", dev) -> None:
        for comp, sts in self._groups.values():
            engine.signal_many(comp, sts, dev)
        self._groups.clear()


class ProgressEngine:
    """Drives posting and progress for a runtime's devices.

    ``devices=None`` means "whatever the runtime currently owns" (the
    shared-engine mode); a dedicated engine is constructed with the
    single device it is responsible for.
    """

    def __init__(self, runtime, devices: Optional[List] = None,
                 name: str = "engine"):
        self.rt = runtime
        self._devices = devices
        self.name = name
        # the owning runtime's telemetry hub (stage spans + registry);
        # directly-constructed runtest doubles fall back to the null hub
        self.tele = getattr(runtime, "tele", None) or NULL_TELEMETRY
        # telemetry (paper's do_background_work counters) — atomic: a
        # shared engine is driven from many threads at once
        self._passes = AtomicCounter()
        self._reactions = AtomicCounter()
        self._burst_posts = AtomicCounter()

    @property
    def passes(self) -> int:
        return self._passes.load()

    @property
    def reactions(self) -> int:
        return self._reactions.load()

    @property
    def burst_posts(self) -> int:
        """Doorbells rung through :meth:`post_burst`."""
        return self._burst_posts.load()

    @property
    def devices(self) -> List:
        return self.rt.devices if self._devices is None else self._devices

    def __repr__(self) -> str:
        scope = "shared" if self._devices is None else \
            f"dedicated[{','.join(str(d.index) for d in self._devices)}]"
        return f"ProgressEngine({self.name!r}, {scope})"

    # -- posting (called via Runtime._post / post.post_comm) -----------------
    def post(self, *, kind: CommKind, rank: int, buf, tag: int,
             size: int, local_comp, remote_buf, remote_comp, device,
             matching_policy: MatchingPolicy, allow_retry: bool,
             user_context) -> Status:
        tele = self.tele
        if tele.timers_on:
            with tele.span("post"):
                return self._post_scalar(
                    kind, rank, buf, tag, size, local_comp, remote_buf,
                    remote_comp, device, matching_policy, allow_retry,
                    user_context)
        return self._post_scalar(
            kind, rank, buf, tag, size, local_comp, remote_buf,
            remote_comp, device, matching_policy, allow_retry, user_context)

    def _post_scalar(self, kind: CommKind, rank: int, buf, tag: int,
                     size: int, local_comp, remote_buf, remote_comp, device,
                     matching_policy: MatchingPolicy, allow_retry: bool,
                     user_context) -> Status:
        rt = self.rt
        dev = device or rt.default_device
        dev.count_post()
        if rank < 0 or rank >= rt.n_ranks:
            raise FatalError(f"bad target rank {rank}")
        if rt.dead_peers and rank in rt.dead_peers \
                and kind != CommKind.RECV:
            # the peer is declared dead (DESIGN.md §16): the op can never
            # complete, so it fails at post time — comps are NOT signaled
            # (the err status is returned directly, like done)
            return err(ErrorCode.ERR_PEER_DEAD, rank=rank, tag=tag,
                       ctx=user_context)

        if kind == CommKind.RECV:
            return self._post_recv(rank, buf, tag, size, local_comp, dev,
                                   matching_policy)
        if kind == CommKind.GET:
            return rt.rdv.post_get(self, rank, buf, tag, size, local_comp,
                                   remote_buf, dev, allow_retry)
        if kind in (CommKind.PUT, CommKind.PUT_SIGNAL):
            return rt.rdv.post_put(self, kind, rank, buf, tag, size,
                                   local_comp, remote_buf, remote_comp,
                                   dev, allow_retry)

        # SEND / AM with inject | bufcopy | zerocopy
        proto = select_protocol(size, rt.config)
        if proto == Protocol.ZEROCOPY:
            return rt.rdv.post_rts(self, kind, rank, buf, tag, size,
                                   local_comp, remote_comp, matching_policy,
                                   dev, allow_retry, user_context)

        packet = -1
        if proto == Protocol.BUFCOPY:
            packet, pst = rt.packet_pool.get(dev.lane)
            if pst.is_retry():
                rt.stats.retries += 1
                if allow_retry:
                    return pst
                # user disallowed retry: park in the backlog (paper §4.4)
                dev.backlog.push(("post", kind, rank, buf, tag, size,
                                  local_comp, remote_comp, matching_policy,
                                  user_context))
                return posted(code=ErrorCode.POSTED_BACKLOG)
            # stage payload into the packet (buffer-copy)
            data = payload_to_bytes(buf, rt.device)
            if data.nbytes > rt.packet_pool.packet_bytes:
                rt.packet_pool.put(dev.lane, packet)
                raise FatalError("bufcopy payload exceeds packet size")

        wire_kind = (WireKind.EAGER_AM if kind == CommKind.AM
                     else WireKind.EAGER_SEND)
        op_id = -1
        if proto == Protocol.BUFCOPY:
            op_id = next_op_id()
            rt.pending_ops[op_id] = PendingOp(kind, buf, size, tag, rank,
                                              local_comp, packet=packet,
                                              lane=dev.lane,
                                              user_context=user_context)
        msg = WireMsg(wire_kind, rt.rank, rank, tag=tag,
                      payload=payload_to_bytes(buf, rt.device), size=size,
                      rcomp=remote_comp, matching_policy=matching_policy,
                      op_id=op_id, device_index=dev.index)
        st = self.submit(msg, dev, allow_retry)
        if st.is_retry():
            if packet >= 0:
                rt.packet_pool.put(dev.lane, packet)
                del rt.pending_ops[op_id]
            return st
        rt.stats.record(proto, size)
        if proto == Protocol.INJECT:
            if st.code == ErrorCode.POSTED_BACKLOG:
                # the wire push was deferred; the payload is already copied
                # so the source buffer is reusable, but the op has not hit
                # the network — report the backlog, not done.  Inject ops
                # never signal completion objects (paper §3.2.5).
                return st
            # inject completes immediately; comps are NOT signaled (paper)
            return done(code=ErrorCode.DONE_INLINE, rank=rank, tag=tag)
        return posted(ctx=op_id)

    def _push_one(self, msg: WireMsg) -> bool:
        """Push one message, routing eager kinds through the reliability
        layer when armed — rel stamps a stream seq on acceptance (the
        ack then completes the op instead of the tx sweep)."""
        rt = self.rt
        rel = rt.rel
        if rel is not None and msg.kind in _EAGER_KINDS:
            return rel.send(rt.fabric, msg)
        return rt.fabric.try_push(msg)

    def submit(self, msg: WireMsg, dev, allow_retry: bool) -> Status:
        """Push to the fabric; full queue -> retry or backlog."""
        rt = self.rt
        tele = self.tele
        if tele.timers_on:
            with tele.span("transport.push"):
                ok = self._push_one(msg)
        else:
            ok = self._push_one(msg)
        if ok:
            dev.count_push()
            # source completion for bufcopy/zerocopy is deferred to
            # progress; a rel-stamped message (seq >= 0) completes on its
            # ack instead of the tx sweep
            if msg.op_id >= 0 and msg.seq < 0:
                dev.pending_tx.append(msg.op_id)
            return posted()
        rt.stats.retries += 1
        if allow_retry:
            return retry(ErrorCode.RETRY_LOCKED)
        st = dev.backlog.push(("wire", msg))
        if st.is_retry():
            return st
        if msg.op_id >= 0:
            dev.pending_tx.append(msg.op_id)
        return posted(code=ErrorCode.POSTED_BACKLOG)

    # -- burst posting (paper §4.3: amortize per-message software costs) ----
    def post_burst(self, ops: Sequence, dev) -> List[Status]:
        """Post a burst of operations on ONE device as coalesced doorbells.

        ``ops`` are :class:`~repro_torch.core.post.CommDesc` descriptors with
        ``size`` already resolved.  Consecutive eager ops (SEND/AM small
        enough for inject/bufcopy, with ``allow_retry``) form a doorbell:
        one ``pool.get_n`` covers the run's packet demand, one stacked
        payload copy stages the run, one ``fabric.push_burst`` per
        (peer, device) stream rings it, one telemetry bump counts it.
        Anything else — recvs, RMA, rendezvous-sized sends, no-retry ops —
        cuts the run and rides the scalar :meth:`post` path in order.

        Failure semantics are *prefix-accept*: the first op that cannot
        proceed (pool exhausted, fabric full) fails, and every later op in
        the burst fails with the same retry — posting op k+1 after op k
        failed would let it overtake on the stream and break FIFO.  The
        caller re-posts the failed suffix after driving progress (that is
        the doorbell split the burst-ordering tests exercise)."""
        tele = self.tele
        if tele.timers_on:
            with tele.span("post_burst"):
                return self._post_burst_runs(ops, dev)
        return self._post_burst_runs(ops, dev)

    def _post_burst_runs(self, ops: Sequence, dev) -> List[Status]:
        rt = self.rt
        n = len(ops)
        statuses: List[Optional[Status]] = [None] * n
        self._burst_posts.fetch_add(1)
        i = 0
        last_size = last_proto = None    # memoized: bursts are usually
        while i < n:                     # uniform-size, one lookup serves
            run_start = i                # the whole run
            protos: List[Protocol] = []
            while i < n:
                op = ops[i]
                if op.kind not in (CommKind.SEND, CommKind.AM) \
                        or not op.allow_retry:
                    break
                if op.size != last_size:
                    last_proto = select_protocol(op.size, rt.config)
                    last_size = op.size
                if last_proto == Protocol.ZEROCOPY:
                    break
                protos.append(last_proto)
                i += 1
            if protos:
                sts = self._post_eager_run(ops[run_start:i], protos, dev)
                statuses[run_start:i] = sts
                if sts[-1].is_retry():
                    code = sts[-1].code
                    for j in range(i, n):
                        statuses[j] = retry(code)
                    return statuses
            if i < n:                        # one non-burstable op, scalar
                op = ops[i]
                st = self.post(kind=op.kind, rank=op.rank, buf=op.buf,
                               tag=op.tag, size=op.size,
                               local_comp=op.local_comp,
                               remote_buf=op.remote_buf,
                               remote_comp=op.remote_comp, device=dev,
                               matching_policy=op.matching_policy,
                               allow_retry=op.allow_retry,
                               user_context=op.user_context)
                statuses[i] = st
                if st.is_retry():
                    for j in range(i + 1, n):
                        statuses[j] = retry(st.code)
                    return statuses
                i += 1
        return statuses

    def _post_eager_run(self, ops: Sequence, protos: List[Protocol],
                        dev) -> List[Status]:
        """Route one eager run: fused packed doorbell when the run is
        long enough and uniform (one peer, one kind, one remote comp,
        one matching policy — the shape a single PackedBurst descriptor
        can carry), else the scalar per-message burst."""
        rt = self.rt
        if rt.doorbell_fused and len(ops) >= rt.fused_min_burst:
            first = ops[0]
            kind, rank = first.kind, first.rank
            rcomp, policy = first.remote_comp, first.matching_policy
            # ONE pass both proves uniformity and extracts the columns
            # the packed descriptor needs (kind/policy are enum
            # singletons, so identity compares)
            bufs: List = []
            tags: List[int] = []
            sizes: List[int] = []
            lcomps: List = []
            for op in ops:
                if (op.kind is not kind or op.rank != rank
                        or op.remote_comp != rcomp
                        or op.matching_policy is not policy
                        or op.user_context is not None):
                    break
                bufs.append(op.buf)
                tags.append(op.tag)
                sizes.append(op.size)
                lcomps.append(op.local_comp)
            else:
                return self._post_fused_run(kind, rank, bufs, tags, sizes,
                                            protos, lcomps, rcomp, policy,
                                            dev)
        return self._post_eager_burst(ops, protos, dev)

    def _post_fused_run(self, kind: CommKind, rank: int, bufs: List,
                        tags: List[int], sizes, protos: Sequence[Protocol],
                        local_comps, remote_comp,
                        policy: MatchingPolicy, dev) -> List[Status]:
        """One FUSED doorbell (DESIGN.md §13): K uniform eager ops to one
        peer collapse into a single stage-copy-push — one pool ``get_n``,
        one packed staging copy (:func:`pack_payloads`, where the
        ``wire_bf16`` compression rides for free), ONE wire descriptor
        (:class:`PackedBurst`) rung with one ``fabric.push_packed``, and
        one :class:`PendingBurst` covering every bufcopy row's deferred
        completion.  Status semantics, prefix-accept split points and
        telemetry match :meth:`_post_eager_burst` row for row.

        ``sizes`` is an int (uniform) or per-row list; ``local_comps`` a
        single comp object (or None) shared by all rows, or a per-row
        list."""
        rt = self.rt
        n = len(bufs)
        dev.count_post(n)
        if rank < 0 or rank >= rt.n_ranks:
            raise FatalError(f"bad target rank {rank}")
        if rt.dead_peers and rank in rt.dead_peers:
            return [err(ErrorCode.ERR_PEER_DEAD, rank=rank, tag=t)
                    for t in tags]

        # ONE pool round-trip covers the whole run's packet demand
        n_buf = protos.count(Protocol.BUFCOPY) if hasattr(protos, "count") \
            else sum(1 for p in protos if p == Protocol.BUFCOPY)
        uniform_proto = (Protocol.BUFCOPY if n_buf == n
                         else Protocol.INJECT if n_buf == 0 else None)
        packets: List[int] = []
        if n_buf:
            packets, _pst = rt.packet_pool.get_n(dev.lane, n_buf)
        cut = n                              # first op we can't cover
        if len(packets) < n_buf:
            short = len(packets)
            seen = 0
            for idx, proto in enumerate(protos):
                if proto == Protocol.BUFCOPY:
                    if seen == short:
                        cut = idx
                        break
                    seen += 1
            rt.stats.retries += n - cut

        pushed = 0
        op_id = -1
        if cut:
            # ONE packed staging copy builds the whole wire image
            data, dsizes, wire_dtype = pack_payloads(
                bufs if cut == n else bufs[:cut], rt.wire_bf16, rt.device)
            if n_buf and int(dsizes.max(initial=0)) \
                    > rt.packet_pool.packet_bytes:
                # only bufcopy rows must fit a packet (as in the scalar
                # path); the max() gate keeps the per-row check off the
                # hot path
                for idx, (proto, ds) in enumerate(zip(protos, dsizes)):
                    if proto == Protocol.BUFCOPY \
                            and ds > rt.packet_pool.packet_bytes:
                        rt.packet_pool.put_n(dev.lane, packets)
                        raise FatalError(
                            "bufcopy payload exceeds packet size")
            burst = PackedBurst(data, dsizes,
                                tags if cut == n else tags[:cut],
                                cut, wire_dtype)
            msg = WireMsg(WireKind.EAGER_PACKED_AM if kind == CommKind.AM
                          else WireKind.EAGER_PACKED_SEND,
                          rt.rank, rank, tag=tags[0], payload=burst,
                          size=int(data.nbytes), rcomp=remote_comp,
                          matching_policy=policy, op_id=-1,
                          device_index=dev.index)
            rel = rt.rel
            tele = self.tele
            if tele.timers_on:
                with tele.span("transport.push"):
                    pushed = (rel.send_packed(rt.fabric, msg)
                              if rel is not None
                              else rt.fabric.push_packed(msg))
            else:
                pushed = (rel.send_packed(rt.fabric, msg)
                          if rel is not None
                          else rt.fabric.push_packed(msg))
            dev.count_push(pushed)
            if pushed < cut:
                rt.stats.retries += cut - pushed

        # bufcopy bookkeeping: one pending op for the whole doorbell;
        # packets of unpushed rows go straight back
        if n_buf:
            if uniform_proto is not None:        # all-bufcopy run
                used = pushed
                bidx = range(pushed)
            else:
                bidx = [i for i in range(pushed)
                        if protos[i] == Protocol.BUFCOPY]
                used = len(bidx)
            if used < len(packets):
                rt.packet_pool.put_n(dev.lane, packets[used:])
            if used:
                op_id = next_op_id()
                if isinstance(local_comps, list):
                    comps = [local_comps[i] for i in bidx]
                    if len(set(map(id, comps))) == 1:
                        # uniform run (commonly all None): collapse to a
                        # scalar so the completion sweep takes its bulk
                        # branch — or skips the rows entirely
                        comps = comps[0]
                else:
                    comps = local_comps
                rt.pending_ops[op_id] = PendingBurst(
                    kind, rank, dev.lane, packets[:used],
                    tags[:pushed] if used == pushed
                    else [tags[i] for i in bidx], comps)
                # a rel-stamped doorbell (msg.seq >= 0) binds its op to
                # the recorded entry and completes on the cumulative ack
                # instead of the tx sweep
                if not (msg.seq >= 0 and rt.rel is not None
                        and rt.rel.bind_op(rank, dev.index, msg.seq,
                                           op_id)):
                    dev.pending_tx.append(op_id)

        # burst telemetry: ONE shared helper does the per-protocol-class
        # accounting for the accepted prefix (identical arithmetic to the
        # scalar-burst path, so the two can never drift)
        if pushed:
            record_burst_mix(rt.stats, protos, sizes, pushed,
                             registry=(self.tele.registry
                                       if self.tele.counters_on else None))

        # statuses: identical codes to the scalar burst; identical rows
        # share ONE immutable status object instead of K constructions
        out: List[Optional[Status]] = [None] * n
        if pushed:
            if n_buf == 0:
                t0 = tags[0]
                if all(t == t0 for t in tags[:pushed]):
                    st = done(code=ErrorCode.DONE_INLINE, rank=rank, tag=t0)
                    out[:pushed] = [st] * pushed
                else:
                    out[:pushed] = [done(code=ErrorCode.DONE_INLINE,
                                         rank=rank, tag=t)
                                    for t in tags[:pushed]]
            elif uniform_proto is not None:
                out[:pushed] = [posted(ctx=op_id)] * pushed
            else:
                pst = posted(ctx=op_id)
                for i in range(pushed):
                    out[i] = pst if protos[i] == Protocol.BUFCOPY else \
                        done(code=ErrorCode.DONE_INLINE, rank=rank,
                             tag=tags[i])
        if pushed < cut:
            out[pushed:cut] = [retry(ErrorCode.RETRY_LOCKED)] * (cut - pushed)
        if cut < n:
            out[cut:] = [retry(ErrorCode.RETRY_NOPACKET)] * (n - cut)
        return out

    def _post_eager_burst(self, ops: Sequence, protos: List[Protocol],
                          dev) -> List[Status]:
        """One doorbell: eager SEND/AM ops on one device, all allow_retry."""
        rt = self.rt
        n = len(ops)
        dev.count_post(n)
        for op in ops:
            if op.rank < 0 or op.rank >= rt.n_ranks:
                raise FatalError(f"bad target rank {op.rank}")
        if rt.dead_peers and any(op.rank in rt.dead_peers for op in ops):
            # rare path: a burst touching a dead peer degrades to scalar
            # posts so each op gets its own err/posted verdict in order
            dev.count_post(-n)     # the scalar path re-counts each post
            out: List[Status] = []
            for i, op in enumerate(ops):
                st = self.post(kind=op.kind, rank=op.rank, buf=op.buf,
                               tag=op.tag, size=op.size,
                               local_comp=op.local_comp, remote_buf=None,
                               remote_comp=op.remote_comp, device=dev,
                               matching_policy=op.matching_policy,
                               allow_retry=True,
                               user_context=op.user_context)
                out.append(st)
                if st.is_retry():
                    out.extend(retry(st.code) for _ in ops[i + 1:])
                    break
            return out

        # ONE pool round-trip covers the whole run's packet demand
        n_buf = sum(1 for p in protos if p == Protocol.BUFCOPY)
        packets: List[int] = []
        if n_buf:
            packets, pst = rt.packet_pool.get_n(dev.lane, n_buf)
        cut = n                              # first op we can't cover
        if len(packets) < n_buf:
            short = len(packets)
            seen = 0
            for idx, proto in enumerate(protos):
                if proto == Protocol.BUFCOPY:
                    if seen == short:
                        cut = idx
                        break
                    seen += 1
            rt.stats.retries += n - cut

        # ONE stacked copy stages the whole run's payloads
        payloads = payloads_to_bytes([op.buf for op in ops[:cut]],
                                     rt.device)
        for proto, data in zip(protos[:cut], payloads):
            if proto == Protocol.BUFCOPY \
                    and data.nbytes > rt.packet_pool.packet_bytes:
                rt.packet_pool.put_n(dev.lane, packets)
                raise FatalError("bufcopy payload exceeds packet size")
        msgs: List[WireMsg] = []
        pi = 0
        for op, proto, data in zip(ops[:cut], protos[:cut], payloads):
            packet, op_id = -1, -1
            if proto == Protocol.BUFCOPY:
                packet = packets[pi]
                pi += 1
                op_id = next_op_id()
                rt.pending_ops[op_id] = PendingOp(
                    op.kind, op.buf, op.size, op.tag, op.rank,
                    op.local_comp, packet=packet, lane=dev.lane,
                    user_context=op.user_context)
            wire_kind = (WireKind.EAGER_AM if op.kind == CommKind.AM
                         else WireKind.EAGER_SEND)
            msgs.append(WireMsg(wire_kind, rt.rank, op.rank, tag=op.tag,
                                payload=data, size=op.size,
                                rcomp=op.remote_comp,
                                matching_policy=op.matching_policy,
                                op_id=op_id, device_index=dev.index))

        # ring one doorbell per consecutive (peer, device) stream
        tele = self.tele
        rel = rt.rel
        pushed = cut
        j = 0
        while j < len(msgs):
            k = j
            while k < len(msgs) and msgs[k].dst == msgs[j].dst:
                k += 1
            if tele.timers_on:
                with tele.span("transport.push"):
                    acc = (rel.send_burst(rt.fabric, msgs[j:k])
                           if rel is not None
                           else rt.fabric.push_burst(msgs[j:k]))
            else:
                acc = (rel.send_burst(rt.fabric, msgs[j:k])
                       if rel is not None
                       else rt.fabric.push_burst(msgs[j:k]))
            for m in msgs[j:j + acc]:
                if m.op_id >= 0 and m.seq < 0:
                    dev.pending_tx.append(m.op_id)
            if acc < k - j:                  # fabric full: cut here
                pushed = j + acc
                break
            j = k
        dev.count_push(pushed)

        # unwind the fabric-rejected tail (all ops here allow retry)
        if pushed < cut:
            unwound = [m.op_id for m in msgs[pushed:] if m.op_id >= 0]
            rt.packet_pool.put_n(
                dev.lane, [rt.pending_ops[oid].packet for oid in unwound])
            for oid in unwound:
                del rt.pending_ops[oid]
            rt.stats.retries += cut - pushed

        # burst telemetry: the same shared helper as the fused path does
        # the per-protocol-class accounting for the accepted prefix
        if pushed:
            record_burst_mix(rt.stats, protos, [op.size for op in ops],
                             pushed,
                             registry=(tele.registry if tele.counters_on
                                       else None))

        out: List[Status] = []
        for idx, (op, proto) in enumerate(zip(ops, protos)):
            if idx >= pushed:
                out.append(retry(ErrorCode.RETRY_NOPACKET if idx >= cut
                                 else ErrorCode.RETRY_LOCKED))
            elif proto == Protocol.INJECT:
                out.append(done(code=ErrorCode.DONE_INLINE, rank=op.rank,
                                tag=op.tag))
            else:
                out.append(posted(ctx=msgs[idx].op_id))
        return out

    def _post_recv(self, rank: int, buf, tag: int, size: int,
                   local_comp, dev, policy: MatchingPolicy) -> Status:
        rt = self.rt
        if rt.dead_peers and rank in rt.dead_peers \
                and policy is not MatchingPolicy.TAG_ONLY:
            # a recv naming a dead source can never match (wildcard-rank
            # recvs stay postable: a living sender may still satisfy them)
            return err(ErrorCode.ERR_PEER_DEAD, rank=rank, tag=tag)
        key = make_key(rank, tag, policy)
        value = ("recv", buf, local_comp, dev)
        match = self.rt.matching.insert(key, MatchKind.RECV, value)
        if match is None:
            if rt.rel is not None:
                rt.rel.track_recv(key, value, local_comp, rank, tag, dev)
            return posted(code=ErrorCode.POSTED_UNMATCHED)
        mkind, *rest = match
        if mkind == "eager":
            payload, src, mtag = rest
            if buf is not None:               # fill the posted buffer too
                view = as_bytes_view(buf)
                copy_prefix(view, payload, min(view.nbytes, payload.nbytes))
            # done => completion objects will NOT be signaled (paper §3.2.5)
            return done(payload, rank=src, tag=mtag)
        if mkind == "rts":
            msg = rest[0]
            self.rt.rdv.reply_cts(msg, buf, local_comp, dev)
            return posted()
        raise FatalError(f"unexpected match kind {mkind}")

    # -- progress (§3.2.6, Figure 1) -----------------------------------------
    def progress(self, device=None, max_msgs: int = 0) -> bool:
        """Drive one progress pass on ``device``; returns True if any work
        was done (paper: do_background_work).

        The pass runs under the device's progress try-lock (blocking spin
        here — single-threaded callers never contend), so the reaction
        chain is single-writer per device even when worker threads drive
        the same engine; use :meth:`try_progress` for the paper's
        fail-and-move-on discipline."""
        dev = device or (self._devices[0] if self._devices
                         else self.rt.default_device)
        with dev.progress_lock:
            return self._progress_locked(dev, max_msgs)

    def try_progress(self, device=None, max_msgs: int = 0):
        """Non-blocking progress (paper §4.2.3: "multiple threads call
        progress; a thread that fails the try-lock moves on").  Returns
        ``None`` when the device is being progressed by another thread,
        else the pass's did-work bool."""
        dev = device or (self._devices[0] if self._devices
                         else self.rt.default_device)
        rt = self.rt
        # idle fast path: nothing backlogged, no pending source-side
        # completions, nothing due on the wire — skip the lock and the
        # pass bookkeeping entirely.  Polling threads spend most of
        # their passes discovering exactly this, and under the GIL an
        # expensive "nothing to do" serializes every OTHER thread too.
        # Unlocked reads are safe: a stale miss is just an earlier poll,
        # and new work re-arms all three signals.
        if dev.backlog.empty_flag and not dev.pending_tx \
                and not rt.fabric.ready(rt.rank, dev.index) \
                and (rt.rel is None or not rt.rel.armed()):
            return False
        if not dev.progress_lock.try_acquire():
            return None
        try:
            return self._progress_locked(dev, max_msgs)
        finally:
            dev.progress_lock.release()

    def _progress_locked(self, dev, max_msgs: int = 0) -> bool:
        """One pass of the Figure-1 reaction chain, split into its three
        stages (backlog redelivery, source-completion sweep, drain+react)
        so the timers level can attribute the pass's time per stage.  At
        lower levels the stages are called directly — no span machinery
        touches the off-level hot path."""
        tele = self.tele
        if tele.timers_on:
            with tele.span("progress"):
                return self._progress_stages(dev, max_msgs, tele)
        return self._progress_stages(dev, max_msgs, None)

    def _progress_stages(self, dev, max_msgs: int, tele) -> bool:
        dev.count_progress()
        self._passes.fetch_add(1)
        did = False
        if not dev.backlog.empty_flag:
            if tele is not None:
                with tele.span("progress.backlog"):
                    did = self._stage_backlog(dev)
            else:
                did = self._stage_backlog(dev)
        if dev.pending_tx:
            if tele is not None:
                with tele.span("progress.tx_sweep"):
                    did |= self._stage_tx_sweep(dev)
            else:
                did |= self._stage_tx_sweep(dev)
        if tele is not None:
            with tele.span("progress.drain"):
                did |= self._stage_drain(dev, max_msgs)
        else:
            did |= self._stage_drain(dev, max_msgs)
        rel = self.rt.rel
        if rel is not None and rel.armed():
            # reliability timers (DESIGN.md §16): retransmit overdue
            # entries, expire post deadlines, flush stuck acks
            if tele is not None:
                with tele.span("progress.rel"):
                    did |= rel.sweep(self, dev)
            else:
                did |= rel.sweep(self, dev)
        return did

    def _stage_backlog(self, dev) -> bool:
        """Stage (3): retry backlogged requests first."""
        rt = self.rt
        did = False
        while not dev.backlog.empty_flag:
            item, st = dev.backlog.pop()
            if st.is_retry():
                break
            tag0 = item[0]
            if tag0 == "wire":
                msg = item[1]
                if not self._push_one(msg):
                    # requeue at the HEAD: a tail push would let a later
                    # same-stream message overtake this one once the
                    # fabric frees up (push_front never fails)
                    dev.backlog.push_front(item)
                    break
                dev.count_push()
                if msg.op_id >= 0 and msg.seq < 0:
                    dev.pending_tx.append(msg.op_id)
                did = True
            elif tag0 == "post":
                (_, kind, rank, buf, tag, size, local_comp, remote_comp,
                 policy, uctx) = item
                st2 = self.post(kind=kind, rank=rank, buf=buf, tag=tag,
                                size=size, local_comp=local_comp,
                                remote_buf=None, remote_comp=remote_comp,
                                device=dev, matching_policy=policy,
                                allow_retry=True, user_context=uctx)
                if st2.is_retry():
                    dev.backlog.push_front(item)   # keep FIFO redelivery
                    break
                did = True
            elif tag0 == "signal":
                # a completion object rejected this signal earlier
                # (retry(RETRY_QUEUE_FULL)); redeliver until accepted.
                # Requeue at the HEAD on rejection: pushing to the tail
                # would rotate parked signals and deliver later
                # completions to the same queue out of order.
                _, comp, st2 = item
                if comp.signal(st2).is_retry():
                    dev.backlog.push_front(item)
                    break
                did = True
        return did

    def _stage_tx_sweep(self, dev) -> bool:
        """Source-side completions (bufcopy send done on the wire) — the
        whole sweep batches its pool returns (one put_n per lane) and
        its completion signals (one signal_many per comp object)."""
        rt = self.rt
        did = False
        if dev.pending_tx:
            batch = _SignalBatch()
            puts: Dict[int, List[int]] = {}
            while dev.pending_tx:
                op_id = dev.pending_tx.popleft()
                op = rt.pending_ops.get(op_id)
                if op is None:
                    continue
                if type(op) is PendingBurst:
                    # one fused doorbell: all packets back in one batch,
                    # completions in row (FIFO) order
                    puts.setdefault(op.lane, []).extend(op.packets)
                    if isinstance(op.comps, list):
                        for c, t in zip(op.comps, op.tags):
                            if c is not None:
                                batch.add(c, done(rank=op.peer, tag=t))
                    elif op.comps is not None:
                        t0 = op.tags[0] if op.tags else None
                        if all(t == t0 for t in op.tags):
                            # uniform tags: ONE immutable status serves
                            # the whole doorbell's local completions
                            batch.add_many(op.comps,
                                           [done(rank=op.peer, tag=t0)]
                                           * len(op.tags))
                        else:
                            batch.add_many(op.comps,
                                           [done(rank=op.peer, tag=t)
                                            for t in op.tags])
                    del rt.pending_ops[op_id]
                    did = True
                    continue
                if op.kind in (CommKind.SEND, CommKind.AM):
                    if op.packet >= 0:          # return packet to the pool
                        puts.setdefault(op.lane, []).append(op.packet)
                        batch.add(op.local_comp,
                                  done(rank=op.peer, tag=op.tag))
                        del rt.pending_ops[op_id]
                    # zerocopy sends complete on CTS+RDMA, not here
                elif op.kind in (CommKind.PUT, CommKind.PUT_SIGNAL):
                    batch.add(op.local_comp, done(rank=op.peer, tag=op.tag))
                    del rt.pending_ops[op_id]
                did = True
            for lane, pkts in puts.items():
                rt.packet_pool.put_n(lane, pkts)
            batch.flush(self, dev)
        return did

    # -- reliability completions (DESIGN.md §16) -----------------------------
    def complete_tx_op(self, op_id: int, dev) -> None:
        """Retire one rel-tracked pending op whose cumulative ack
        arrived — packets back to the pool, comps signaled done, exactly
        the per-op semantics of :meth:`_stage_tx_sweep`.  Idempotent: a
        second call (or a call after a deadline failure already popped
        the op) is a no-op, keeping comp signals exactly-once."""
        self._finish_tx_op(op_id, dev, None)

    def fail_tx_op(self, op_id: int, dev, code: ErrorCode) -> None:
        """Terminally fail one rel-tracked pending op: packets still
        return to the pool, but comps are signaled ``err(code)`` so
        waiters never hang (ERR_TIMEOUT / ERR_PEER_DEAD)."""
        self._finish_tx_op(op_id, dev, code)

    def _finish_tx_op(self, op_id: int, dev,
                      code: Optional[ErrorCode]) -> None:
        rt = self.rt
        op = rt.pending_ops.pop(op_id, None)
        if op is None:
            return
        if code is None:
            mk = lambda t: done(rank=op.peer, tag=t)   # noqa: E731
        else:
            mk = lambda t: err(code, rank=op.peer, tag=t)  # noqa: E731
        if type(op) is PendingBurst:
            rt.packet_pool.put_n(op.lane, op.packets)
            if isinstance(op.comps, list):
                for c, t in zip(op.comps, op.tags):
                    self.signal(c, mk(t), dev)
            elif op.comps is not None:
                self.signal_many(op.comps, [mk(t) for t in op.tags], dev)
            return
        if op.kind in (CommKind.SEND, CommKind.AM):
            if op.packet >= 0:
                rt.packet_pool.put(op.lane, op.packet)
                self.signal(op.local_comp, mk(op.tag), dev)
        elif op.kind in (CommKind.PUT, CommKind.PUT_SIGNAL):
            self.signal(op.local_comp, mk(op.tag), dev)

    def _stage_drain(self, dev, max_msgs: int) -> bool:
        """Stage (4): poll incoming for this device stream and react:
        drain is one bounded burst per lock acquisition; eager
        completions accumulate into one signal batch flushed per
        contiguous eager run — a rendezvous/RMA reaction signals comps
        immediately inside _react, so the batch must flush BEFORE it runs
        or a deferred eager completion would overtake it on the same
        comp."""
        rt = self.rt
        tele = self.tele
        did = False
        if tele.timers_on:
            with tele.span("transport.drain"):
                msgs = rt.fabric.drain(rt.rank, dev.index, max_msgs)
        else:
            msgs = rt.fabric.drain(rt.rank, dev.index, max_msgs)
        if msgs and rt.rel is not None:
            # reliability filter: consume acks, drop dups/stale epochs,
            # resequence held-back runs into exact per-stream seq order
            msgs = rt.rel.on_incoming(msgs, self, dev)
        if msgs:
            batch = _SignalBatch()
            for msg in msgs:
                if msg.kind in _EAGER_KINDS:
                    self._react(msg, dev, batch)
                else:
                    batch.flush(self, dev)     # keep per-comp wire order
                    self._react(msg, dev)
            batch.flush(self, dev)
            did = True
        return did

    def progress_all(self, rounds: int = 1, max_msgs: int = 0) -> int:
        """Drive every device this engine is responsible for."""
        n = 0
        for _ in range(rounds):
            for dev in self.devices:
                n += bool(self.progress(dev, max_msgs))
        return n

    def _react(self, msg: WireMsg, dev, batch: Optional[_SignalBatch] = None
               ) -> None:
        rt = self.rt
        self._reactions.fetch_add(1)
        k = msg.kind
        if k == WireKind.EAGER_AM:
            comp = rt.rcomp_registry[msg.rcomp]
            st = done(msg.payload, rank=msg.src, tag=msg.tag)
            if batch is not None:
                batch.add(comp, st)
            else:
                self.signal(comp, st, dev)
        elif k == WireKind.EAGER_PACKED_AM:
            # one fused doorbell: one rcomp lookup, one vectorized
            # payload unpack (bf16 rows decompress here), one batched
            # signal extend for the whole burst
            burst: PackedBurst = msg.payload
            self._reactions.fetch_add(burst.count - 1)
            comp = rt.rcomp_registry[msg.rcomp]
            src = msg.src
            tags = burst.tags
            if (_row_stride(burst.data) == 0 and burst.wire_dtype is None
                    and len(set(tags)) == 1):
                # broadcast burst (same payload object repeated): every
                # delivered row is byte-identical, so ONE immutable
                # Status serves the whole doorbell
                sts = [done(burst.data[0], rank=src, tag=tags[0])
                       ] * burst.count
            else:
                sts = [done(p, rank=src, tag=t)
                       for p, t in zip(burst.delivered_payloads(), tags)]
            if batch is not None:
                batch.add_many(comp, sts)
            else:
                for st in sts:
                    self.signal(comp, st, dev)
        elif k == WireKind.EAGER_PACKED_SEND:
            burst = msg.payload
            self._reactions.fetch_add(burst.count - 1)
            src, pol = msg.src, msg.matching_policy
            payloads = burst.delivered_payloads()
            tags = burst.tags
            t0 = tags[0]
            if all(t == t0 for t in tags):
                # uniform match key: ONE bucket probe pops the whole
                # burst's worth of pre-posted recvs
                vals = rt.matching.match_now_n(
                    make_key(src, t0, pol), MatchKind.SEND, burst.count)
                matches = vals + [None] * (burst.count - len(vals))
            else:
                matches = rt.matching.match_now_burst(
                    [make_key(src, t, pol) for t in tags], MatchKind.SEND)
            on_card = None
            for i, match in enumerate(matches):
                payload = payloads[i]
                if match is None:           # per-bucket locked fallback
                    match = rt.matching.insert(
                        make_key(src, tags[i], pol), MatchKind.SEND,
                        ("eager", payload, src, tags[i]))
                if match is not None:
                    _, buf, comp, rdev = match
                    if (isinstance(buf, torch.Tensor) and buf.is_cuda
                            and not isinstance(payload, torch.Tensor)):
                        # host rows (a frame off shm or socket) for a
                        # CUDA recv buffer: the frame's rows cross to the
                        # card once, then each row is copied there
                        if on_card is None:
                            on_card = burst.to(
                                buf.device).delivered_payloads()
                        payload = on_card[i]
                    self.deliver_recv(buf, payload, comp, src, tags[i],
                                      dev, batch=batch)
        elif k == WireKind.EAGER_SEND:
            key = make_key(msg.src, msg.tag, msg.matching_policy)
            # eager fast path: a lock-free probe of the pre-posted-recv
            # stripe — when the recv is already posted (the windowed-
            # benchmark common case) the delivery skips the bucket lock
            # and the unexpected-queue insertion entirely
            match = rt.matching.match_now(key, MatchKind.SEND)
            if match is None:
                match = rt.matching.insert(
                    key, MatchKind.SEND,
                    ("eager", msg.payload, msg.src, msg.tag))
            if match is not None:
                _, buf, comp, rdev = match
                self.deliver_recv(buf, msg.payload, comp, msg.src, msg.tag,
                                  dev, batch=batch)
        elif k == WireKind.RTS:
            rt.rdv.on_rts(self, msg, dev)
        elif k == WireKind.CTS:
            rt.rdv.on_cts(self, msg, dev)
        elif k == WireKind.RDMA_PAYLOAD:
            rt.rdv.on_rdma_payload(self, msg, dev)
        elif k == WireKind.PUT:
            rt.rdv.on_put(self, msg, dev)
        elif k == WireKind.GET_REQ:
            rt.rdv.on_get_req(self, msg, dev)
        elif k == WireKind.GET_RESP:
            rt.rdv.on_get_resp(self, msg, dev)
        elif k == WireKind.ACK:
            # normally consumed by rel.on_incoming before reaction; a
            # straggler ack with reliability disabled is just dropped
            if rt.rel is not None:
                rt.rel._on_ack(msg, self, dev)
        else:
            raise FatalError(f"unknown wire kind {k}")

    def deliver_recv(self, buf, payload, comp, src: int, tag: int,
                     dev=None, batch: Optional[_SignalBatch] = None) -> None:
        if buf is not None:
            view = as_bytes_view(buf)
            copy_prefix(view, payload, min(view.nbytes, payload.nbytes))
        st = done(payload, rank=src, tag=tag)
        if batch is not None:
            batch.add(comp, st)
        else:
            self.signal(comp, st, dev)

    def signal(self, comp: Optional[CompletionObject], st: Status,
               dev=None) -> None:
        """Deliver a completion through the unified comp protocol: every
        completion object returns a Status from ``signal``; a ``retry``
        (e.g. RETRY_QUEUE_FULL) parks the delivery in the device backlog,
        and the next progress pass redelivers (paper §4.4)."""
        if comp is None:
            return
        result = comp.signal(st)
        if isinstance(result, Status) and result.is_retry():
            dev = dev or self.rt.default_device
            dev.backlog.push(("signal", comp, st))

    def signal_many(self, comp: Optional[CompletionObject],
                    statuses: List[Status], dev=None) -> None:
        """Burst delivery: one ``signal_many`` on the comp object; any
        rejected suffix (the comp protocol guarantees rejects are a
        prefix-accept's tail, in order) parks in the device backlog for
        in-order redelivery, exactly like scalar :meth:`signal`."""
        if comp is None or not statuses:
            return
        tele = self.tele
        if tele.timers_on:
            with tele.span("signal"):
                results = comp.signal_many(statuses)
        else:
            results = comp.signal_many(statuses)
        last = results[-1] if results else None
        if not (isinstance(last, Status) and last.is_retry()):
            return          # rejects are a suffix: clean last = clean burst
        dev = dev or self.rt.default_device
        for st, r in zip(statuses, results):
            if isinstance(r, Status) and r.is_retry():
                dev.backlog.push(("signal", comp, st))
