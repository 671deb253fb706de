"""``post_comm`` — the unified communication posting operation (paper §3.2.4).

"LCI offers a generic communication posting operation, post_comm.  This
operation takes the target rank, the local buffer, the message size, and
the local completion object as positional arguments.  It takes a wide range
of optional arguments, among which the most important ones include the
direction, the remote buffer, and the remote completion object."

Table 1 of the paper, implemented verbatim by :func:`post_comm`:

    ======== ============ ================ ===========================
    direction remote buf   remote comp      meaning
    ======== ============ ================ ===========================
    OUT       none         none             send
    OUT       none         specified        active message
    OUT       specified    none             RMA put
    OUT       specified    specified        RMA put with signal
    IN        none         none             receive
    IN        none         specified        (invalid)
    IN        specified    none             RMA get
    IN        specified    specified        RMA get with signal (not
                                            implemented — mirrors paper §4.3)
    ======== ============ ================ ===========================

The five derived operations (``post_send/recv/am/put/get``) are "just
syntactic sugar for post_comm with the optional arguments set to the
corresponding values", each with an OFF ``_x`` variant.

Posting is endpoint-centric: every operation accepts ``endpoint=`` (an
:class:`~repro_torch.core.progress.endpoint.Endpoint`), which routes the op onto
the endpoint's striped device bundle via its stripe policy — equivalent to
the :meth:`Endpoint.post_send`-style sugar, but available on the generic
``post_comm`` and on deferred OFF builders
(``post_send_x(...).endpoint(ep)``), which is how completion-graph comm
nodes ride endpoints.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Sequence

from .matching import MatchingPolicy
from .off import OffBuilder, off
from .status import FatalError, Status


class Direction(enum.Enum):
    OUT = "out"
    IN = "in"


class CommKind(enum.Enum):
    SEND = "send"
    AM = "am"
    PUT = "put"
    PUT_SIGNAL = "put_signal"
    RECV = "recv"
    GET = "get"
    GET_SIGNAL = "get_signal"


def classify(direction: Direction, remote_buf, remote_comp) -> CommKind:
    """Table-1 dispatch; raises on the invalid / unimplemented rows."""
    if direction == Direction.OUT:
        if remote_buf is None and remote_comp is None:
            return CommKind.SEND
        if remote_buf is None:
            return CommKind.AM
        if remote_comp is None:
            return CommKind.PUT
        return CommKind.PUT_SIGNAL
    if remote_buf is None and remote_comp is None:
        return CommKind.RECV
    if remote_buf is None:
        raise FatalError("post_comm: direction=IN with a remote completion "
                         "but no remote buffer is invalid (paper Table 1)")
    if remote_comp is None:
        return CommKind.GET
    # paper §4.3: "Due to the lack of support for RDMA read with
    # notification in the interconnects we have access to, LCI does not
    # implement the get with signal communication operation"
    raise NotImplementedError(
        "get with signal is not implemented (paper §4.3: no 'RDMA read "
        "with notification' support on target interconnects)")


def payload_nbytes(buf: Any) -> int:
    """Size of a message payload; supports buffer *lists* (paper §3.3.1)."""
    if buf is None:
        return 0
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return len(buf)
    if isinstance(buf, (list, tuple)):
        return sum(payload_nbytes(b) for b in buf)
    if hasattr(buf, "nbytes"):
        return int(buf.nbytes)
    return len(bytes(buf))


def _route_endpoint(runtime, endpoint, device, rank: int, size: int):
    """Resolve the device an op rides when posted through an endpoint."""
    if endpoint is None:
        return device
    if device is not None:
        raise FatalError("post_comm: pass endpoint= or device=, not both "
                         "(the endpoint's stripe policy picks the device)")
    if endpoint.runtime is not runtime:
        raise FatalError(f"post_comm: endpoint {endpoint.name!r} belongs to "
                         f"rank {endpoint.runtime.rank}, not rank "
                         f"{runtime.rank}")
    return endpoint.select_device(rank=rank, size=size)


@off
def post_comm(runtime, direction: Direction, rank: int, buf: Any,
              local_comp=None, *, tag: int = 0, size: Optional[int] = None,
              remote_buf=None, remote_comp=None, device=None, endpoint=None,
              matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG,
              allow_retry: bool = True, user_context: Any = None) -> Status:
    """Generic posting operation; dispatches on Table 1 and hands the
    descriptor to the runtime's device path.  ``endpoint=`` routes the op
    through a striped device bundle instead of a raw device."""
    kind = classify(direction, remote_buf, remote_comp)
    nbytes = size if size is not None else payload_nbytes(buf)
    device = _route_endpoint(runtime, endpoint, device, rank, nbytes)
    return runtime._post(kind=kind, rank=rank, buf=buf, tag=tag,
                         size=nbytes,
                         local_comp=local_comp, remote_buf=remote_buf,
                         remote_comp=remote_comp, device=device,
                         matching_policy=matching_policy,
                         allow_retry=allow_retry, user_context=user_context)


# -- derived operations (sugar over post_comm; each has an OFF `.x`) --------

@off
def post_send(runtime, rank: int, buf: Any, size: Optional[int] = None,
              tag: int = 0, local_comp=None, *, device=None, endpoint=None,
              matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG,
              allow_retry: bool = True) -> Status:
    return post_comm(runtime, Direction.OUT, rank, buf, local_comp,
                     tag=tag, size=size, device=device, endpoint=endpoint,
                     matching_policy=matching_policy,
                     allow_retry=allow_retry)


@off
def post_recv(runtime, rank: int, buf: Any, size: Optional[int] = None,
              tag: int = 0, local_comp=None, *, device=None, endpoint=None,
              matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG,
              allow_retry: bool = True) -> Status:
    return post_comm(runtime, Direction.IN, rank, buf, local_comp,
                     tag=tag, size=size, device=device, endpoint=endpoint,
                     matching_policy=matching_policy,
                     allow_retry=allow_retry)


@off
def post_am(runtime, rank: int, buf: Any, size: Optional[int] = None,
            local_comp=None, remote_comp=None, *, tag: int = 0, device=None,
            endpoint=None, allow_retry: bool = True) -> Status:
    if remote_comp is None:
        raise FatalError("post_am requires a remote completion handle")
    return post_comm(runtime, Direction.OUT, rank, buf, local_comp,
                     tag=tag, size=size, remote_comp=remote_comp,
                     device=device, endpoint=endpoint,
                     allow_retry=allow_retry)


@off
def post_put(runtime, rank: int, buf: Any, remote_buf=None,
             size: Optional[int] = None, local_comp=None, remote_comp=None,
             *, tag: int = 0, device=None, endpoint=None,
             allow_retry: bool = True) -> Status:
    if remote_buf is None:
        raise FatalError("post_put requires a remote buffer")
    return post_comm(runtime, Direction.OUT, rank, buf, local_comp,
                     tag=tag, size=size, remote_buf=remote_buf,
                     remote_comp=remote_comp, device=device,
                     endpoint=endpoint, allow_retry=allow_retry)


@off
def post_get(runtime, rank: int, buf: Any, remote_buf=None,
             size: Optional[int] = None, local_comp=None, remote_comp=None,
             *, tag: int = 0, device=None, endpoint=None,
             allow_retry: bool = True) -> Status:
    if remote_buf is None:
        raise FatalError("post_get requires a remote buffer")
    return post_comm(runtime, Direction.IN, rank, buf, local_comp,
                     tag=tag, size=size, remote_buf=remote_buf,
                     remote_comp=remote_comp, device=device,
                     endpoint=endpoint, allow_retry=allow_retry)


# OFF variants under the paper's names
post_comm_x = post_comm.x
post_send_x = post_send.x
post_recv_x = post_recv.x
post_am_x = post_am.x
post_put_x = post_put.x
post_get_x = post_get.x


# ---------------------------------------------------------------------------
# Burst posting (paper §4.3) — coalesce K posts into per-device doorbells.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(slots=True)
class CommDesc:
    """One operation of a burst — ``post_comm``'s argument set as plain
    data, cheap enough to build by the thousand (slotted: descriptor
    construction is a measurable share of the scalar burst path).
    ``size=None`` is resolved to ``payload_nbytes(buf)`` by
    :func:`post_many`."""

    kind: CommKind
    rank: int
    buf: Any
    tag: int = 0
    size: Optional[int] = None
    local_comp: Any = None
    remote_buf: Any = None
    remote_comp: Any = None
    matching_policy: MatchingPolicy = MatchingPolicy.RANK_TAG
    allow_retry: bool = True
    user_context: Any = None


_BUILDER_KINDS = {"post_send": CommKind.SEND, "post_recv": CommKind.RECV,
                  "post_am": CommKind.AM, "post_put": CommKind.PUT,
                  "post_get": CommKind.GET}


def _desc_of_builder(b: OffBuilder):
    """Lower an unfired ``post_*_x`` builder to (runtime, endpoint, device,
    CommDesc) so a batch can group it with its peers."""
    name = b._fn.__name__
    remote_buf = b.get("remote_buf")
    remote_comp = b.get("remote_comp")
    if name == "post_comm":
        kind = classify(b.get("direction"), remote_buf, remote_comp)
    elif name in _BUILDER_KINDS:
        kind = _BUILDER_KINDS[name]
        if kind == CommKind.AM and remote_comp is None:
            raise FatalError("post_am requires a remote completion handle")
        if kind in (CommKind.PUT, CommKind.GET) and remote_buf is None:
            raise FatalError(f"{name} requires a remote buffer")
        if kind == CommKind.PUT and remote_comp is not None:
            kind = CommKind.PUT_SIGNAL
    else:
        raise FatalError(f"cannot batch {name!r}: only post_* operations "
                         "ride doorbells")
    runtime = b.get("runtime")
    if runtime is None:
        raise FatalError(f"{name}_x builder is missing its runtime")
    desc = CommDesc(kind=kind, rank=b.get("rank"), buf=b.get("buf"),
                    tag=b.get("tag", 0), size=b.get("size"),
                    local_comp=b.get("local_comp"), remote_buf=remote_buf,
                    remote_comp=remote_comp,
                    matching_policy=b.get("matching_policy",
                                          MatchingPolicy.RANK_TAG),
                    allow_retry=b.get("allow_retry", True),
                    user_context=b.get("user_context"))
    return runtime, b.get("endpoint"), b.get("device"), desc


def post_many(runtime, ops: Sequence, *, endpoint=None, device=None
              ) -> List[Status]:
    """Burst posting: post a sequence of operations (:class:`CommDesc`
    descriptors or unfired ``post_*_x`` builders) as coalesced per-device
    doorbells — one packet-pool ``get_n``, one stacked payload copy, one
    ``fabric.push_burst``, one telemetry bump per doorbell, instead of one
    of each per message (paper §4.3's batching insight at the device
    boundary).

    Ops are grouped by the device they resolve to (``endpoint=`` stripes
    each op exactly like scalar posting; a builder's own ``.endpoint()`` /
    ``.device()`` wins over the defaults).  Within a device group order is
    preserved and failure is prefix-accept: once one op retries, every
    later op of that group retries too, so per-stream FIFO survives a
    doorbell split.  Returns one Status per op, in input order."""
    n = len(ops)
    if endpoint is None:
        # plain-descriptor fast path: no endpoint striping means every op
        # rides ONE device — the group/resolve machinery below would
        # discover exactly that, one dict probe and list append per op.
        # The window-sized bursts of the mt hot loop live here.
        for op in ops:
            if isinstance(op, OffBuilder):
                break
            if op.size is None:
                op.size = payload_nbytes(op.buf)
        else:
            return runtime.engine.post_burst(
                ops if isinstance(ops, list) else list(ops),
                device or runtime.default_device)
    resolved = []                        # (device, desc) per op
    _MISS = object()
    burst_devs: dict[int, Any] = {}      # per-endpoint whole-burst device
    for op in ops:
        if isinstance(op, OffBuilder):
            rt_op, ep, dv, desc = _desc_of_builder(op)
            if rt_op is not runtime:
                raise FatalError("post_many: every op must ride the "
                                 "calling runtime")
            if ep is None and dv is None:   # no routing bound on the builder
                ep, dv = endpoint, device
        else:
            desc = op
            ep, dv = endpoint, device
        if desc.size is None:
            desc.size = payload_nbytes(desc.buf)
        if ep is not None:
            if dv is not None:
                raise FatalError("post_many: pass endpoint= or device=, "
                                 "not both")
            cached = burst_devs.get(id(ep), _MISS)
            if cached is _MISS:
                if ep.runtime is not runtime:   # validate once per endpoint
                    raise FatalError(
                        f"post_many: endpoint {ep.name!r} belongs to rank "
                        f"{ep.runtime.rank}, not rank {runtime.rank}")
                # round-robin endpoints stripe per doorbell, not per op
                # (Endpoint.select_burst_device): the batch's first op
                # fixes one device for the whole burst; by_peer/by_size
                # cache None and keep per-op selection
                cached = ep.select_burst_device(rank=desc.rank,
                                                size=desc.size)
                burst_devs[id(ep)] = cached
            dev = cached if cached is not None else \
                ep.select_device(rank=desc.rank, size=desc.size)
        else:
            dev = dv or runtime.default_device
        resolved.append((dev, desc))

    # group by device, preserving in-group (stream) order
    groups: dict[int, tuple[Any, List[int]]] = {}
    for i, (dev, _) in enumerate(resolved):
        entry = groups.get(id(dev))
        if entry is None:
            groups[id(dev)] = (dev, [i])
        else:
            entry[1].append(i)
    statuses: List[Optional[Status]] = [None] * n
    for dev, idxs in groups.values():
        sts = runtime.engine.post_burst([resolved[i][1] for i in idxs], dev)
        for i, st in zip(idxs, sts):
            statuses[i] = st
    return statuses


class PostBatch:
    """A doorbell under construction: collect deferred ops, then ``flush``.

    The OFF spelling builds one incrementally —
    ``batch = post_send_x(rt, peer, buf).endpoint(ep).batch()`` starts it,
    further ``.batch(batch)`` calls append, ``batch.flush()`` rings the
    doorbell(s) and returns the per-op statuses (input order).  ``add``
    also takes :class:`CommDesc` descriptors directly.  The batch is
    reusable after ``flush``."""

    def __init__(self, runtime=None, *, endpoint=None, device=None):
        self.runtime = runtime
        self.endpoint = endpoint
        self.device = device
        self._ops: List[Any] = []

    def add(self, op) -> "PostBatch":
        if self.runtime is None and isinstance(op, OffBuilder):
            self.runtime = op.get("runtime")
        self._ops.append(op)
        return self

    def __len__(self) -> int:
        return len(self._ops)

    def flush(self) -> List[Status]:
        if self.runtime is None:
            raise FatalError("PostBatch.flush: no runtime (add an op or "
                             "construct with PostBatch(runtime))")
        ops, self._ops = self._ops, []
        if not ops:
            return []
        return post_many(self.runtime, ops, endpoint=self.endpoint,
                         device=self.device)
