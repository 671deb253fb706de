"""Bound rank axes — what the in-graph collectives run on.

The reference runs its collectives inside ``shard_map``, where an axis is
a name (``axis_name: str``) and ``lax.ppermute`` / ``lax.psum`` /
``lax.axis_index`` resolve it.  PyTorch has no ``shard_map``, so the
port's collectives (:mod:`repro_torch.core.collectives`) take an
:class:`Axis` object instead: one rank's view of one mesh axis, with its
``size`` and ``index`` as host ints, the point-to-point
:meth:`Axis.ppermute` the ring schedules are built from, and the
monolithic operations that ``BSP`` and the fallbacks use —
:meth:`~Axis.all_gather` (tiled), :meth:`~Axis.psum`,
:meth:`~Axis.psum_scatter` (tiled), :meth:`~Axis.pmax` and
:meth:`~Axis.all_to_all` (tiled).

``ppermute`` keeps ``lax.ppermute``'s semantics: ``perm`` is a list of
``(source, destination)`` pairs of axis indices, and a rank that no pair
targets gets zeros.  :meth:`Axis.ppermute_start` posts the transfer and
returns a handle whose ``wait()`` gives the result, so a schedule can
keep two rings in flight, or compute while a transfer moves (the
reference's ``collective-permute-start`` / ``-done`` pairs).

Two substrates:

* :class:`LciAxis` rides the port's own comm core, one rank per thread of
  one process on a :class:`~repro_torch.core.runtime.LocalCluster` — the
  paper's thread mode, and the port's counterpart of JAX's fake-device
  mesh.  A ``ppermute`` posts the recv from its source, then the send to
  its destination, and progresses its own runtime until both complete.
  Each transfer's tag is unique to (axis, call): every ring step of every
  direction is its own call, so the two rings of ``LCI_DEDICATED`` never
  match each other's messages.  ``channel=None`` rides the rank's shared
  device (``LCI_SHARED``, ``BSP``); ``channel=c`` rides dedicated device
  ``c`` (``LCI_DEDICATED``, one device per ring direction).  CUDA tensors
  travel as CUDA tensors (the payload is cloned on the card, and the
  receiver copies it into its buffer there); protocol selection is the
  runtime's, by size.
* :class:`DistAxis` rides ``torch.distributed``: one process per rank
  (one per GPU in a deployment).  ``ppermute`` is ``batch_isend_irecv``;
  the monolithic operations are ``all_gather_into_tensor``,
  ``all_reduce``, ``reduce_scatter`` and ``all_to_all_single``.  It is
  tested over gloo on the CPU.  Over NCCL across several GPUs it is
  unverified: one H100 cannot hold two ranks of an NCCL communicator.

Costs: every call of :meth:`~Axis.ppermute_start`, :meth:`~Axis.all_gather`,
:meth:`~Axis.psum`, :meth:`~Axis.psum_scatter`, :meth:`~Axis.pmax` and
:meth:`~Axis.all_to_all_n` (:meth:`~Axis.all_to_all`) on any subclass is
recorded, once, into the cost counters active on the calling thread
(:mod:`repro_torch.launch.costs`): the subclass' methods are wrapped
when it is defined, and a call made inside another recorded call (a
default method built on another) is not recorded again.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import cost_sinks
from .post import CommDesc, CommKind, post_many, post_recv, post_send
from .status import FatalError, done

Perm = Sequence[Tuple[int, int]]

#: seconds a wait may spin before it gives up (a peer never posted)
WAIT_TIMEOUT = 600.0
#: seconds a rank with nothing to progress sleeps before it looks again
#: unrung (a safety net: the fabric rings on every message it lands)
BELL_TIMEOUT = 5e-3


class _Done:
    """A finished transfer's handle."""

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


#: the recorded methods and the kind each records under
RECORDED = {"ppermute_start": "ppermute", "all_gather": "all_gather",
            "psum": "psum", "psum_scatter": "reduce_scatter",
            "pmax": "pmax", "all_to_all": "all_to_all",
            "all_to_all_n": "all_to_all"}
_depth = threading.local()


def _recorded(method, kind: str):
    """``method`` recording each outermost call into the active cost
    counters: ``(kind, operand bytes, axis size[, (src, dst) of the
    first pair])`` an operand (``all_to_all_n``'s inputs each)."""
    @functools.wraps(method)
    def call(self, x, *args, **kwargs):
        depth = getattr(_depth, "n", 0)
        if depth == 0:
            sinks = cost_sinks()
            if sinks:
                xs = x if kind == "all_to_all" and method.__name__ == \
                    "all_to_all_n" else [x]
                perm = args[0] if args else kwargs.get("perm")
                pair = tuple(perm[0]) if kind == "ppermute" and perm \
                    else None
                n = max(max(p) for p in perm) + 1 if pair else 0
                for sink in sinks:
                    for t in xs:
                        sink.collective(kind, t.numel() * t.element_size(),
                                        self.size, pair, n)
        _depth.n = depth + 1
        try:
            return method(self, x, *args, **kwargs)
        finally:
            _depth.n = depth
    call.recorded = True
    return call


class Axis:
    """One rank's view of one mesh axis: ``size``, ``index`` (host ints),
    ``ppermute`` and the monolithic collectives."""

    size: int
    index: int
    name: str = "axis"
    device: torch.device = torch.device("cpu")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name, kind in RECORDED.items():
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "recorded", False):
                setattr(cls, name, _recorded(fn, kind))

    # -- point to point ------------------------------------------------------
    def ppermute_start(self, x: torch.Tensor, perm: Perm, *,
                       channel: Optional[int] = None):
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor, perm: Perm, *,
                 channel: Optional[int] = None) -> torch.Tensor:
        """``lax.ppermute``: ``x`` goes from each pair's source to its
        destination; a rank no pair targets gets zeros."""
        return self.ppermute_start(x, perm, channel=channel).wait()

    def _peers(self, perm: Perm) -> Tuple[Optional[int], Optional[int]]:
        """(the source that sends to this rank, the destination this rank
        sends to), each None when absent."""
        src = [s for s, d in perm if d == self.index]
        dst = [d for s, d in perm if s == self.index]
        if len(src) > 1 or len(dst) > 1:
            raise FatalError(f"ppermute: rank {self.index} appears more "
                             f"than once in {list(perm)}")
        return (src[0] if src else None), (dst[0] if dst else None)

    # -- monolithic ----------------------------------------------------------
    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int
                   ) -> torch.Tensor:
        return self.all_to_all_n([x], split_axis, concat_axis)[0]

    def all_to_all_n(self, xs: Sequence[torch.Tensor], split_axis: int,
                     concat_axis: int, *, channels: Optional[int] = None
                     ) -> List[torch.Tensor]:
        """``len(xs)`` independent tiled all-to-alls, posted together
        (the chunked all-to-all of the LCI modes)."""
        return [self.all_to_all(x, split_axis, concat_axis) for x in xs]


for _name, _kind in RECORDED.items():
    setattr(Axis, _name, _recorded(Axis.__dict__[_name], _kind))


def _sum_in_rank_order(parts: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """Sum of ``parts`` (rank order), float32 accumulation for floating
    dtypes, so every rank computes bitwise the same value."""
    if dtype.is_floating_point:
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(dtype)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


# ---------------------------------------------------------------------------
# the comm core substrate (one rank per thread)
# ---------------------------------------------------------------------------

class _Pending:
    """A posted transfer: ``wait()`` progresses until it completed."""

    def __init__(self, axis: "LciAxis", counter: List[int], expected: int,
                 out):
        self.axis = axis
        self.counter = counter
        self.expected = expected
        self.out = out

    def wait(self):
        self.axis._wait(self.counter, self.expected)
        return self.out


class _Counter:
    """A completion object that counts its signals (the comm core's
    completion protocol: ``signal(status)`` returns a done status)."""

    def __init__(self, box: List[int]):
        self.box = box

    def signal(self, status):
        self.box[0] += 1
        return done()

    def signal_many(self, statuses):
        self.box[0] += len(statuses)
        return [done()] * len(statuses)


class LciAxis(Axis):
    """An axis over the port's comm core: this rank's ``runtime``, the
    axis' member ranks (cluster ranks, in axis order), the endpoints the
    transfers ride (``shared``: one device; ``dedicated``: one device per
    ring direction; both allocated on every rank alike), one doorbell
    event a cluster rank (``bells``, set when the fabric lands a message
    for that rank) and the ``baton`` the rank threads take turns on.
    ``abort`` (an Event) stops every wait when a peer thread failed.
    :class:`repro_torch.distributed.spmd_map.Mesh` builds them."""

    def __init__(self, runtime, ranks: Sequence[int], *, shared, dedicated,
                 bells: Sequence[threading.Event], baton: threading.Lock,
                 name: str = "axis", uid: int = 0,
                 abort: Optional[threading.Event] = None):
        self.rt = runtime
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(runtime.rank)
        self.name = name
        self.uid = uid
        self.device = runtime.device
        self.shared = shared
        self.dedicated = dedicated
        self.abort = abort
        # a rank with nothing to progress sleeps on its bell until a
        # message lands for it, instead of spinning on the interpreter
        # lock the peer threads need
        self.bell = bells[runtime.rank]
        # only the baton's holder runs, and it hands the baton on only
        # while it waits for a peer, so the rank threads never contend
        # for the interpreter lock op by op
        self.baton = baton
        self._seq = itertools.count()

    # -- plumbing ------------------------------------------------------------
    def _tag(self, seq: int, slot: int = 0) -> int:
        # unique to (axis, call, piece): every ring step of every
        # direction draws its own call number, and SPMD ranks draw them
        # in the same order
        return ((self.uid & 0xFF) << 48) | ((seq & 0xFFFFFFFFFF) << 8) \
            | (slot & 0xFF)

    def _device(self, channel: Optional[int]):
        if channel is None:
            return self.shared.devices[0]
        devs = self.dedicated.devices
        return devs[channel % len(devs)]

    def _progress(self) -> bool:
        return (self.shared.progress() + self.dedicated.progress()) > 0

    def _wait(self, counter: List[int], expected: int) -> None:
        t0 = time.monotonic()
        while counter[0] < expected:
            self.bell.clear()             # before the pass: no lost ring
            if self._progress():
                continue
            if self.abort is not None and self.abort.is_set():
                raise FatalError(f"axis {self.name}: a peer rank failed; "
                                 "collective abandoned")
            if time.monotonic() - t0 > WAIT_TIMEOUT:
                raise FatalError(f"axis {self.name}: rank {self.index} "
                                 f"waited {WAIT_TIMEOUT:.0f} s for a "
                                 "transfer")
            self.baton.release()
            try:
                self.bell.wait(BELL_TIMEOUT)
            finally:
                self.baton.acquire()

    def _post_until_accepted(self, fn) -> None:
        """Post; a ``retry`` is posted again after a progress round."""
        while True:
            st = fn()
            if not st.is_retry():
                return st
            self._progress()

    def _post_recvs(self, recvs, seq, comp, counter, dev) -> None:
        for peer, bufs in recvs:
            for slot, buf in enumerate(bufs):
                st = self._post_until_accepted(
                    lambda: post_recv(self.rt, self.ranks[peer], buf,
                                      buf.nbytes, self._tag(seq, slot),
                                      comp, device=dev))
                if st.is_done():          # matched an early eager message
                    counter[0] += 1

    def _post_sends(self, sends, seq, comp, counter, device_of) -> None:
        """Each peer's pieces: one burst (a fused doorbell once it is long
        enough) on ``device_of(peer)``, a lone piece the scalar post."""
        for peer, bufs in sends:
            rank = self.ranks[peer]
            dev = device_of(peer)
            if len(bufs) < self.rt.fused_min_burst:
                for slot, b in enumerate(bufs):
                    st = self._post_until_accepted(
                        lambda: post_send(self.rt, rank, b, b.nbytes,
                                          self._tag(seq, slot), comp,
                                          device=dev))
                    if st.is_done():      # eager: comps are not signaled
                        counter[0] += 1
                continue
            ops = [CommDesc(CommKind.SEND, rank, b,
                            tag=self._tag(seq, slot), size=b.nbytes,
                            local_comp=comp)
                   for slot, b in enumerate(bufs)]
            while ops:
                sts = post_many(self.rt, ops, device=dev)
                n_ok = 0
                for st in sts:
                    if st.is_retry():
                        break
                    n_ok += 1
                    if st.is_done():      # eager: comps are not signaled
                        counter[0] += 1
                ops = ops[n_ok:]
                if ops:
                    self._progress()

    def _start(self, sends, recvs, channel, out, device_of=None):
        """Post ``recvs`` ([(peer, [buffer])]) then ``sends`` ([(peer,
        [tensor])]) as one call, on ``channel``'s device (the sends on
        ``device_of(peer)`` when given); returns the pending handle."""
        seq = next(self._seq)
        dev = self._device(channel)
        counter = [0]
        comp = _Counter(counter)
        expected = sum(len(b) for _, b in recvs) + \
            sum(len(b) for _, b in sends)
        self._post_recvs(recvs, seq, comp, counter, dev)
        self._post_sends(sends, seq, comp, counter,
                         device_of or (lambda peer: dev))
        return _Pending(self, counter, expected, out)

    # -- point to point ------------------------------------------------------
    def ppermute_start(self, x: torch.Tensor, perm: Perm, *,
                       channel: Optional[int] = None):
        src, dst = self._peers(perm)
        x = x.contiguous()
        if src == self.index:                 # a rank sending to itself
            return _Done(x.clone())
        out = torch.empty_like(x) if src is not None else torch.zeros_like(x)
        recvs = [(src, [out])] if src is not None else []
        sends = [(dst, [x])] if dst is not None else []
        return self._start(sends, recvs, channel, out)

    # -- monolithic: one exchange with every peer, then local compute --------
    def _exchange(self, pieces: Sequence[Sequence[torch.Tensor]],
                  channel: Optional[int] = None
                  ) -> List[List[torch.Tensor]]:
        """``pieces[r]`` go to rank ``r``; returns ``got[r]``, what rank
        ``r`` sent here (this rank's own pieces for ``r == index``)."""
        me = self.index
        got = [[torch.empty_like(t) for t in pieces[me]]
               for _ in range(self.size)]
        got[me] = list(pieces[me])
        recvs = [(r, got[r]) for r in range(self.size) if r != me]
        sends = [(r, [t.contiguous() for t in pieces[r]])
                 for r in range(self.size) if r != me]
        self._start(sends, recvs, channel, None).wait()
        return got

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        x = x.contiguous()
        got = self._exchange([[x]] * self.size)
        return torch.cat([g[0] for g in got], dim=axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        got = self._exchange([[x]] * self.size)
        return _sum_in_rank_order([g[0] for g in got], x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        got = self._exchange([[x]] * self.size)
        out = got[0][0]
        for g in got[1:]:
            out = torch.maximum(out, g[0])
        return out

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if x.shape[dim] % self.size:
            raise FatalError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not divide over {self.size} ranks")
        chunks = torch.chunk(x, self.size, dim=dim)
        got = self._exchange([[c.contiguous()] for c in chunks])
        return _sum_in_rank_order([g[0] for g in got], x.dtype)

    def all_to_all_n(self, xs: Sequence[torch.Tensor], split_axis: int,
                     concat_axis: int, *, channels: Optional[int] = None
                     ) -> List[torch.Tensor]:
        """Every chunk's pieces bound for one peer ride one doorbell (a
        burst of ``len(xs)`` sends); with ``channels`` the peers' bursts
        stripe over the dedicated devices."""
        p, me = self.size, self.index
        if any(x.shape[split_axis] % p for x in xs):
            raise FatalError(f"all_to_all: split axis {split_axis} does "
                             f"not divide over {p} ranks")
        split = [[c.contiguous() for c in torch.chunk(x, p, dim=split_axis)]
                 for x in xs]
        got = [[torch.empty_like(split[c][r]) for c in range(len(xs))]
               for r in range(p)]
        got[me] = [split[c][me] for c in range(len(xs))]
        peers = [r for r in range(p) if r != me]
        # a pair's burst rides the same dedicated device on both ranks
        device_of = None if channels is None else (
            lambda r: self._device((me + r) % channels))
        self._start([(r, [split[c][r] for c in range(len(xs))])
                     for r in peers], [(r, got[r]) for r in peers], None,
                    None, device_of).wait()
        return [torch.cat([got[r][c] for r in range(p)], dim=concat_axis)
                for c in range(len(xs))]


# ---------------------------------------------------------------------------
# the torch.distributed substrate (one process per rank)
# ---------------------------------------------------------------------------

class _DistPending:
    def __init__(self, reqs, out):
        self.reqs = reqs
        self.out = out

    def wait(self):
        for r in self.reqs:
            r.wait()
        return self.out


class DistAxis(Axis):
    """An axis over ``torch.distributed``: ``ranks`` are the group's
    global ranks in axis order, ``group`` its process group (None: the
    default group), ``device`` where its tokens live (default ``cuda``,
    the process' current card; ``"cpu"`` for gloo).  Over gloo on the CPU
    it is tested; over NCCL across several GPUs it is unverified (one
    H100 cannot hold two ranks of an NCCL communicator)."""

    def __init__(self, ranks: Sequence[int], group=None, *,
                 name: str = "axis", device=None):
        import torch.distributed as dist
        from .runtime import resolve_device
        self.dist = dist
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.group = group
        self.name = name
        self.device = resolve_device(device)

    def ppermute_start(self, x: torch.Tensor, perm: Perm, *,
                       channel: Optional[int] = None):
        dist = self.dist
        src, dst = self._peers(perm)
        x = x.contiguous()
        if src == self.index:
            return _Done(x.clone())
        out = torch.empty_like(x) if src is not None else torch.zeros_like(x)
        ops = []
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src],
                                  group=self.group))
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, self.ranks[dst],
                                  group=self.group))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return _DistPending(reqs, out)

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        xm = x.movedim(axis, 0).contiguous()
        out = torch.empty((xm.shape[0] * self.size,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # the name without a deprecation warning, where torch has it
        ag = getattr(self.dist, "all_gather_single", None) or \
            self.dist.all_gather_into_tensor
        ag(out, xm, group=self.group)
        return out.movedim(0, axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone().contiguous()
        self.dist.all_reduce(out, op=self.dist.ReduceOp.SUM,
                             group=self.group)
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone().contiguous()
        self.dist.all_reduce(out, op=self.dist.ReduceOp.MAX,
                             group=self.group)
        return out

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        dist = self.dist
        xm = x.movedim(dim, 0).contiguous()
        if xm.shape[0] % self.size:
            raise FatalError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not divide over {self.size} ranks")
        out = torch.empty((xm.shape[0] // self.size,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # the name without a deprecation warning, where torch has it
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, xm, op=dist.ReduceOp.SUM, group=self.group)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int
                   ) -> torch.Tensor:
        p = self.size
        if x.shape[split_axis] % p:
            raise FatalError(f"all_to_all: split axis {split_axis} does "
                             f"not divide over {p} ranks")
        xm = x.movedim(split_axis, 0).contiguous()
        out = torch.empty_like(xm)
        self.dist.all_to_all_single(out, xm, group=self.group)
        # out's dim 0 holds the sources' pieces in rank order: put them
        # back along concat_axis
        pieces = [t.movedim(0, split_axis)
                  for t in torch.chunk(out, p, dim=0)]
        return torch.cat(pieces, dim=concat_axis)


def mesh_groups(shape: Sequence[int], names: Sequence[str]
                ) -> Dict[str, List[List[int]]]:
    """For each mesh axis, the groups of ranks that differ only in that
    axis' coordinate (row-major rank numbering), each in axis order."""
    shape = tuple(shape)
    coords = list(itertools.product(*[range(n) for n in shape]))
    rank_of = {c: i for i, c in enumerate(coords)}
    out: Dict[str, List[List[int]]] = {}
    for a, name in enumerate(names):
        groups, seen = [], set()
        for c in coords:
            key = c[:a] + c[a + 1:]
            if key in seen:
                continue
            seen.add(key)
            groups.append([rank_of[c[:a] + (k,) + c[a + 1:]]
                           for k in range(shape[a])])
        out[name] = groups
    return out
