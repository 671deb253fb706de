"""In-graph collectives — LCI-X's ring schedules on a rank axis.

The mirror of :mod:`repro.core.collectives`, the reference's heart of the
TPU adaptation.  Every function takes a ``CommConfig`` whose mode picks:

* ``BSP``           — one monolithic collective, compute strictly after
  (the paper's MPI / bulk-synchronous baseline);
* ``LCI_SHARED``    — the ring decomposition on one channel: each step's
  ``ppermute`` is posted before the current piece's compute, so the next
  transfer overlaps it;
* ``LCI_DEDICATED`` — the ring decomposition over dedicated channels: two
  counter-rotating rings in flight at once (gather: distance split;
  reduce: payload split), on top of the same per-step overlap.

Where the reference takes ``axis_name: str`` inside ``shard_map``, these
take an :class:`~repro_torch.core.axis.Axis` (the rank's view of the mesh
axis: ``size``, ``index`` and ``ppermute``); the tensor dimension keeps
the reference's keyword ``axis``.  The rank index is a host int, so the
reference's ``dynamic_update_slice`` / ``dynamic_slice`` become plain
slice writes and reads.

Kept exactly from the reference:

* the rings are unrolled with their first and last iterations peeled, so
  no ppermute is wasted;
* gather rings: the forward ring delivers sources ``idx-1 .. idx-sf``
  (``sf = ceil((P-1)/2)``), the backward ring ``idx+1 .. idx+sb``
  (``sb = P-1-sf``);
* reduce rings: a contribution added at rank ``r`` on step ``i`` rides
  the +1 ring ``P-1-i`` more hops, so it targets ``dst = r + P-1-i``; on
  the −1 ring ``dst = r + i + 1``;
* matmul accumulation and the reduce rings' accumulators are float32,
  cast to the payload dtype only at the end; under ``wire_bf16`` the
  accumulator is rounded to bf16 for each hop and accumulated again in
  float32;
* the dedicated mode's ``n // 2`` feature split;
* the fallbacks: ``reduce_scatter`` to ``psum_scatter`` when the axis does
  not divide, ``all_reduce`` to ``psum`` for 0-d tensors or an
  indivisible leading dim, ``all_to_all`` monolithic when the feature axis
  is the split or concat axis or does not divide into
  ``resolved_channels()`` chunks.

Also here: the paper's §6 primitives — the dissemination barrier and the
binomial-tree broadcast and reduce — on the same ppermute substrate.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .axis import Axis
from .modes import CommConfig, CommMode

DEFAULT = CommConfig()

#: ring direction -> dedicated channel (one device per direction)
_CHANNEL = {+1: 0, -1: 1}


def _ring_perm(n: int, direction: int = +1):
    return [(i, (i + direction) % n) for i in range(n)]


def _channel(config: CommConfig, direction: int):
    """The channel a ring direction rides: dedicated devices in
    ``LCI_DEDICATED``, the shared device otherwise."""
    if config.mode == CommMode.LCI_DEDICATED:
        return _CHANNEL[direction]
    return None


def _put(out: torch.Tensor, piece: torch.Tensor, axis: int, start: int
         ) -> None:
    out.narrow(axis, start, piece.shape[axis]).copy_(piece)


def _mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` contracted on a's last dim, float32 accumulation and
    result (``preferred_element_type=float32``).  bf16 operands on the
    card go to the tensor cores with a float32 output (``aten::mm``'s
    ``out_dtype`` overload, where torch has it); elsewhere the operands
    are widened first (bf16 products are exact in float32)."""
    if (a.is_cuda and a.dtype == w.dtype == torch.bfloat16
            and hasattr(torch.ops.aten.mm, "dtype")):
        out = torch.mm(a.reshape(-1, a.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return torch.matmul(a.float(), w.float())


# ---------------------------------------------------------------------------
# all-gather (zero-copy ring)
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, rank_axis: Axis,
               config: CommConfig = DEFAULT, *, axis: int = 0
               ) -> torch.Tensor:
    """All-gather ``x`` (sharded on ``axis``) across ``rank_axis``."""
    if config.mode == CommMode.BSP:
        return rank_axis.all_gather(x, axis)
    return _ring_all_gather(
        x, rank_axis, axis=axis, config=config,
        bidirectional=config.mode == CommMode.LCI_DEDICATED)


def _ring_all_gather(x: torch.Tensor, ra: Axis, *, axis: int,
                     config: CommConfig, bidirectional: bool
                     ) -> torch.Tensor:
    p, idx = ra.size, ra.index
    axis = axis % x.ndim
    shard = x.shape[axis]
    out_shape = x.shape[:axis] + (shard * p,) + x.shape[axis + 1:]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if p == 1:
        _put(out, x, axis, 0)
        return out

    sf = (p - 1 + 1) // 2          # forward hops = ceil((P-1)/2)
    sb = (p - 1) - sf              # backward hops

    if not bidirectional or sb == 0:
        ch = _channel(config, +1)
        cur = x
        for i in range(p):
            nxt = (ra.ppermute_start(cur, _ring_perm(p, +1), channel=ch)
                   if i < p - 1 else None)
            _put(out, cur, axis, ((idx - i) % p) * shard)
            if nxt is not None:
                cur = nxt.wait()
        return out

    # bidirectional (distance split): exactly sf forward + sb backward
    # hops, both rings in flight at once
    _put(out, x, axis, idx * shard)                          # self
    cf, cb = x, x
    for j in range(1, sf + 1):
        hf = ra.ppermute_start(cf, _ring_perm(p, +1), channel=0)
        hb = (ra.ppermute_start(cb, _ring_perm(p, -1), channel=1)
              if j <= sb else None)
        cf = hf.wait()
        _put(out, cf, axis, ((idx - j) % p) * shard)
        if hb is not None:
            cb = hb.wait()
            _put(out, cb, axis, ((idx + j) % p) * shard)
    return out


# ---------------------------------------------------------------------------
# all-gather matmul:  Y = allgather(X) @ W   (column-parallel TP with SP)
# ---------------------------------------------------------------------------

def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, rank_axis: Axis,
                      config: CommConfig = DEFAULT) -> torch.Tensor:
    """``x``: (m_shard, ..., k) sharded on dim 0 over ``rank_axis``; ``w``:
    (k, n) local.  Returns (m_shard*P, ..., n) = ``allgather(x) @ w``.

    LCI modes compute ``x_i @ w`` while the ring moves ``x_{i+1}`` (the
    collective-matmul overlap: matmul i waits only on shard i's
    arrival)."""
    if config.mode == CommMode.BSP:
        xg = rank_axis.all_gather(x, 0)
        return torch.matmul(xg, w).to(x.dtype)

    ra = rank_axis
    p, idx = ra.size, ra.index
    m_shard = x.shape[0]
    out = torch.empty((m_shard * p,) + tuple(x.shape[1:-1]) + (w.shape[1],),
                      dtype=x.dtype, device=x.device)

    def mm(cur):
        return _mm32(cur, w)

    if p == 1:
        _put(out, mm(x).to(x.dtype), 0, 0)
        return out

    sf = (p - 1 + 1) // 2
    sb = (p - 1) - sf

    if config.mode == CommMode.LCI_SHARED or sb == 0:
        ch = _channel(config, +1)
        cur = x
        for i in range(p):
            nxt = (ra.ppermute_start(cur, _ring_perm(p, +1), channel=ch)
                   if i < p - 1 else None)
            _put(out, mm(cur).to(x.dtype), 0, ((idx - i) % p) * m_shard)
            if nxt is not None:
                cur = nxt.wait()
        return out

    # dedicated: counter-rotating rings, a matmul per arrival
    hf = ra.ppermute_start(x, _ring_perm(p, +1), channel=0)
    hb = ra.ppermute_start(x, _ring_perm(p, -1), channel=1)
    _put(out, mm(x).to(x.dtype), 0, idx * m_shard)
    for j in range(1, sf + 1):
        cf = hf.wait()
        hf = (ra.ppermute_start(cf, _ring_perm(p, +1), channel=0)
              if j < sf else None)
        _put(out, mm(cf).to(x.dtype), 0, ((idx - j) % p) * m_shard)
        if j <= sb:
            cb = hb.wait()
            hb = (ra.ppermute_start(cb, _ring_perm(p, -1), channel=1)
                  if j < sb else None)
            _put(out, mm(cb).to(x.dtype), 0, ((idx + j) % p) * m_shard)
    return out


# ---------------------------------------------------------------------------
# the reduce rings (matmul reduce-scatter, reduce-scatter)
# ---------------------------------------------------------------------------

def _reduce_rings(ra: Axis, config: CommConfig, rings: Sequence) -> List:
    """Run the reduce rings of ``rings`` (``(contrib, direction)``, where
    ``contrib(dst)`` is this rank's float32 contribution to rank ``dst``'s
    piece) side by side: every step posts each ring's hop, then adds the
    next contributions while the hops move.  Returns each ring's float32
    accumulator."""
    p, idx = ra.size, ra.index

    def dst(i, direction):
        if direction == +1:
            return (idx + p - 1 - i) % p
        return (idx + i + 1) % p

    accs = [contrib(dst(0, d)) for contrib, d in rings]
    wire = torch.bfloat16 if config.wire_bf16 else None
    for i in range(1, p):
        hs = []
        for (contrib, d), acc in zip(rings, accs):
            payload = acc.to(wire) if wire is not None else acc
            hs.append(ra.ppermute_start(payload, _ring_perm(p, d),
                                        channel=_channel(config, d)))
        nxt = [contrib(dst(i, d)) for contrib, d in rings]
        accs = [h.wait().float() + c for h, c in zip(hs, nxt)]
    return accs


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                          rank_axis: Axis, config: CommConfig = DEFAULT
                          ) -> torch.Tensor:
    """``x``: (m, k_shard), ``w``: (k_shard, n) sharded on k over
    ``rank_axis``.  Returns the row-scattered sum: (m/P, n) on each rank.

    LCI modes ring-accumulate: each step computes one m-slice's partial
    product and adds it to the accumulator arriving from the neighbour;
    dedicated mode splits the n (feature) axis over two counter-rotating
    rings."""
    ra = rank_axis
    p = ra.size
    m = x.shape[0]
    assert m % p == 0, f"matmul_reduce_scatter: m={m} not divisible by P={p}"
    m_shard = m // p

    if config.mode == CommMode.BSP:
        full = torch.matmul(x, w)
        return ra.psum_scatter(full, 0).to(x.dtype)

    def ring(w_part):
        def contrib(d):
            return _mm32(x.narrow(0, d * m_shard, m_shard), w_part)
        return contrib

    n = w.shape[1]
    if config.mode == CommMode.LCI_DEDICATED and p > 1 and n % 2 == 0:
        lo, hi = _reduce_rings(ra, config, [(ring(w[:, :n // 2]), +1),
                                            (ring(w[:, n // 2:]), -1)])
        return torch.cat([lo, hi], dim=-1).to(x.dtype)
    return _reduce_rings(ra, config, [(ring(w), +1)])[0].to(x.dtype)


def reduce_scatter(x: torch.Tensor, rank_axis: Axis,
                   config: CommConfig = DEFAULT, *, axis: int = 0
                   ) -> torch.Tensor:
    """Ring reduce-scatter of ``x`` along ``axis`` across ``rank_axis``."""
    ra = rank_axis
    p = ra.size
    axis = axis % x.ndim
    if config.mode == CommMode.BSP or x.shape[axis] % p != 0:
        return ra.psum_scatter(x, axis)
    shard = x.shape[axis] // p

    def ring(src):
        def contrib(d):
            return src.narrow(axis, d * shard, shard).float()
        return contrib

    feat = x.ndim - 1
    if (config.mode == CommMode.LCI_DEDICATED and p > 1
            and feat != axis and x.shape[feat] % 2 == 0):
        lo, hi = torch.chunk(x, 2, dim=feat)
        a, b = _reduce_rings(ra, config, [(ring(lo), +1), (ring(hi), -1)])
        return torch.cat([a.to(x.dtype), b.to(x.dtype)], dim=feat)
    return _reduce_rings(ra, config, [(ring(x), +1)])[0].to(x.dtype)


def all_reduce(x: torch.Tensor, rank_axis: Axis,
               config: CommConfig = DEFAULT) -> torch.Tensor:
    """All-reduce = ring reduce-scatter + ring all-gather in LCI modes, or
    one psum in BSP.  Falls back to psum when the leading dim does not
    divide the axis size."""
    if (config.mode == CommMode.BSP or x.ndim == 0
            or x.shape[0] % rank_axis.size != 0):
        return rank_axis.psum(x)
    scattered = reduce_scatter(x, rank_axis, config, axis=0)
    return all_gather(scattered, rank_axis, config, axis=0)


# ---------------------------------------------------------------------------
# all-to-all (MoE dispatch / combine)
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, rank_axis: Axis, *, split_axis: int,
               concat_axis: int, config: CommConfig = DEFAULT,
               tiled: bool = True) -> torch.Tensor:
    """Chunked all-to-all: LCI modes slice a non-participating dim into
    ``n_channels`` chunks issued as independent exchanges (each peer's
    chunks posted as one burst, striped over the dedicated devices)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form is "
                                  "used by the reference's callers")
    n = config.resolved_channels()
    split_axis %= x.ndim
    concat_axis %= x.ndim
    if config.mode == CommMode.BSP or n <= 1:
        return rank_axis.all_to_all(x, split_axis, concat_axis)
    feat_axis = x.ndim - 1
    if feat_axis in (split_axis, concat_axis) or x.shape[feat_axis] % n != 0:
        return rank_axis.all_to_all(x, split_axis, concat_axis)
    chunks = torch.chunk(x, n, dim=feat_axis)
    outs = rank_axis.all_to_all_n(chunks, split_axis, concat_axis,
                                  channels=n)
    return torch.cat(outs, dim=feat_axis)


# ---------------------------------------------------------------------------
# paper §6 collective primitives: dissemination barrier, tree bcast/reduce
# ---------------------------------------------------------------------------

def dissemination_barrier(rank_axis: Axis) -> torch.Tensor:
    """Dissemination barrier: ceil(log2 P) rounds; returns a token that
    depends on every rank.  Token value == P on every rank."""
    p = rank_axis.size
    token = torch.ones((), dtype=torch.int32, device=rank_axis.device)
    dist = 1
    while dist < p:
        perm = [(i, (i + dist) % p) for i in range(p)]
        token = token + rank_axis.ppermute(token, perm)
        dist *= 2
    return token


def tree_broadcast(x: torch.Tensor, rank_axis: Axis, *, root: int = 0
                   ) -> torch.Tensor:
    """Binomial-tree broadcast from ``root`` via masked ppermute rounds."""
    p, idx = rank_axis.size, rank_axis.index
    rel = (idx - root) % p              # root-relative rank
    val = x
    have = rel == 0
    span = 1
    while span < p:
        # relative ranks [0, span) send to [span, 2*span)
        perm = [((i + root) % p, (i + span + root) % p)
                for i in range(span) if i + span < p]
        incoming = rank_axis.ppermute(val, perm)
        recv_now = span <= rel < 2 * span
        if recv_now and not have:
            val = incoming
        have = have or recv_now
        span *= 2
    return val


def tree_reduce(x: torch.Tensor, rank_axis: Axis, *, root: int = 0
                ) -> torch.Tensor:
    """Binomial-tree sum-reduce to ``root`` (other ranks return partials;
    callers wanting all-reduce tree_broadcast afterwards)."""
    p, idx = rank_axis.size, rank_axis.index
    rel = (idx - root) % p
    val = x
    span = 1
    while span < p:
        # relative ranks with rel % 2span == span send to rel - span
        perm = [((i + root) % p, (i - span + root) % p)
                for i in range(p) if i % (2 * span) == span]
        incoming = rank_axis.ppermute(val, perm)
        if rel % (2 * span) == 0 and rel + span < p:
            val = val + incoming
        span *= 2
    return val
