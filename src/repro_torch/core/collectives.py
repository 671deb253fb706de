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

from typing import Callable, List, NamedTuple, Optional, Sequence

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

class Chunks(NamedTuple):
    """The shards of x that an all-gather ring moved to this rank, kept
    for its transpose (the residuals JAX's AD keeps): ``fwd[j-1]`` came
    ``j`` hops along the +1 ring (shard ``idx - j``), ``bwd[j-1]`` ``j``
    hops along the −1 ring (shard ``idx + j``); in BSP ``gathered`` is
    the monolithic gather's result."""
    fwd: List[torch.Tensor]
    bwd: List[torch.Tensor]
    gathered: Optional[torch.Tensor] = None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, rank_axis: Axis,
                      config: CommConfig = DEFAULT, *,
                      keep_chunks: bool = False):
    """``x``: (m_shard, ..., k) sharded on dim 0 over ``rank_axis``; ``w``:
    (k, n) local.  Returns (m_shard*P, ..., n) = ``allgather(x) @ w``, and
    with ``keep_chunks`` also the :class:`Chunks` the ring moved (for
    :func:`all_gather_matmul_t`).

    LCI modes compute ``x_i @ w`` while the ring moves ``x_{i+1}`` (the
    collective-matmul overlap: matmul i waits only on shard i's
    arrival)."""
    out, chunks = _all_gather_matmul(x, w, rank_axis, config)
    return (out, chunks) if keep_chunks else out


def _all_gather_matmul(x, w, rank_axis, config):
    if config.mode == CommMode.BSP:
        xg = rank_axis.all_gather(x, 0)
        return torch.matmul(xg, w).to(x.dtype), Chunks([], [], xg)

    ra = rank_axis
    p, idx = ra.size, ra.index
    m_shard = x.shape[0]
    out = torch.empty((m_shard * p,) + tuple(x.shape[1:-1]) + (w.shape[1],),
                      dtype=x.dtype, device=x.device)
    chunks = Chunks([], [])

    def mm(cur):
        return _mm32(cur, w)

    if p == 1:
        _put(out, mm(x).to(x.dtype), 0, 0)
        return out, chunks

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
                chunks.fwd.append(cur)
        return out, chunks

    # dedicated: counter-rotating rings, a matmul per arrival
    hf = ra.ppermute_start(x, _ring_perm(p, +1), channel=0)
    hb = ra.ppermute_start(x, _ring_perm(p, -1), channel=1)
    _put(out, mm(x).to(x.dtype), 0, idx * m_shard)
    for j in range(1, sf + 1):
        cf = hf.wait()
        chunks.fwd.append(cf)
        hf = (ra.ppermute_start(cf, _ring_perm(p, +1), channel=0)
              if j < sf else None)
        _put(out, mm(cf).to(x.dtype), 0, ((idx - j) % p) * m_shard)
        if j <= sb:
            cb = hb.wait()
            chunks.bwd.append(cb)
            hb = (ra.ppermute_start(cb, _ring_perm(p, -1), channel=1)
                  if j < sb else None)
            _put(out, mm(cb).to(x.dtype), 0, ((idx + j) % p) * m_shard)
    return out, chunks


# ---------------------------------------------------------------------------
# the reduce rings (matmul reduce-scatter, reduce-scatter)
# ---------------------------------------------------------------------------

def _reduce_rings(ra: Axis, config: CommConfig, rings: Sequence) -> List:
    """Run the reduce rings of ``rings`` (``(contrib, direction)``, where
    ``contrib(dst)`` is this rank's float32 contribution to rank ``dst``'s
    piece) side by side: every step posts each ring's hop, then adds the
    next contributions while the hops move.  Returns each ring's float32
    accumulator."""
    p = ra.size
    accs = [contrib(_dst(ra, 0, d)) for contrib, d in rings]
    wire = torch.bfloat16 if config.wire_bf16 else None
    for i in range(1, p):
        hs = []
        for (contrib, d), acc in zip(rings, accs):
            payload = acc.to(wire) if wire is not None else acc
            hs.append(ra.ppermute_start(payload, _ring_perm(p, d),
                                        channel=_channel(config, d)))
        nxt = [contrib(_dst(ra, i, d)) for contrib, d in rings]
        accs = [h.wait().float() + c for h, c in zip(hs, nxt)]
    return accs


def _dst(ra: Axis, i: int, direction: int) -> int:
    """The rank whose piece a reduce ring's step ``i`` contribution is."""
    p, idx = ra.size, ra.index
    if direction == +1:
        return (idx + p - 1 - i) % p
    return (idx + i + 1) % p


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
# the transposes: what JAX's AD makes of the reference's rings
# ---------------------------------------------------------------------------
#
# A ring's transpose runs the reverse ring (each ``ppermute`` with its
# inverse permutation, on the channel of its own direction) and carries
# the cotangents of what the forward sent: a gather ring's in the
# shards' dtype, summed at each rank in that dtype; a reduce ring's in
# its accumulator's (float32, or bf16 under ``wire_bf16``), relayed.

def _gather_chains(ra: Axis, config: CommConfig, at: Callable) -> List:
    """The chains of a gather ring's transpose: ``(contrib, hops,
    direction)`` a ring that moved shards here, ``contrib(j)`` the
    cotangent of the shard that came ``j`` hops (``at(pos)``: that of
    shard ``pos``)."""
    p, idx = ra.size, ra.index
    sf = p // 2
    sb = p - 1 - sf
    if config.mode != CommMode.LCI_DEDICATED or sb == 0:
        return [(lambda j: at((idx - j) % p), p - 1, +1)]
    return [(lambda j: at((idx - j) % p), sf, +1),
            (lambda j: at((idx + j) % p), sb, -1)]


def _reverse_gather_rings(ra: Axis, config: CommConfig, chains: Sequence,
                          own: torch.Tensor) -> torch.Tensor:
    """``own`` plus what each chain of :func:`_gather_chains` delivers
    back here: the cotangent of its farthest shard goes back along the
    reverse ring, and each rank adds its own for the next shard before
    passing it on (the next one is computed while the hop moves)."""
    p = ra.size
    accs = [None] * len(chains)
    for t in range(max([h for _, h, _ in chains] or [0]), 0, -1):
        hs = []
        for k, (contrib, hops, d) in enumerate(chains):
            if hops < t:
                hs.append(None)
                continue
            if accs[k] is None:
                accs[k] = contrib(t)
            hs.append(ra.ppermute_start(accs[k], _ring_perm(p, -d),
                                        channel=_channel(config, -d)))
        nxt = [contrib(t - 1) if h is not None and t > 1 else None
               for (contrib, _, _), h in zip(chains, hs)]
        for k, h in enumerate(hs):
            if h is not None:
                got = h.wait()
                accs[k] = got if nxt[k] is None else got + nxt[k]
    for acc in accs:
        if acc is not None:            # a chain of no hop (P = 1)
            own = own + acc
    return own


def _reverse_reduce_rings(ra: Axis, config: CommConfig, rings: Sequence
                          ) -> None:
    """The transpose of :func:`_reduce_rings`: ``rings`` holds ``(g,
    direction, use)`` a ring, ``g`` the cotangent of its accumulator's
    columns of the output.  Each ring relays the float32 cotangent back
    along the reverse ring (bf16 on the wire under ``wire_bf16``), and
    ``use(dst, c)`` takes the cotangent ``c`` of this rank's contribution
    to rank ``dst``'s piece while the next hop moves."""
    p = ra.size
    wire = torch.bfloat16 if config.wire_bf16 else None
    cs = [g.float() for g, _, _ in rings]
    for i in range(p - 1, 0, -1):
        hs = [ra.ppermute_start(c.to(wire) if wire is not None else c,
                                _ring_perm(p, -d),
                                channel=_channel(config, -d))
              for c, (_, d, _) in zip(cs, rings)]
        for c, (_, d, use) in zip(cs, rings):
            use(_dst(ra, i, d), c)
        cs = [h.wait().float() for h in hs]
    for c, (_, d, use) in zip(cs, rings):
        use(_dst(ra, 0, d), c)


def _wgrad32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``xᵀ g`` over every leading dim, float32 accumulation: (k, n)."""
    return _mm32(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))


def all_gather_t(g: torch.Tensor, rank_axis: Axis,
                 config: CommConfig = DEFAULT, *, axis: int = 0
                 ) -> torch.Tensor:
    """The transpose of :func:`all_gather`: BSP a ``psum_scatter``; the
    LCI modes the reverse rings, g's slices summed in g's dtype."""
    ra = rank_axis
    axis %= g.ndim
    if config.mode == CommMode.BSP:
        return ra.psum_scatter(g, axis)
    shard = g.shape[axis] // ra.size

    def at(pos):
        return g.narrow(axis, pos * shard, shard)
    return _reverse_gather_rings(ra, config, _gather_chains(ra, config, at),
                                 at(ra.index))


def all_gather_matmul_t(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        chunks: Chunks, rank_axis: Axis,
                        config: CommConfig = DEFAULT):
    """``(dx, dw)`` of :func:`all_gather_matmul` from the output's
    cotangent ``g`` and the ring's :class:`Chunks`: dx runs the reverse
    rings (the cotangents in x's dtype), dw sums ``chunkᵀ g`` over the
    shards the forward ring moved (float32, rounded once); no second
    gather."""
    ra = rank_axis
    wt = w.t()
    if config.mode == CommMode.BSP:
        dxg = torch.matmul(g, wt).to(x.dtype)
        return (ra.psum_scatter(dxg, 0),
                _wgrad32(chunks.gathered, g).to(w.dtype))
    p, idx = ra.size, ra.index
    m = x.shape[0]

    def rows(pos):
        return g.narrow(0, pos * m, m)

    def dx_at(pos):
        return _mm32(rows(pos), wt).to(x.dtype)

    dw = _wgrad32(x, rows(idx))
    for j, c in enumerate(chunks.fwd, 1):
        dw += _wgrad32(c, rows((idx - j) % p))
    for j, c in enumerate(chunks.bwd, 1):
        dw += _wgrad32(c, rows((idx + j) % p))
    dx = _reverse_gather_rings(ra, config, _gather_chains(ra, config, dx_at),
                               dx_at(idx))
    return dx, dw.to(w.dtype)


def matmul_reduce_scatter_t(x: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor, rank_axis: Axis,
                            config: CommConfig = DEFAULT):
    """``(dx, dw)`` of :func:`matmul_reduce_scatter`: BSP all-gathers g;
    the LCI modes relay g along the reverse rings in the accumulators'
    dtype, each arrival multiplied in place (dx's pieces summed in x's
    dtype, dw in float32, rounded once)."""
    ra = rank_axis
    if config.mode == CommMode.BSP:
        gf = ra.all_gather(g, 0)
        return (torch.matmul(gf, w.t()).to(x.dtype),
                _wgrad32(x, gf).to(w.dtype))
    p = ra.size
    ms = x.shape[0] // p
    n = w.shape[1]
    dx = torch.zeros_like(x)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

    def use(lo, hi):
        wt = w[:, lo:hi].t()

        def take(d, c):
            c = c.to(g.dtype)         # g's own values: exact
            dx.narrow(0, d * ms, ms).add_(_mm32(c, wt).to(x.dtype))
            dw[:, lo:hi] += _wgrad32(x.narrow(0, d * ms, ms), c)
        return take

    if config.mode == CommMode.LCI_DEDICATED and p > 1 and n % 2 == 0:
        h = n // 2
        _reverse_reduce_rings(ra, config, [(g[..., :h], +1, use(0, h)),
                                           (g[..., h:], -1, use(h, n))])
    else:
        _reverse_reduce_rings(ra, config, [(g, +1, use(0, n))])
    return dx, dw.to(w.dtype)


def reduce_scatter_t(g: torch.Tensor, rank_axis: Axis,
                     config: CommConfig = DEFAULT, *, axis: int = 0
                     ) -> torch.Tensor:
    """The transpose of :func:`reduce_scatter`: BSP an ``all_gather``; the
    LCI modes relay g along the reverse rings in float32 (bf16 under
    ``wire_bf16``), each arrival one piece of the result."""
    ra = rank_axis
    axis %= g.ndim
    if config.mode == CommMode.BSP:
        return ra.all_gather(g, axis)
    p, shard = ra.size, g.shape[axis]
    dx = torch.empty(g.shape[:axis] + (shard * p,) + g.shape[axis + 1:],
                     dtype=g.dtype, device=g.device)
    feat = g.ndim - 1

    def use(lo, hi):
        def take(d, c):
            dx.narrow(axis, d * shard, shard).narrow(
                feat, lo, hi - lo).copy_(c)
        return take

    n = g.shape[feat]
    if (config.mode == CommMode.LCI_DEDICATED and p > 1
            and feat != axis and n % 2 == 0):
        h = n // 2
        _reverse_reduce_rings(ra, config, [(g.narrow(feat, 0, h), +1,
                                            use(0, h)),
                                           (g.narrow(feat, h, h), -1,
                                            use(h, n))])
    else:
        _reverse_reduce_rings(ra, config, [(g, +1, use(0, n))])
    return dx


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
