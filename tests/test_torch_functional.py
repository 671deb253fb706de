"""The port's functional mirrors held against the JAX package on the CPU.

``MatchTable`` (``init_table`` / ``insert`` / ``insert_batch`` / ``probe``
/ ``probe_batch`` / ``pending_count`` / ``encode_key``), ``Ring``
(``init_ring`` / ``ring_push`` / ``ring_pop`` / ``ring_size``) and
``SyncState`` (``init_sync`` / ``sync_signal`` / ``sync_ready``) run the
same operation sequences, made with numpy from a seed, through both
packages; every returned value and every state tensor must be bitwise
equal.  The cases include the ring cases of ``tests/test_core_resources.py``
and the ``probe_batch`` case of ``tests/test_doorbell_fused.py``, keys
near 2^31 and negative keys (where the reference's uint32 multiply in
``_hash_key`` wraps), and ``encode_key`` with ranks and tags past their
bit fields.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import backlog as r_backlog
from repro.core import completion as r_completion
from repro.core import matching as r_matching
from repro.core.matching import MatchKind as RMatchKind

from repro_torch.core import (MatchKind, MatchingPolicy, encode_key,
                              init_ring, init_sync, init_table, insert,
                              insert_batch, pending_count, probe,
                              probe_batch, ring_pop, ring_push, ring_size,
                              sync_ready, sync_signal)
from repro_torch.core import matching as p_matching
from repro_torch.core.matching import MatchTable

CPU = "cpu"
SEEDS = range(6)
#: keys where the reference's uint32 hash product wraps
WIDE_KEYS = [2**31 - 1, 2**31 - 2, 2**30 + 12345, -1, -2**31, -7, 1, 0x7FFF0000]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port, ref):
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert np.array_equal(p, r), (p, r)


def _same_table(pt, rt):
    for name in ("keys", "kinds", "vals"):
        _same(getattr(pt, name), getattr(rt, name))


#: the reference's single insert, compiled once a kind (run eagerly, its
#: ``lax.cond`` traces anew on every call)
r_insert = jax.jit(r_matching.insert, static_argnums=2)


def _tables(n_buckets, cap):
    return (init_table(n_buckets, cap, device=CPU),
            r_matching.init_table(n_buckets, cap))


# ---------------------------------------------------------------------------
# MatchTable
# ---------------------------------------------------------------------------

def test_hash_key_matches_the_uint32_reference():
    keys = np.array(WIDE_KEYS + list(range(-40, 40)), np.int32)
    for n in (1, 7, 64, 65536):
        _same(p_matching._hash_key(torch.from_numpy(keys), n),
              r_matching._hash_key(jnp.asarray(keys), n))


@pytest.mark.parametrize("policy", list(MatchingPolicy))
def test_encode_key_matches_reference(policy):
    rng = np.random.default_rng(3)
    ranks = np.concatenate([rng.integers(0, 1 << 20, 16),
                            [0, 0x3FFF, 0x4000, (1 << 31) - 1]]
                           ).astype(np.int32)
    tags = np.concatenate([rng.integers(0, 1 << 24, 16),
                           [0, 0xFFFF, 0x10000, (1 << 31) - 1]]
                          ).astype(np.int32)
    want = r_matching.encode_key(jnp.asarray(ranks), jnp.asarray(tags),
                                 getattr(r_matching.MatchingPolicy,
                                         policy.name))
    _same(encode_key(torch.from_numpy(ranks), torch.from_numpy(tags),
                     policy), want)
    # host ints give a CPU key
    assert encode_key(int(ranks[0]), int(tags[0]), policy).device.type \
        == "cpu"


def test_functional_engine_matches():
    pt, rt = _tables(64, 4)
    k = int(encode_key(2, 9))
    for kind, val in ((MatchKind.SEND, 42), (MatchKind.RECV, 7)):
        pt, pm, ps = insert(pt, k, kind, val)
        rt, rm, rs = r_matching.insert(rt, jnp.int32(k), RMatchKind(kind),
                                       jnp.int32(val))
        _same(pm, rm)
        _same(ps, rs)
        _same_table(pt, rt)
    assert int(pm) == 42 and int(ps) == 1
    _same(pending_count(pt), r_matching.pending_count(rt))
    assert int(pending_count(pt)) == 0


def test_functional_bucket_overflow():
    pt, rt = _tables(1, 2)
    for i in range(1, 4):
        k = int(encode_key(i, 0))
        pt, pm, ps = insert(pt, k, MatchKind.SEND, i)
        rt, rm, rs = r_matching.insert(rt, jnp.int32(k), RMatchKind.SEND,
                                       jnp.int32(i))
        _same(pm, rm)
        _same(ps, rs)
    assert int(ps) == 2                                  # bucket full
    _same_table(pt, rt)


@pytest.mark.parametrize("seed", SEEDS)
def test_insert_sequence_matches_reference(seed):
    """A seeded sequence of single inserts (few keys, both kinds, small
    buckets so some fill up) agrees step by step."""
    rng = np.random.default_rng(seed)
    pt, rt = _tables(4, 3)
    for i in range(40):
        key = int(encode_key(int(rng.integers(0, 3)), int(rng.integers(0, 3))))
        kind = MatchKind.SEND if rng.random() < 0.5 else MatchKind.RECV
        pt, pm, ps = insert(pt, key, kind, i)
        rt, rm, rs = r_insert(rt, jnp.int32(key), RMatchKind(kind),
                              jnp.int32(i))
        _same(pm, rm)
        _same(ps, rs)
    _same_table(pt, rt)
    _same(pending_count(pt), r_matching.pending_count(rt))


def _batch(rng, n, wide):
    """``n`` keys with duplicates (drawn from a small pool), random kinds
    and values; ``wide`` draws the pool from keys near 2^31, negative
    keys and ``encode_key`` of ranks and tags past their fields."""
    if wide:
        pool = np.array(WIDE_KEYS + [int(encode_key(r, t)) for r, t in
                                     ((0x3FFF, 0xFFFF), (70000, 99999),
                                      (12345, 1 << 20))], np.int32)
    else:
        pool = np.array([int(encode_key(r, t)) for r in range(3)
                         for t in range(2)], np.int32)
    keys = pool[rng.integers(0, len(pool), n)]
    kinds = rng.integers(1, 3, n).astype(np.int32)
    vals = rng.integers(0, 1 << 30, n).astype(np.int32)
    return keys, kinds, vals


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_insert_batch_matches_reference(seed, wide):
    rng = np.random.default_rng(100 + seed)
    pt, rt = _tables(8, 4)
    for n in (1, 17, 24):
        keys, kinds, vals = _batch(rng, n, wide)
        pt, pm, ps = insert_batch(pt, torch.from_numpy(keys),
                                  torch.from_numpy(kinds),
                                  torch.from_numpy(vals))
        rt, rm, rs = r_matching.insert_batch(rt, jnp.asarray(keys),
                                             jnp.asarray(kinds),
                                             jnp.asarray(vals))
        _same(pm, rm)
        _same(ps, rs)
        _same_table(pt, rt)
    assert (_np(pm) >= 0).any()                          # some matched


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_probe_batch_matches_reference(seed, wide):
    """Store a burst of receives with duplicate keys, then probe a burst
    of sends with duplicates: each duplicate pops a distinct entry."""
    rng = np.random.default_rng(200 + seed)
    pt, rt = _tables(8, 6)
    keys, _, vals = _batch(rng, 20, wide)
    kinds = np.full(20, int(MatchKind.RECV), np.int32)
    pt, _, _ = insert_batch(pt, torch.from_numpy(keys),
                            torch.from_numpy(kinds), torch.from_numpy(vals))
    rt, _, _ = r_matching.insert_batch(rt, jnp.asarray(keys),
                                       jnp.asarray(kinds),
                                       jnp.asarray(vals))
    q = np.concatenate([keys[rng.integers(0, 20, 24)],
                        np.array([int(encode_key(9, 9))], np.int32)])
    pt, pv, ph = probe_batch(pt, torch.from_numpy(q), MatchKind.SEND)
    rt, rv, rh = r_matching.probe_batch(rt, jnp.asarray(q),
                                        int(RMatchKind.SEND))
    _same(pv, rv)
    _same(ph, rh)
    _same_table(pt, rt)
    assert _np(ph).any() and not _np(ph).all()


def test_probe_batch_case_of_the_doorbell_tests():
    """``tests/test_doorbell_fused.py``'s probe_batch case, both ways."""
    pt, rt = _tables(32, 4)
    keys = np.array([5, 9, 5, 40], np.int32)
    vals = np.array([50, 90, 51, 400], np.int32)
    recv = np.full(4, int(MatchKind.RECV), np.int32)
    pt, _, ps = insert_batch(pt, torch.from_numpy(keys),
                             torch.from_numpy(recv), torch.from_numpy(vals))
    rt, _, rs = r_matching.insert_batch(rt, jnp.asarray(keys),
                                        jnp.asarray(recv), jnp.asarray(vals))
    _same(ps, rs)
    assert list(_np(ps)) == [0, 0, 0, 0]
    q = np.array([5, 5, 9, 7, 5], np.int32)
    pt, pv, ph = probe_batch(pt, torch.from_numpy(q), int(MatchKind.SEND))
    rt, rv, rh = r_matching.probe_batch(rt, jnp.asarray(q),
                                        int(RMatchKind.SEND))
    _same(pv, rv)
    _same(ph, rh)
    assert list(_np(ph)) == [1, 1, 1, 0, 0]
    assert list(_np(pv)[:3]) == [50, 51, 90]             # FIFO dups
    pt, v, hit = probe(pt, 9, int(MatchKind.SEND))
    rt, rv, rhit = r_matching.probe(rt, jnp.int32(9), int(RMatchKind.SEND))
    _same(v, rv)
    _same(hit, rhit)
    assert not bool(hit)
    _same_table(pt, rt)


def test_the_table_is_a_value():
    """The functional form returns a new table and leaves its input as it
    was (the host engine's port mutates; this one must not)."""
    t0 = init_table(4, 2, device=CPU)
    before = [x.clone() for x in (t0.keys, t0.kinds, t0.vals)]
    t1, _, _ = insert(t0, 5, MatchKind.RECV, 1)
    t2, _, _ = insert_batch(t1, torch.tensor([5, 6]), torch.tensor([1, 2]),
                            torch.tensor([2, 3]))
    k1 = t1.keys.clone()
    probe_batch(t2, torch.tensor([6]), MatchKind.SEND)
    for x, b in zip((t0.keys, t0.kinds, t0.vals), before):
        assert torch.equal(x, b)
    assert torch.equal(t1.keys, k1)
    assert isinstance(t2, MatchTable) and int(pending_count(t2)) == 1


def test_empty_batches():
    pt, rt = _tables(4, 2)
    e = np.zeros(0, np.int32)
    pt, pm, ps = insert_batch(pt, torch.from_numpy(e), torch.from_numpy(e),
                              torch.from_numpy(e))
    rt, rm, rs = r_matching.insert_batch(rt, jnp.asarray(e), jnp.asarray(e),
                                         jnp.asarray(e))
    _same(pm, rm)
    _same(ps, rs)
    pt, pv, ph = probe_batch(pt, torch.from_numpy(e), MatchKind.SEND)
    rt, rv, rh = r_matching.probe_batch(rt, jnp.asarray(e),
                                        int(RMatchKind.SEND))
    _same(pv, rv)
    _same(ph, rh)


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_ring_fifo_matches_reference(seed):
    """``tests/test_core_resources.py``'s ring FIFO property on a seeded
    op sequence, through both packages at once."""
    rng = np.random.default_rng(300 + seed)
    pr, rr = init_ring(8, 1, device=CPU), r_backlog.init_ring(8, 1)
    model, pushed = [], 0
    for is_push in rng.random(100) < (0.3 + 0.1 * seed):
        if is_push:
            pr, ps = ring_push(pr, [pushed])
            rr, rs = r_backlog.ring_push(rr, [pushed])
            _same(ps, rs)
            if int(ps) == 0:
                model.append(pushed)
            pushed += 1
        else:
            pr, prec, ps = ring_pop(pr)
            rr, rrec, rs = r_backlog.ring_pop(rr)
            _same(prec, rrec)
            _same(ps, rs)
            if int(ps) == 0:
                assert model and int(prec[0]) == model.pop(0)
            else:
                assert not model
        _same(ring_size(pr), r_backlog.ring_size(rr))
    for name in ("buf", "head", "tail"):
        _same(getattr(pr, name), getattr(rr, name))
    assert int(ring_size(pr)) == len(model)


def test_ring_float_records_and_full():
    pr = init_ring(2, 3, torch.float32, device=CPU)
    rr = r_backlog.init_ring(2, 3, jnp.float32)
    rows = np.arange(9, dtype=np.float32).reshape(3, 3) + 0.5
    for row in rows:                                   # the third is full
        pr, ps = ring_push(pr, torch.from_numpy(row))
        rr, rs = r_backlog.ring_push(rr, jnp.asarray(row))
        _same(ps, rs)
    assert int(ps) == 1
    _same(pr.buf, rr.buf)
    pr0 = pr
    pr, rec, _ = ring_pop(pr)
    rr, rrec, _ = r_backlog.ring_pop(rr)
    _same(rec, rrec)
    assert int(ring_size(pr0)) == 2                    # the input is a value


# ---------------------------------------------------------------------------
# SyncState
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expected,max_signals,n", [(3, 0, 5), (1, 4, 2),
                                                    (0, 0, 1)])
def test_sync_matches_reference(expected, max_signals, n):
    """Signals past the payload's last slot overwrite it, as the
    reference's clamped index does; ready flips at ``expected``."""
    rng = np.random.default_rng(expected + 10 * n)
    ps = init_sync(expected, 2, max_signals, device=CPU)
    rs = r_completion.init_sync(expected, 2, max_signals)
    _same(sync_ready(ps), r_completion.sync_ready(rs))
    for rec in rng.normal(size=(n, 2)).astype(np.float32):
        ps = sync_signal(ps, torch.from_numpy(rec))
        rs = r_completion.sync_signal(rs, jnp.asarray(rec))
        _same(sync_ready(ps), r_completion.sync_ready(rs))
        for name in ("expected", "received", "payload"):
            _same(getattr(ps, name), getattr(rs, name))
    assert bool(sync_ready(ps))
