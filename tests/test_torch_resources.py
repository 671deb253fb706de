"""Resource tables of the PyTorch port held against the JAX package.

The same numpy-seeded op sequences go through both packages and must give
the same ids, statuses and tables:

* the host packet pool (``get``/``get_n``/``put_n``, steal-half with the
  per-lane ``default_rng(seed + i)`` victim choice) and the host matching
  engine (``insert``/``match_now_n``/``match_now_burst``);
* the functional slot pool — reference ``jnp`` arrays vs port ``int32``
  tensors — over the cases of ``tests/test_burst.py`` and
  ``tests/test_doorbell_fused.py`` plus random sequences with negative
  steal seeds (``jnp.remainder`` vs ``torch.remainder``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.status import ErrorCode


def _pool_state(pool):
    if isinstance(pool.slots, torch.Tensor):
        return port.pool_to_numpy(pool)
    return np.asarray(pool.slots), np.asarray(pool.count)


def _same_pool(rp, tp):
    rs, rc = _pool_state(rp)
    ts, tc = _pool_state(tp)
    assert np.array_equal(rs, ts) and np.array_equal(rc, tc)


def _i(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# host resources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_packet_pool_sequences_agree(seed):
    rng = np.random.default_rng(seed)
    n_lanes = int(rng.integers(1, 5))
    pools = [m.HostPacketPool(n_lanes, 8, packet_bytes=16, seed=seed)
             for m in (ref, port)]
    held = [[] for _ in range(n_lanes)]
    for _ in range(60):
        lane = int(rng.integers(n_lanes))
        op = rng.integers(3)
        if op == 0:
            n = int(rng.integers(1, 12))
            (a, sa), (b, sb) = (p.get_n(lane, n) for p in pools)
            assert a == b and (sa.kind, sa.code) == (sb.kind, sb.code)
            held[lane] += a
        elif op == 1:
            (a, sa), (b, sb) = (p.get(lane) for p in pools)
            assert a == b and (sa.kind, sa.code) == (sb.kind, sb.code)
            if a >= 0:
                held[lane].append(a)
        elif held[lane]:
            k = int(rng.integers(1, len(held[lane]) + 1))
            back, held[lane] = held[lane][:k], held[lane][k:]
            for p in pools:
                p.put_n(lane, back)
        assert pools[0].free_packets() == pools[1].free_packets()
        assert pools[0].steals == pools[1].steals
    assert pools[0].telemetry_counters() == pools[1].telemetry_counters()


@pytest.mark.parametrize("seed", [0, 1])
def test_host_matching_sequences_agree(seed):
    rng = np.random.default_rng(seed)
    engines = [m.HostMatchingEngine(64, 4) for m in (ref, port)]
    pols = [ref.MatchingPolicy, port.MatchingPolicy]
    kinds = [ref.MatchKind, port.MatchKind]
    for step in range(80):
        rank, tag = int(rng.integers(3)), int(rng.integers(4))
        pol = ["RANK_TAG", "RANK_ONLY", "TAG_ONLY"][int(rng.integers(3))]
        keys = [m.make_key(rank, tag, p[pol]) for m, p in zip((ref, port),
                                                              pols)]
        assert keys[0] == keys[1]
        op = rng.integers(3)
        kind = ["SEND", "RECV"][int(rng.integers(2))]
        if op == 0:
            out = [e.insert(k, mk[kind], ("v", step))
                   for e, k, mk in zip(engines, keys, kinds)]
        elif op == 1:
            n = int(rng.integers(1, 4))
            out = [e.match_now_n(k, mk[kind], n)
                   for e, k, mk in zip(engines, keys, kinds)]
        else:
            ks = [int(rng.integers(3)) for _ in range(int(rng.integers(1, 5)))]
            out = [e.match_now_burst([m.make_key(r, 0, p.RANK_TAG)
                                      for r in ks], mk[kind])
                   for e, m, p, mk in zip(engines, (ref, port), pols, kinds)]
        assert out[0] == out[1]
    assert engines[0].telemetry_counters() == engines[1].telemetry_counters()


# ---------------------------------------------------------------------------
# functional slot pool
# ---------------------------------------------------------------------------

def _both_pools(*args, **kw):
    return ref.init_pool(*args, **kw), port.init_pool(*args, **kw,
                                                      device="cpu")


def test_pool_from_numpy_round_trips():
    rp = ref.init_pool(3, 5, lane_cap=9)
    tp = port.pool_from_numpy(np.asarray(rp.slots), np.asarray(rp.count),
                              "cpu")
    assert tp.slots.dtype == torch.int32 and tp.count.dtype == torch.int32
    _same_pool(rp, tp)
    s, c = port.pool_to_numpy(tp)
    tp2 = port.pool_from_numpy(s, c, "cpu")
    assert torch.equal(tp2.slots, tp.slots)
    assert torch.equal(tp2.count, tp.count)


def test_init_buffers_converts_through_numpy():
    rb = np.array(ref.init_buffers(4, 16))         # a writable host copy
    tb = port.init_buffers(4, 16, device="cpu")
    assert torch.equal(torch.from_numpy(rb), tb) and tb.dtype == torch.uint8


@pytest.mark.parametrize("case", [
    # (n_lanes, ppl, lane_cap, [(lane, n, seed), ...]) — the cases of
    # tests/test_burst.py:188-215 plus negative steal seeds
    (2, 8, None, [(0, 5, 3), (0, 5, 3)]),
    (1, 4, None, [(0, 6, 0)]),
    (2, 8, 8, [(0, 9, 0)]),
    (3, 4, None, [(1, 6, -1), (1, 3, -7), (1, 4, -(2 ** 31))]),
    (4, 2, None, [(2, 3, -5), (2, 2, 11), (0, 8, -2)]),
], ids=["sequential", "short_pads", "steal_clamped", "neg_seed_3",
        "neg_seed_4"])
def test_pool_get_n_agrees(case):
    n_lanes, ppl, cap, ops = case
    rp, tp = _both_pools(n_lanes, ppl, cap)
    for lane, n, seed in ops:
        rp, rids, rgot, rst = ref.pool_get_n(rp, lane, n, seed)
        tp, tids, tgot, tst = port.pool_get_n(tp, lane, n, seed)
        assert np.array_equal(_i(rids), _i(tids))
        assert int(rgot) == int(tgot) and int(rst) == int(tst)
        _same_pool(rp, tp)
    assert int(ref.free_count(rp)) == int(port.free_count(tp))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_random_sequences_agree(seed):
    """Random get / get_n / put sequences, steal seeds of both signs."""
    rng = np.random.default_rng(seed)
    n_lanes = int(rng.integers(1, 5))
    rp, tp = _both_pools(n_lanes, 3)
    held = []
    for _ in range(14):
        lane = int(rng.integers(n_lanes))
        sseed = int(rng.integers(-50, 50))
        op = rng.integers(3)
        if op == 0:
            rp, rid, rst = ref.pool_get(rp, lane, sseed)
            tp, tid, tst = port.pool_get(tp, lane, sseed)
            assert int(rid) == int(tid) and int(rst) == int(tst)
            if int(rid) >= 0:
                held.append((lane, int(rid)))
        elif op == 1:
            n = int(rng.integers(1, 5))
            rp, rids, rgot, rst = ref.pool_get_n(rp, lane, n, sseed)
            tp, tids, tgot, tst = port.pool_get_n(tp, lane, n, sseed)
            assert np.array_equal(_i(rids), _i(tids))
            assert int(rgot) == int(tgot) and int(rst) == int(tst)
            held += [(lane, int(i)) for i in _i(tids) if i >= 0]
        elif held:
            lane, pid = held.pop(int(rng.integers(len(held))))
            rp, rst = ref.pool_put(rp, lane, pid)
            tp, tst = port.pool_put(tp, lane, pid)
            assert int(rst) == int(tst)
        _same_pool(rp, tp)


@pytest.mark.parametrize("lane_count", [1, 3])
def test_pool_get_victim_never_self_negative_seeds(lane_count):
    """The steal path with negative seeds picks the same victim in both
    packages (``remainder``, not ``fmod``)."""
    for seed in (-1, -2, -(2 ** 31), 5):
        rp, tp = _both_pools(lane_count, 2)
        for _ in range(2):
            rp, _, _ = ref.pool_get(rp, 0, 0)
            tp, _, _ = port.pool_get(tp, 0, 0)
        rp, rid, rst = ref.pool_get(rp, 0, seed)
        tp, tid, tst = port.pool_get(tp, 0, seed)
        assert (int(rid), int(rst)) == (int(tid), int(tst))
        _same_pool(rp, tp)


@pytest.mark.parametrize("case", [
    # tests/test_doorbell_fused.py:193-226: full burst, short grab, and a
    # steal with a negative seed
    (1, 8, 8, 16, (4, 10), 0),
    (1, 2, 2, 8, (5, 8), 0),
    (3, 2, 6, 12, (3, 12), -4),
], ids=["full_burst", "short_grab", "neg_seed_steal"])
def test_pool_get_copy_n_agrees(case):
    n_lanes, ppl, n_packets, packet_bytes, shape, seed = case
    rng = np.random.default_rng(7)
    payload = rng.integers(1, 256, shape).astype(np.uint8)
    buf0 = rng.integers(0, 256, (n_packets, packet_bytes)).astype(np.uint8)
    rp, tp = _both_pools(n_lanes, ppl)
    rp, rbuf, rids, rgot, rst = ref.pool_get_copy_n(
        rp, jnp.asarray(buf0), 0, jnp.asarray(payload), seed)
    tp, tbuf, tids, tgot, tst = port.pool_get_copy_n(
        tp, torch.from_numpy(buf0.copy()), 0, torch.from_numpy(payload),
        seed)
    assert np.array_equal(np.asarray(rbuf), tbuf.numpy())
    assert np.array_equal(_i(rids), _i(tids))
    assert int(rgot) == int(tgot) and int(rst) == int(tst)
    _same_pool(rp, tp)


def test_pool_get_copy_n_oversize_raises():
    tp = port.init_pool(1, 2, device="cpu")
    buf = port.init_buffers(2, 8, device="cpu")
    with pytest.raises(ValueError):
        port.pool_get_copy_n(tp, buf, 0, torch.zeros((1, 9), dtype=torch.uint8),
                             0)


def test_retry_status_codes_line_up():
    """The functional pools' in-graph retry (1) is the host pool's
    RETRY_NOPACKET in both packages."""
    hp = port.HostPacketPool(1, 1)
    hp.get(0)
    pid, st = hp.get(0)
    assert pid == -1 and st.code == ErrorCode.RETRY_NOPACKET
    tp = port.init_pool(1, 1, device="cpu")
    tp, _, _ = port.pool_get(tp, 0, 0)
    tp, pid, st = port.pool_get(tp, 0, 0)
    assert int(pid) == -1 and int(st) == 1
