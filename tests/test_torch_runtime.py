"""The PyTorch port's message path held against the JAX package, on the CPU.

* one numpy-seeded op sequence through ``LocalCluster(2)`` of both
  packages (the port with ``device="cpu"``, payloads as numpy arrays or
  CPU tensors) gives the same statuses, prefix-accept split points and
  delivered bytes — over endpoint widths 1/2/4, ``post_am_many`` and
  ``post_send_many``, pool and fabric back-pressure splits, and
  ``wire_bf16`` on and off;
* the fused-vs-scalar equivalence of ``tests/test_doorbell_fused.py``
  holds inside the port;
* a walk of ``examples/quickstart.py`` §1-§9 runs on the port;
* construction without a device raises where there is no GPU, and the
  configurations once refused as not ported (the ``shm`` and ``socket``
  backends, the chaos faults, ``reliability="on"``) construct and run.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                              # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as port
from repro_torch.core.progress.fabric import WireKind


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cluster(m, attrs, depth, **kw):
    if m is port:
        kw["device"] = "cpu"
    return m.LocalCluster(2, attrs=attrs, fabric_depth=depth, **kw)


def _drain(cq):
    out = []
    while True:
        s = cq.pop()
        if not s.is_done():
            return out
        out.append((s.tag, _np(s.get_buffer()).tobytes()))


# ---------------------------------------------------------------------------
# one op sequence, both packages
# ---------------------------------------------------------------------------

def _sequence(seed):
    """Bursts of (kind, sizes, tags, dtype) from a numpy seed: uniform
    f32 runs (the bf16 path), uniform and ragged uint8 runs, repeated
    payload objects, and runs shorter than fused_min_burst."""
    rng = np.random.default_rng(seed)
    bursts = []
    for b in range(10):
        kind = "am" if rng.random() < 0.6 else "send"
        k = int(rng.integers(2, 12))
        shape = rng.integers(4)
        if shape == 0:                      # uniform f32
            n = int(rng.integers(1, 6))
            payloads = [rng.standard_normal(n).astype(np.float32)
                        for _ in range(k)]
        elif shape == 1:                    # one object repeated
            payloads = [rng.standard_normal(3).astype(np.float32)] * k
        elif shape == 2:                    # uniform bytes
            n = int(rng.integers(1, 24))
            payloads = [rng.integers(0, 256, n).astype(np.uint8)
                        for _ in range(k)]
        else:                               # ragged bytes
            payloads = [rng.integers(0, 256, int(rng.integers(1, 24)))
                        .astype(np.uint8) for _ in range(k)]
        tags = [int(t) for t in rng.integers(0, 3, k)]
        bursts.append((kind, payloads, tags))
    return bursts


def _drive(m, scenario, seed, tensors):
    width, bf16, em, ppl, depth = scenario
    attrs = {"eager_max_bytes": em, "packets_per_lane": ppl,
             "wire_bf16": bf16, "packet_bytes": 64}
    cl = _cluster(m, attrs, depth)
    eps = cl.alloc_endpoint(n_devices=width, name="seq")
    cq = cl[1].alloc_cq()
    rcomp = cl[1].register_rcomp(cq)
    rq = cl[1].alloc_cq()
    trace = []

    def pump():
        for _ in range(4):
            for ep in eps:
                ep.progress()

    recv_bufs = []
    for kind, payloads, tags in _sequence(seed):
        if m is port and tensors:
            if len(set(map(id, payloads))) == 1:
                payloads = [torch.from_numpy(payloads[0])] * len(payloads)
            else:
                payloads = [torch.from_numpy(p) for p in payloads]
        if kind == "send":
            for t, p in zip(tags, payloads):
                rb = np.zeros(int(p.nbytes), np.uint8)
                if m is port and tensors:
                    rb = torch.from_numpy(rb)
                recv_bufs.append(rb)
                m.post_recv(cl[1], 0, rb, tag=t, local_comp=rq)
        while payloads:
            if kind == "am":
                sts = eps[0].post_am_many(1, payloads, rcomp, tags=tags)
            else:
                sts = eps[0].post_send_many(1, payloads, tags=tags)
            ok = sum(1 for s in sts if not s.is_retry())
            trace.append((kind, ok, [(int(s.kind), int(s.code))
                                     for s in sts]))
            payloads, tags = payloads[ok:], tags[ok:]
            pump()
    cl.quiesce()
    pump()
    return {"trace": trace, "am": _drain(cq), "recv_done": len(_drain(rq)),
            "recv": [_np(b).tobytes() for b in recv_bufs],
            "stats": dataclasses.asdict(cl[0].stats),
            "free": [rt.get_attr("free_packets") for rt in cl.runtimes]}


_SCENARIOS = {
    # (width, wire_bf16, eager_max_bytes, packets_per_lane, fabric_depth)
    "w1_plain": (1, False, 64, 64, 4096),
    "w2_bf16": (2, True, 64, 64, 4096),
    "w4_pool_splits": (4, False, 8, 2, 4096),
    "w2_fabric_splits": (2, False, 64, 64, 5),
    "w4_bf16_both_splits": (4, True, 8, 2, 7),
}


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_op_sequence_matches_reference(name, tensors):
    scenario = _SCENARIOS[name]
    want = _drive(ref, scenario, seed=3, tensors=False)
    got = _drive(port, scenario, seed=3, tensors=tensors)
    assert got["trace"] == want["trace"]          # statuses + split points
    assert got["am"] == want["am"]                # delivered AM bytes
    assert got["recv"] == want["recv"]            # bytes landed in recvs
    assert got["recv_done"] == want["recv_done"]
    assert got["stats"] == want["stats"]
    assert got["free"] == want["free"]
    assert sum(ok for _, ok, _ in want["trace"]) > 0
    if "splits" in name:                  # back-pressure really split
        assert any(ok < len(sts) for _, ok, sts in want["trace"])


# ---------------------------------------------------------------------------
# fused == scalar data plane, inside the port (tests/test_doorbell_fused.py)
# ---------------------------------------------------------------------------

def _pcluster(fused, *, em=16, ppl=64, depth=1 << 16):
    return port.LocalCluster(2, attrs={"eager_max_bytes": em,
                                       "doorbell_fused": fused,
                                       "packets_per_lane": ppl,
                                       "pool_lanes": 1},
                             fabric_depth=depth, device="cpu")


def _pump(eps, rounds=6):
    for _ in range(rounds):
        for ep in eps:
            ep.progress()


def _sig(sts):
    return [(s.kind, s.code) for s in sts]


def _drive_am(fused, sizes, tags, em, ppl, depth):
    cl = _pcluster(fused, em=em, ppl=ppl, depth=depth)
    eps = cl.alloc_endpoint(n_devices=1, name="ep")
    cq = cl[1].alloc_cq()
    rc = cl[1].register_rcomp(cq)
    bufs = [torch.arange(sz, dtype=torch.uint8) + (3 * i) % 251
            for i, sz in enumerate(sizes)]
    sts = eps[0].post_am_many(1, bufs, rc, tags=list(tags))
    _pump(eps)
    return _sig(sts), sorted(_drain(cq))


def _drive_send(fused, sizes, tags, recv_tags, em, ppl, depth):
    cl = _pcluster(fused, em=em, ppl=ppl, depth=depth)
    eps = cl.alloc_endpoint(n_devices=1, name="ep")
    scq, dcq = cl[0].alloc_cq(), cl[1].alloc_cq()
    recvs = [torch.zeros(max(sizes, default=1), dtype=torch.uint8)
             for _ in recv_tags]
    for rb, t in zip(recvs, recv_tags):
        port.post_recv(cl[1], 0, rb, tag=t, local_comp=dcq)
    bufs = [torch.arange(sz, dtype=torch.uint8) + (5 * i) % 251
            for i, sz in enumerate(sizes)]
    sts = eps[0].post_send_many(1, bufs, tags=list(tags), local_comp=scq)
    _pump(eps, rounds=8)
    return (_sig(sts), len(_drain(dcq)), len(_drain(scq)),
            [rb.numpy().tobytes() for rb in recvs])


class TestFusedScalarEquivalence:
    @settings(max_examples=10, deadline=None)
    @given(st.lists(st.tuples(st.integers(1, 32), st.integers(0, 2)),
                    min_size=1, max_size=20),
           st.integers(0, 2))
    def test_am_equivalence(self, ops, scenario):
        sizes = [s for s, _ in ops]
        tags = [t for _, t in ops]
        em, ppl, depth = [(16, 64, 1 << 16), (8, 4, 1 << 16),
                          (16, 64, 3)][scenario]
        assert _drive_am(True, sizes, tags, em, ppl, depth) == \
            _drive_am(False, sizes, tags, em, ppl, depth)

    @settings(max_examples=8, deadline=None)
    @given(st.lists(st.tuples(st.integers(1, 24), st.integers(0, 1)),
                    min_size=1, max_size=12),
           st.lists(st.integers(0, 1), min_size=0, max_size=12))
    def test_send_equivalence(self, ops, recv_tags):
        sizes = [s for s, _ in ops]
        tags = [t for _, t in ops]
        assert _drive_send(True, sizes, tags, recv_tags, 8, 64, 1 << 16) \
            == _drive_send(False, sizes, tags, recv_tags, 8, 64, 1 << 16)


def test_fused_run_is_one_descriptor():
    cl = _pcluster(True)
    eps = cl.alloc_endpoint(n_devices=1, name="ep")
    rc = cl[1].register_rcomp(cl[1].alloc_cq())
    eps[0].post_am_many(1, [torch.zeros(4, dtype=torch.uint8)] * 8, rc)
    out = cl[0].fabric.drain(1, eps[0].devices[0].index)
    assert len(out) == 1 and out[0].kind == WireKind.EAGER_PACKED_AM
    assert out[0].payload.count == 8
    assert isinstance(out[0].payload.data, torch.Tensor)
    assert out[0].payload.data.stride(0) == 0     # one snapshot, broadcast


def test_short_runs_ride_the_scalar_path():
    cl = _pcluster(True)
    eps = cl.alloc_endpoint(n_devices=1, name="ep")
    rc = cl[1].register_rcomp(cl[1].alloc_cq())
    before = cl[0].fabric.pushes
    k = cl[0].fused_min_burst - 1
    eps[0].post_am_many(1, [torch.zeros(4, dtype=torch.uint8)] * k, rc)
    assert cl[0].fabric.pushes - before == k


# ---------------------------------------------------------------------------
# quickstart §1-§9 on the port
# ---------------------------------------------------------------------------

def test_quickstart_walk():
    from repro_torch.core import (CommConfig, EndpointSpec, LocalCluster,
                                  MatchingPolicy, post_recv_x, post_send_x)
    cpu = {"device": "cpu"}
    # 1. runtime + a symmetric 2-device endpoint
    cfg = CommConfig(inject_max_bytes=64, bufcopy_max_bytes=4096)
    cluster = LocalCluster(n_ranks=2, config=cfg, **cpu)
    r0, r1 = cluster[0], cluster[1]
    assert (r0.get_rank_me(), r0.get_rank_n()) == (0, 2)
    eps = cluster.alloc_endpoint(n_devices=2, stripe="round_robin",
                                 name="quickstart")
    ep0, ep1 = eps
    # 2a. AM into a remote CQ
    rcq = r1.alloc_cq()
    rcomp = r1.register_rcomp(rcq)
    st0 = ep0.post_am(1, np.arange(8, dtype=np.uint8), remote_comp=rcomp,
                      tag=42)
    assert st0.is_done()
    msg = rcq.wait(cluster)
    assert msg.tag == 42 and list(msg.get_buffer()[:4]) == [0, 1, 2, 3]
    # 2b. wildcard send/recv (a tensor recv buffer, numpy payload)
    buf = torch.zeros(16, dtype=torch.uint8)
    post_recv_x(r1, 0, buf, 16, 0).matching_policy(
        MatchingPolicy.RANK_ONLY).endpoint(ep1)()
    post_send_x(r0, 1, np.full(16, 7, np.uint8), 16, 999).matching_policy(
        MatchingPolicy.RANK_ONLY).endpoint(ep0)()
    cluster.quiesce()
    assert bool((buf == 7).all())
    # 2c. RMA put into registered memory
    target = torch.zeros(32, dtype=torch.uint8)
    region = r1.register_memory(target)
    ep0.post_put(1, torch.arange(32, dtype=torch.uint8), (region.rid, 0), 32)
    cluster.quiesce()
    assert torch.equal(target, torch.arange(32, dtype=torch.uint8))
    # 3. back-pressure is a value
    tiny = LocalCluster(2, cfg, fabric_depth=1, **cpu)
    post_send_x(tiny[0], 1, np.zeros(8, np.uint8), 8, 0)()
    st3 = post_send_x(tiny[0], 1, np.zeros(8, np.uint8), 8, 0)()
    assert st3.is_retry()
    # 4. async completion graph
    g = r0.alloc_graph("demo")
    inbox = torch.zeros(16, dtype=torch.uint8)
    recv = g.add_comm(post_recv_x(r1, 0, inbox, 16, 7).endpoint(ep1),
                      name="recv")
    send = g.add_comm(post_send_x(r0, 1, torch.full((16,), 3,
                                                    dtype=torch.uint8),
                                  16, 7).endpoint(ep0), name="send")
    summed = g.add_node(lambda r, s: int(inbox.sum()), deps=[recv, send])
    g.start()
    vals = g.wait()
    g.assert_partial_order()
    assert vals[summed] == 48
    # 5. striping + explicit progress
    for i in range(4):
        ep0.post_am(1, np.full(8, i, np.uint8), remote_comp=rcomp)
    while eps[0].progress() + eps[1].progress():
        pass
    assert [d["posts"] > 0 for d in ep0.counters()["devices"]] == [True] * 2
    while not rcq.pop().is_retry():
        pass
    # 6. progress workers + a thread-safe CQ
    wspec = EndpointSpec(name="workers-demo", n_devices=2,
                         progress="workers", n_workers=2)
    wep0 = r0.alloc_endpoint(spec=wspec)
    wep1 = r1.alloc_endpoint(spec=dataclasses.replace(wspec,
                                                      name="workers-demo@1"))
    wcq = r1.alloc_cq(threadsafe=True)
    wrc = r1.register_rcomp(wcq)
    with wep0, wep1:
        for i in range(8):
            wep0.post_am(1, torch.full((8,), i, dtype=torch.uint8),
                         remote_comp=wrc)
        deadline = time.monotonic() + 30
        while wcq.pushes < 8 and time.monotonic() < deadline:
            time.sleep(1e-4)
    assert wcq.pushes == 8
    # 7. burst posting + the OFF .batch() spelling
    bursty = torch.stack([torch.full((8,), i, dtype=torch.uint8)
                          for i in range(32)])
    ep0.post_am_many(1, list(bursty), rcomp, tags=list(range(32)))
    while eps[0].progress() + eps[1].progress():
        pass
    delivered = 0
    while not rcq.pop().is_retry():
        delivered += 1
    assert delivered == 32
    batch = post_send_x(r0, 1, np.full(8, 1, np.uint8), 8, 70).endpoint(
        ep0).batch()
    post_send_x(r0, 1, np.full(8, 2, np.uint8), 8, 71).endpoint(
        ep0).batch(batch)
    got = [np.zeros(8, np.uint8), np.zeros(8, np.uint8)]
    sync2 = r1.alloc_sync(expected=2)
    for tag, b in zip((70, 71), got):
        post_recv_x(r1, 0, b, 8, tag, sync2)()
    batch.flush()
    sync2.wait(cluster)
    assert (got[0][0], got[1][0]) == (1, 2)
    # 8. the attribute system
    tuned = LocalCluster(2, attrs={"eager_max_bytes": 16,
                                   "cq_capacity": 32}, **cpu)
    assert tuned[0].get_attr("eager_max_bytes") == 16
    assert tuned[0].attr_source("eager_max_bytes") == "runtime"
    assert tuned[0].alloc_cq().get_attr("cq_capacity") == 32
    tep = tuned[0].alloc_endpoint(stripe="by_size")
    assert tep.get_attr("stripe") == "by_size" and tep.get_attr("width") == 1
    # 9. fused doorbells over a bf16 wire
    fcl = LocalCluster(2, attrs={"eager_max_bytes": 64, "wire_bf16": True},
                       **cpu)
    feps = fcl.alloc_endpoint(n_devices=1, name="fused")
    fcq = fcl[1].alloc_cq()
    frc = fcl[1].register_rcomp(fcq)
    fbufs = [torch.linspace(0, 1, 4)] * 8
    fsts = feps[0].post_am_many(1, fbufs, frc)
    feps[1].progress()
    outs = []
    while True:
        s = fcq.pop()
        if not s.is_done():
            break
        outs.append(s.get_buffer().view(torch.float32))
    assert sum(1 for s in fsts if s.is_done()) == 8 and len(outs) == 8
    assert fcl[0].fabric.pushes == 8
    want = torch.linspace(0, 1, 4).to(torch.bfloat16).float()
    assert all(torch.equal(o, want) for o in outs)


# ---------------------------------------------------------------------------
# device binding, and the parts once refused as not ported
# ---------------------------------------------------------------------------

def test_no_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(port.FatalError, match="device='cpu'"):
        port.LocalCluster(2)
    with pytest.raises(port.FatalError):
        port.LocalCluster(2, device="cuda")


@pytest.mark.parametrize("attrs", [
    {"fabric_backend": "shm"}, {"fabric_backend": "socket"},
    {"chaos_drop": 0.1}, {"chaos_kill_rank": 1}, {"reliability": "on"},
], ids=["shm", "socket", "chaos_drop", "chaos_kill", "reliability_on"])
def test_unported_parts_refused(attrs):
    """These configurations raised "not ported" until the transports and
    the chaos and reliability planes were ported: each now builds the
    reference's fabric and reliability layer and delivers a message."""
    with port.LocalCluster(2, attrs=attrs, device="cpu") as cl, \
            ref.LocalCluster(2, attrs=attrs) as rcl:
        assert cl.fabric.backend == rcl.fabric.backend
        assert type(cl.fabric).__name__ == type(rcl.fabric).__name__
        assert [rt.rel is None for rt in cl.runtimes] == \
            [rt.rel is None for rt in rcl.runtimes]
        if "chaos_kill_rank" in attrs:
            return                       # rank 1's traffic is swallowed
        cq = cl[1].alloc_cq()
        port.post_am(cl[0], 1, np.arange(16, dtype=np.uint8),
                     remote_comp=cl[1].register_rcomp(cq), tag=5)
        cl.quiesce()
        st = cq.pop()
        assert st.is_done() and st.tag == 5
        assert _np(st.get_buffer()).tobytes() == bytes(range(16))


def test_inert_chaos_and_auto_reliability_allowed():
    cl = port.LocalCluster(2, attrs={"chaos_seed": 3, "chaos_delay_us": 5.0,
                                     "reliability": "auto"}, device="cpu")
    assert all(rt.rel is None for rt in cl.runtimes)
    assert cl.device == torch.device("cpu")
