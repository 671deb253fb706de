"""The PyTorch port's chaos and reliability planes against the JAX
package, on the CPU.

* one seed gives the same fault decisions in the reference's and the
  port's ``ChaosTransport`` (the replay contract across packages);
* exactly-once, in-order delivery under 5% drop, dup and reorder (the
  reference's ``FAULTS``) on ``sim``, ``shm`` and ``socket``, for scalar
  AMs and for fused doorbells of host and CPU-tensor rows, the bytes equal
  to what was sent;
* deadlines and peer death, as ``tests/test_chaos.py``'s
  ``TestDeadlinesAndDeath``.

The straggler, shrink-mesh and mid-commit classes of
``tests/test_chaos.py`` belong to the training stack, which the port does
not have yet.
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro.core.transport import wire as ref_wire
from repro.core.transport.chaos import ChaosConfig as RefChaosConfig
from repro.core.transport.chaos import ChaosTransport as RefChaosTransport
from repro.core.transport.sim import Fabric as RefFabric
from repro_torch.core import ErrorCode, post_am, post_recv
from repro_torch.core.transport import wire as port_wire
from repro_torch.core.transport.chaos import ChaosConfig, ChaosTransport
from repro_torch.core.transport.sim import Fabric
from repro_torch.core.transport.wire import WireKind, WireMsg

FAULTS = {"chaos_drop": 0.05, "chaos_dup": 0.05, "chaos_reorder": 0.05}


def _cluster(**attrs):
    return port.LocalCluster(2, attrs=attrs, device="cpu")


def _drain_cq(cq):
    out = []
    while True:
        st = cq.pop()
        if st.is_retry():
            return out
        assert st.is_done()
        out.append(st)


# ---------------------------------------------------------------------------
# the fault model across packages
# ---------------------------------------------------------------------------

def _survivors(chaos, wire, n=60):
    """Push ``n`` fault-eligible AMs one at a time, draining after each;
    returns the delivered tags in order."""
    out = []
    for i in range(n):
        msg = wire.WireMsg(wire.WireKind.EAGER_AM, 0, 1, tag=i,
                           payload=np.zeros(4, np.uint8), size=4, rcomp=0,
                           device_index=i % 2)
        msg.seq, msg.epoch = i, 0
        assert chaos.try_push(msg)
        out += [m.tag for m in chaos.drain(1, i % 2)]
    for d in (0, 1):
        out += [m.tag for m in chaos.drain(1, d)]
    return out


@pytest.mark.parametrize("seed", [0, 11, 12, 2**31 - 1])
def test_same_seed_same_faults_across_packages(seed):
    cfg = dict(seed=seed, drop=0.3, dup=0.2, reorder=0.2)
    ref = RefChaosTransport(RefFabric(2), RefChaosConfig(**cfg))
    got = ChaosTransport(Fabric(2), ChaosConfig(**cfg))
    assert _survivors(got, port_wire) == _survivors(ref, ref_wire)
    assert got.fault_counters() == ref.fault_counters()


def test_inactive_config_skips_wrap():
    with _cluster(chaos_drop=0.0, chaos_seed=4) as cl:
        assert not isinstance(cl.fabric, ChaosTransport)
        assert all(rt.rel is None for rt in cl.runtimes)


def test_acks_never_faulted():
    chaos = ChaosTransport(Fabric(2), ChaosConfig(seed=1, drop=1.0))
    ack = WireMsg(WireKind.ACK, 0, 1, payload=(5, 0), device_index=0)
    assert chaos.try_push(ack)
    out = chaos.drain(1, 0)
    assert len(out) == 1 and out[0].kind == WireKind.ACK
    assert chaos.dropped.load() == 0


def test_dead_rank_swallows_traffic():
    chaos = ChaosTransport(Fabric(2), ChaosConfig(kill_rank=1))
    msg = WireMsg(WireKind.EAGER_AM, 0, 1,
                  payload=torch.zeros(8, dtype=torch.uint8), size=8, rcomp=0,
                  device_index=0)
    assert chaos.try_push(msg)
    assert chaos.drain(1, 0) == []
    assert chaos.dead_dropped.load() > 0


# ---------------------------------------------------------------------------
# the reliability property: no loss, no dup, per-stream FIFO
# ---------------------------------------------------------------------------

def _deliver_all(cl, n, size=32, tensor=False):
    sender, receiver = cl[0], cl[1]
    cq = receiver.alloc_cq()
    rc = receiver.register_rcomp(cq)
    for i in range(n):
        buf = np.full(size, i % 256, np.uint8)
        if tensor:
            buf = torch.from_numpy(buf)
        st = post_am(sender, 1, buf, remote_comp=rc, tag=i)
        while st.is_retry():
            sender.progress()
            st = post_am(sender, 1, buf, remote_comp=rc, tag=i)
    cl.quiesce()
    sts = _drain_cq(cq)
    for st in sts:
        got = st.get_buffer()
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(got, np.full(size, st.tag % 256, np.uint8))
    return [st.tag for st in sts]


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("backend", ["sim", "shm", "socket"])
def test_exactly_once_in_order_scalar(backend, tensor):
    with _cluster(fabric_backend=backend, chaos_seed=1234, **FAULTS) as cl:
        assert cl[0].rel is not None                 # auto-armed
        assert _deliver_all(cl, 120, tensor=tensor) == list(range(120))


def _fused_under_chaos(backend, kind, op, seed):
    """Fused doorbells of 8 float32 rows under FAULTS: every row is
    delivered once, in order, byte-exact (AMs, or sends into pre-posted
    recv buffers)."""
    rng = np.random.default_rng(seed)
    with _cluster(fabric_backend=backend, chaos_seed=seed,
                  doorbell_fused=True, reliability="on", **FAULTS) as cl:
        ep0, ep1 = cl.alloc_endpoint(n_devices=1, name="burst")
        cq = cl[1].alloc_cq()
        rc = cl[1].register_rcomp(cq)
        sent, bufs = {}, {}
        for base in range(0, 96, 8):
            rows = rng.standard_normal((8, 8)).astype(np.float32)
            tags = list(range(base, base + 8))
            pay = [torch.from_numpy(r) if kind == "tensor" else r
                   for r in rows]
            for t, r in zip(tags, rows):
                sent[t] = r.tobytes()
            if op == "send":
                for t in tags:
                    b = np.zeros(8, np.float32)
                    bufs[t] = torch.from_numpy(b) if kind == "tensor" else b
                    ep1.post_recv(0, bufs[t], 32, tag=t, local_comp=cq)
            todo = list(zip(pay, tags))
            while todo:
                p, t = zip(*todo)
                sts = (ep0.post_send_many(1, list(p), tags=list(t))
                       if op == "send" else
                       ep0.post_am_many(1, list(p), rc, tags=list(t)))
                ok = sum(1 for s in sts if not s.is_retry())
                todo = todo[ok:]
                cl.progress_all()
        cl.quiesce()
        sts = _drain_cq(cq)
        tags = [st.tag for st in sts]
        for st in sts:
            got = (bufs[st.tag] if op == "send" else st.get_buffer())
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert np.asarray(got).tobytes() == sent[st.tag]
        counters = cl[0].rel.counters()
    return tags, counters


@pytest.mark.parametrize("op", ["am", "send"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("backend", ["sim", "shm", "socket"])
def test_fused_doorbell_exactly_once(backend, kind, op):
    tags, counters = _fused_under_chaos(backend, kind, op, seed=77)
    assert tags == list(range(96))
    assert counters["retransmits"] > 0           # the faults really fired


def test_bufcopy_source_comps_exactly_once():
    with _cluster(chaos_seed=5, eager_max_bytes=0, **FAULTS) as cl:
        scq = cl[0].alloc_cq()
        cq = cl[1].alloc_cq()
        rc = cl[1].register_rcomp(cq)
        for i in range(60):
            buf = torch.full((32,), i % 256, dtype=torch.uint8)
            st = post_am(cl[0], 1, buf, local_comp=scq, remote_comp=rc,
                         tag=i)
            while st.is_retry():
                cl[0].progress()
                st = post_am(cl[0], 1, buf, local_comp=scq,
                             remote_comp=rc, tag=i)
        cl.quiesce()
        assert len(_drain_cq(scq)) == 60
        assert [s.tag for s in _drain_cq(cq)] == list(range(60))
        assert not cl[0].pending_ops


# ---------------------------------------------------------------------------
# deadlines and rank death
# ---------------------------------------------------------------------------

def _first(cl, cq, limit=10.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        cl.progress_all()
        s = cq.pop()
        if not s.is_retry():
            return s
    return None


@pytest.mark.parametrize("backend", ["sim", "shm"])
class TestDeadlinesAndDeath:
    def test_post_deadline_expires_err_timeout(self, backend):
        with _cluster(fabric_backend=backend, chaos_drop=1.0, chaos_seed=2,
                      eager_max_bytes=0, post_deadline_us=20_000,
                      retry_limit=1_000_000) as cl:
            scq = cl[0].alloc_cq()
            rc = cl[1].register_rcomp(cl[1].alloc_cq())
            st = post_am(cl[0], 1, torch.zeros(32, dtype=torch.uint8),
                         local_comp=scq, remote_comp=rc, tag=9)
            assert st.is_posted()
            got = _first(cl, scq)
            assert got is not None and got.is_err()
            assert got.code == ErrorCode.ERR_TIMEOUT

    def test_recv_deadline_expires(self, backend):
        with _cluster(fabric_backend=backend, reliability="on",
                      post_deadline_us=10_000) as cl:
            cq = cl[1].alloc_cq()
            st = post_recv(cl[1], 0, torch.zeros(16, dtype=torch.uint8), 16,
                           3, cq)
            assert st.is_posted()
            got = _first(cl, cq)
            assert got is not None and got.is_err()
            assert got.code == ErrorCode.ERR_TIMEOUT

    def test_post_to_dead_peer_fails_at_post_time(self, backend):
        with _cluster(fabric_backend=backend, reliability="on") as cl:
            cl[0].mark_peer_dead(1)
            st = post_am(cl[0], 1, np.zeros(8, np.uint8), remote_comp=0)
            assert st.is_err() and st.code == ErrorCode.ERR_PEER_DEAD

    def test_in_flight_fails_peer_dead_on_death(self, backend):
        with _cluster(fabric_backend=backend, chaos_drop=1.0, chaos_seed=3,
                      eager_max_bytes=0, retry_limit=1_000_000) as cl:
            scq = cl[0].alloc_cq()
            rc = cl[1].register_rcomp(cl[1].alloc_cq())
            for i in range(5):
                post_am(cl[0], 1, torch.zeros(32, dtype=torch.uint8),
                        local_comp=scq, remote_comp=rc, tag=i)
            assert cl[0].pending_ops
            cl[0].mark_peer_dead(1)
            deadline = time.monotonic() + 10.0
            codes = []
            while len(codes) < 5 and time.monotonic() < deadline:
                cl[0].progress()
                s = scq.pop()
                if not s.is_retry():
                    codes.append(s.code)
            assert codes == [ErrorCode.ERR_PEER_DEAD] * 5
            assert not cl[0].pending_ops
