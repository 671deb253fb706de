"""The PyTorch port's transports held against the JAX package, on the CPU.

* the codec across packages, both ways: for scalar, tuple, packed,
  ragged packed and bf16-wire packed messages (numpy-seeded), the port's
  frame is bytes-equal to the reference's, and each package decodes the
  other's frame to the same message; a CPU-tensor payload or burst
  encodes to the bytes of the equal ndarray;
* the reference's fuzz cases (truncation at every length, bad magic or
  version, bit flips) raise ``CodecError`` in the port, and a flipped
  frame gets the same verdict from both decoders;
* the port's counterparts of ``tests/test_transport.py``: the shm ring
  and socket mechanics, backend selection through the attr chain, the
  three-backend parity of the full protocol stack, and the row-weighted
  drain limit — with numpy and CPU-tensor payloads, delivered bytes equal
  to the reference's.
"""
import os
import threading

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.transport import codec as ref_codec
from repro.core.transport import wire as ref_wire
from repro_torch.core.transport import codec as port_codec
from repro_torch.core.transport import wire as port_wire
from repro_torch.core.transport.shm import ShmTransport
from repro_torch.core.transport.sim import Fabric
from repro_torch.core.transport.socket import SocketTransport
from repro_torch.core.transport.wire import (PACKED_KINDS, PackedBurst,
                                             WireKind, WireMsg)

SCALAR_KINDS = sorted(v for k, v in vars(WireKind).items()
                      if not k.startswith("_") and v not in PACKED_KINDS)
PKG = {"ref": (ref, ref_wire, ref_codec), "port": (port, port_wire,
                                                   port_codec)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the codec across packages
# ---------------------------------------------------------------------------

def _scalar_spec(i, kind):
    """A scalar message from a numpy seed: each kind with an ndarray, a
    tuple or no payload, and every header field set."""
    rng = np.random.default_rng(100 + i)
    sel = i % 3
    return {"kind": kind, "src": int(rng.integers(0, 8)),
            "dst": int(rng.integers(0, 8)), "tag": int(rng.integers(0, 2**31)),
            "op_id": int(rng.integers(-1, 2**31)),
            "rcomp": None if i % 4 == 0 else int(rng.integers(0, 100)),
            "policy": ("RANK_TAG", "RANK_ONLY", "TAG_ONLY")[i % 3],
            "didx": int(rng.integers(0, 6)),
            "rbuf": (int(rng.integers(0, 5)), int(rng.integers(0, 97)))
            if i % 2 else None,
            "seq": int(rng.integers(-1, 1000)), "epoch": int(i % 3),
            "ready_at": float(i) / 4,
            "payload": (None if sel == 0 else
                        rng.integers(0, 256, int(rng.integers(0, 64)),
                                     dtype=np.uint8) if sel == 1 else
                        tuple(int(v) for v in rng.integers(0, 2**40, i % 5)))}


def _burst_bufs(case):
    rng = np.random.default_rng(7)
    if case == "packed":
        return [rng.integers(0, 256, 24, dtype=np.uint8) for _ in range(5)]
    if case == "packed_ragged":
        return [rng.integers(0, 256, int(n), dtype=np.uint8)
                for n in (3, 17, 0, 9)]
    if case == "packed_bf16":
        return [rng.standard_normal(12).astype(np.float32)
                for _ in range(6)]
    f = rng.standard_normal(8).astype(np.float32)
    return [f] * 4                          # one object: stride-0 rows


BURSTS = ("packed", "packed_ragged", "packed_bf16", "packed_bf16_broadcast")


def _msg(pkg, spec, tensor=False):
    """``spec`` as a WireMsg of package ``pkg`` (``tensor``: the port's
    payload or wire image as a CPU tensor)."""
    core, wire, _ = PKG[pkg]
    if "burst" in spec:
        bufs = _burst_bufs(spec["burst"])
        if tensor:
            tb = [torch.from_numpy(b) for b in bufs]
            if spec["burst"].endswith("broadcast"):
                tb = [tb[0]] * len(bufs)
            bufs = tb
        bf16 = spec["burst"].startswith("packed_bf16")
        kw = {"device": torch.device("cpu")} if pkg == "port" else {}
        data, sizes, wd = core.pack_payloads(bufs, wire_bf16=bf16, **kw)
        burst = wire.PackedBurst(data, sizes, list(range(40, 40 + len(bufs))),
                                 len(bufs), wd)
        return wire.WireMsg(wire.WireKind.EAGER_PACKED_SEND, 1, 0,
                            payload=burst, size=int(data.nbytes), seq=9,
                            epoch=2, device_index=3)
    payload = spec["payload"]
    if tensor and isinstance(payload, np.ndarray):
        payload = torch.from_numpy(payload)
    return wire.WireMsg(spec["kind"], spec["src"], spec["dst"],
                        tag=spec["tag"], payload=payload,
                        size=0 if payload is None else len(payload),
                        rcomp=spec["rcomp"],
                        matching_policy=getattr(core.MatchingPolicy,
                                                spec["policy"]),
                        op_id=spec["op_id"], remote_buf=spec["rbuf"],
                        device_index=spec["didx"], ready_at=spec["ready_at"],
                        seq=spec["seq"], epoch=spec["epoch"])


def _fields(msg):
    """Every delivered field of a decoded message, package-neutral."""
    p = msg.payload
    if isinstance(p, (ref_wire.PackedBurst, port_wire.PackedBurst)):
        body = ("packed", p.count, list(p.tags), p.wire_dtype,
                np.asarray(p.sizes).tolist(),
                [_np(r).tobytes() for r in p.delivered_payloads()])
    elif p is None or isinstance(p, tuple):
        body = p
    else:
        body = _np(p).reshape(-1).view(np.uint8).tobytes()
    return (msg.kind, msg.src, msg.dst, msg.tag, msg.size, msg.op_id,
            msg.rcomp, msg.matching_policy.name, msg.device_index,
            msg.ready_at, None if msg.remote_buf is None
            else tuple(msg.remote_buf), msg.seq, msg.epoch, body)


CODEC_CASES = ([(f"{k}-{i}", _scalar_spec(i, k)) for i in range(3)
                for k in SCALAR_KINDS]
               + [(b, {"burst": b}) for b in BURSTS])


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name,spec", CODEC_CASES,
                         ids=[c[0] for c in CODEC_CASES])
def test_frames_equal_and_cross_decode(name, spec, tensor):
    """Port-encoded frames are the reference's bytes and decode in the
    reference, and the other way round; a CPU-tensor payload encodes to
    the bytes of the equal ndarray."""
    rmsg, pmsg = _msg("ref", spec), _msg("port", spec, tensor)
    rframe = ref_codec.encode_msg(rmsg)
    pframe = port_codec.encode_msg(pmsg)
    assert pframe == rframe
    r_of_p, end = ref_codec.decode_msg(pframe)
    assert end == len(pframe)
    p_of_r, end = port_codec.decode_msg(rframe)
    assert end == len(rframe)
    assert _fields(r_of_p) == _fields(p_of_r) == _fields(rmsg)
    if "burst" in spec:
        # the decoder hands host arrays over, copied out of the frame (a
        # view of the frame's bytes would be read-only)
        assert isinstance(p_of_r.payload.data, np.ndarray)
        assert p_of_r.payload.data.flags.writeable


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name,spec", CODEC_CASES,
                         ids=[c[0] for c in CODEC_CASES])
def test_frame_bytes_is_encoded_length(name, spec, tensor):
    """``frame_bytes`` (what a transport checks before it encodes) is the
    length of the frame, and each encode counts one frame."""
    msg = _msg("port", spec, tensor)
    frames, cuda = port_codec.encode_msg.frames, \
        port_codec.encode_msg.cuda_frames
    assert port_codec.frame_bytes(msg) == len(port_codec.encode_msg(msg))
    assert port_codec.encode_msg.frames == frames + 1
    assert port_codec.encode_msg.cuda_frames == cuda


def test_tensor_burst_stays_host_and_counts_no_copy():
    """A CPU tensor never crosses between host and card: the copy
    counters of both directions stay put."""
    before = (port_wire.to_host.copies, port_wire.to_card.copies)
    msg = _msg("port", {"burst": "packed"}, tensor=True)
    frame = port_codec.encode_msg(msg)
    out, _ = port_codec.decode_msg(frame)
    moved = out.payload.to(torch.device("cpu"))
    assert isinstance(moved.data, torch.Tensor)
    assert torch.equal(moved.data, torch.from_numpy(out.payload.data))
    assert (port_wire.to_host.copies, port_wire.to_card.copies) == before


def _sample(pkg):
    core, wire, _ = PKG[pkg]
    return wire.WireMsg(wire.WireKind.EAGER_AM, 0, 1, tag=42,
                        payload=np.arange(24, dtype=np.uint8), size=24,
                        rcomp=3, device_index=1, seq=7, epoch=1)


class TestCodecFuzz:
    def test_truncation_every_length(self):
        frame = ref_codec.encode_msg(_sample("ref"))
        for n in range(len(frame)):
            with pytest.raises(port_codec.CodecError):
                port_codec.decode_msg(frame[:n])

    def test_bad_magic_and_version(self):
        frame = bytearray(port_codec.encode_msg(_sample("port")))
        bad = bytes([frame[0] ^ 0xFF]) + bytes(frame[1:])
        with pytest.raises(port_codec.CodecError, match="magic"):
            port_codec.decode_msg(bad)
        frame[2] ^= 0x55                          # version byte
        with pytest.raises(port_codec.CodecError, match="version|magic"):
            port_codec.decode_msg(bytes(frame))

    @pytest.mark.parametrize("frame_of", ["ref", "packed"])
    def test_bit_flips_same_verdict(self, frame_of):
        """Every one-bit corruption gets the same verdict from both
        decoders: both raise CodecError, or both parse to the same
        message.  Payload-body flips are always caught (the crc32)."""
        msg = (_sample("ref") if frame_of == "ref"
               else _msg("ref", {"burst": "packed_bf16"}))
        frame = ref_codec.encode_msg(msg)
        rng = np.random.default_rng(3)
        for _ in range(120):
            bad = bytearray(frame)
            pos = int(rng.integers(len(bad)))
            bad[pos] ^= 1 << int(rng.integers(8))
            bad = bytes(bad)
            try:
                want = _fields(ref_codec.decode_msg(bad)[0])
            except ref_codec.CodecError:
                with pytest.raises(port_codec.CodecError):
                    port_codec.decode_msg(bad)
                continue
            assert _fields(port_codec.decode_msg(bad)[0]) == want

    def test_torn_concatenation(self):
        a = port_codec.encode_msg(_sample("port"))
        both = a + a[: len(a) // 2]
        msg, off = port_codec.decode_msg(both)
        assert msg.tag == 42 and off == len(a)
        with pytest.raises(port_codec.CodecError):
            port_codec.decode_msg(both, off)


# ---------------------------------------------------------------------------
# backend registry + attr-chain selection
# ---------------------------------------------------------------------------

class TestBackendSelection:
    def test_registry_resolves_all_backends(self):
        assert port.backend_class("sim") is Fabric
        assert port.backend_class("shm") is ShmTransport
        assert port.backend_class("socket") is SocketTransport
        for name in ("sim", "shm", "socket"):
            assert issubclass(port.backend_class(name), port.Transport)

    def test_unknown_backend_raises_attr_error(self):
        with pytest.raises(port.AttrError, match="registered backends"):
            port.backend_class("infiniband")
        with pytest.raises(port.AttrError):
            port.LocalCluster(2, attrs={"fabric_backend": "carrier_pigeon"},
                              device="cpu")

    def test_env_layer_selects_backend(self, monkeypatch):
        monkeypatch.setenv("REPRO_ATTR_FABRIC_BACKEND", "shm")
        with port.LocalCluster(2, device="cpu") as cl:
            assert cl.fabric.backend == "shm"
            assert isinstance(getattr(cl.fabric, "inner", cl.fabric),
                              ShmTransport)
            assert cl.fabric.attr_source("fabric_backend") == "env"

    def test_default_backend_is_sim(self, monkeypatch):
        for var in ("REPRO_ATTR_FABRIC_BACKEND", "REPRO_ATTR_CHAOS_DROP",
                    "REPRO_ATTR_CHAOS_DUP", "REPRO_ATTR_CHAOS_REORDER",
                    "REPRO_ATTR_CHAOS_DELAY_P", "REPRO_ATTR_CHAOS_KILL_RANK"):
            monkeypatch.delenv(var, raising=False)
        cl = port.LocalCluster(2, device="cpu")
        assert isinstance(cl.fabric, Fabric)
        assert cl.fabric.attr_source("fabric_backend") == "default"

    def test_introspection_on_fabric(self):
        with port.LocalCluster(2, attrs={"fabric_backend": "shm",
                                         "shm_ring_bytes": 65536},
                               device="cpu") as cl:
            fab = cl.fabric
            assert fab.get_attr("shm_ring_bytes") == 65536
            assert fab.attr_source("fabric_backend") == "runtime"
            assert fab.attr_source("fabric_depth") == "default"
            assert "in_flight" in fab.attrs


# ---------------------------------------------------------------------------
# shm transport mechanics
# ---------------------------------------------------------------------------

def _shm_pair(tmp_path, **kw):
    session = str(tmp_path / "sess")
    return (ShmTransport(2, rank=0, session=session, **kw),
            ShmTransport(2, rank=1, session=session, **kw))


def _am(i=0, dst=1, dev=0, nbytes=8, tensor=False):
    payload = np.full(nbytes, i % 256, np.uint8)
    return WireMsg(WireKind.EAGER_AM, 0, dst, tag=i,
                   payload=torch.from_numpy(payload) if tensor else payload,
                   size=nbytes, rcomp=0, device_index=dev)


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
class TestShmTransport:
    def test_cross_instance_fifo(self, tmp_path, tensor):
        a, b = _shm_pair(tmp_path)
        try:
            for i in range(10):
                assert a.try_push(_am(i, tensor=tensor))
            assert b.stream_depth(1, 0) == 10
            out = b.drain(1, 0)
            assert [m.tag for m in out] == list(range(10))
            assert isinstance(out[3].payload, np.ndarray)
            assert np.array_equal(out[3].payload, np.full(8, 3, np.uint8))
            assert b.stream_depth(1, 0) == 0 and not b.ready(1, 0)
        finally:
            a.close(); b.close()

    def test_depth_bound_prefix_accept(self, tmp_path, tensor):
        a, b = _shm_pair(tmp_path, depth=3)
        try:
            msgs = [_am(i, tensor=tensor) for i in range(5)]
            assert a.push_burst(msgs) == 3
            assert a.full_events == 1
            assert [m.tag for m in b.drain(1, 0)] == [0, 1, 2]
            assert a.push_burst(msgs[3:]) == 2
        finally:
            a.close(); b.close()

    def test_ring_byte_backpressure_and_wraparound(self, tmp_path, tensor):
        a, b = _shm_pair(tmp_path, ring_bytes=4096)
        try:
            sent, tags = 0, []
            while sent < 300:
                if a.try_push(_am(sent, nbytes=100, tensor=tensor)):
                    sent += 1
                else:
                    got = b.drain(1, 0, limit=7)
                    assert got, "full ring but nothing drainable"
                    tags += [m.tag for m in got]
            tags += [m.tag for m in b.drain(1, 0)]
            assert tags == list(range(300))
        finally:
            a.close(); b.close()

    def test_packed_doorbell_row_weighted(self, tmp_path, tensor):
        a, b = _shm_pair(tmp_path, depth=10)
        try:
            data = np.arange(48, dtype=np.uint8).reshape(6, 8)
            burst = PackedBurst(torch.from_numpy(data) if tensor else data,
                                np.full(6, 8, np.int64), list(range(6)), 6)
            msg = WireMsg(WireKind.EAGER_PACKED_AM, 0, 1, payload=burst,
                          size=48, rcomp=0)
            assert a.push_packed(msg) == 6
            assert b.stream_depth(1, 0) == 6        # rows, not records
            assert a.push_packed(msg) == 4          # prefix-accept split
            out = b.drain(1, 0)
            assert [m.payload.count for m in out] == [6, 4]
            assert np.array_equal(out[1].payload.data, data[:4])
        finally:
            a.close(); b.close()

    def test_full_ring_refuses_before_encoding(self, tmp_path, tensor):
        """A doorbell the ring has no bytes for is refused before it is
        encoded, so its retry is the only encode (and, for a CUDA image,
        the only copy to the host)."""
        a, b = _shm_pair(tmp_path, ring_bytes=4096)
        try:
            data = np.arange(8 * 200, dtype=np.uint8).reshape(8, 200) % 251
            burst = PackedBurst(torch.from_numpy(data) if tensor else data,
                                np.full(8, 200, np.int64), list(range(8)), 8)
            msg = WireMsg(WireKind.EAGER_PACKED_AM, 0, 1, payload=burst,
                          size=data.nbytes, rcomp=0)
            enc = port_codec.encode_msg
            frames = enc.frames
            for _ in range(2):                        # 1.8 KiB of 4 KiB
                assert a.push_packed(msg) == 8
            assert enc.frames == frames + 2
            full = a.full_events
            assert a.push_packed(msg) == 0            # no bytes left
            assert (enc.frames, a.full_events) == (frames + 2, full + 1)
            assert b.drain(1, 0, limit=8)[0].payload.count == 8
            assert a.push_packed(msg) == 8
            assert enc.frames == frames + 3
            out = b.drain(1, 0)
            assert [m.payload.count for m in out] == [8, 8]
            assert np.array_equal(out[1].payload.data, data)
        finally:
            a.close(); b.close()

    def test_oversized_payload_spills(self, tmp_path, tensor):
        a, b = _shm_pair(tmp_path, ring_bytes=8192)
        try:
            big = (np.arange(32 * 1024) % 251).astype(np.uint8)
            msg = WireMsg(WireKind.RDMA_PAYLOAD, 0, 1,
                          payload=torch.from_numpy(big) if tensor else big,
                          size=big.nbytes, op_id=7)
            assert a.try_push(msg)
            assert any(n.startswith("spill_") for n in os.listdir(a._dir))
            out = b.drain(1, 0)
            assert len(out) == 1 and np.array_equal(out[0].payload, big)
            assert not any(n.startswith("spill_")
                           for n in os.listdir(a._dir))
        finally:
            a.close(); b.close()

    def test_threaded_producers_one_consumer(self, tmp_path, tensor):
        t = ShmTransport(2, ring_bytes=1 << 16)
        try:
            per_thread, n_threads = 100, 4

            def producer(base):
                for i in range(per_thread):
                    while not t.try_push(_am(base + i, nbytes=16,
                                             tensor=tensor)):
                        pass

            threads = [threading.Thread(target=producer,
                                        args=(k * per_thread,))
                       for k in range(n_threads)]
            for th in threads:
                th.start()
            got = []
            while len(got) < per_thread * n_threads:
                got += t.drain(1, 0, limit=32)
            for th in threads:
                th.join(timeout=30)
                assert not th.is_alive()
            assert sorted(m.tag for m in got) == \
                list(range(per_thread * n_threads))
            assert t.in_flight() == 0
        finally:
            t.close()

    def test_solo_session_dir_reaped_on_close(self, tmp_path, tensor):
        t = ShmTransport(2)
        d = t._dir
        t.try_push(_am(0, tensor=tensor))
        assert os.path.isdir(d)
        t.close()
        assert not os.path.exists(d)


def test_ring_reads_a_reference_producer(tmp_path):
    """A reference producer and a port consumer share one session's
    rings: the wire contract at the ring level."""
    from repro.core.transport.shm import ShmTransport as RefShm
    session = str(tmp_path / "mixed")
    a = RefShm(2, rank=0, session=session, ring_bytes=4096)
    b = ShmTransport(2, rank=1, session=session, ring_bytes=4096)
    try:
        tags = []
        sent = 0
        while sent < 120:
            msg = ref_wire.WireMsg(ref_wire.WireKind.EAGER_AM, 0, 1,
                                   tag=sent,
                                   payload=np.full(90, sent, np.uint8),
                                   size=90, rcomp=0)
            if a.try_push(msg):
                sent += 1
            else:
                tags += [(m.tag, m.payload[0]) for m in b.drain(1, 0)]
        tags += [(m.tag, m.payload[0]) for m in b.drain(1, 0)]
        assert tags == [(i, i % 256) for i in range(120)]
    finally:
        a.close(); b.close()


# ---------------------------------------------------------------------------
# socket transport mechanics
# ---------------------------------------------------------------------------

def _collect(b, n, rounds=200):
    got = []
    while len(got) < n and rounds:
        got += b.drain(1, 0)
        rounds -= 1
    return got


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
class TestSocketTransport:
    def test_cross_instance_fifo(self, tmp_path, tensor):
        session = str(tmp_path / "socksess")
        a = SocketTransport(2, rank=0, session=session)
        b = SocketTransport(2, rank=1, session=session)
        try:
            for i in range(20):
                assert a.try_push(_am(i, tensor=tensor))
            got = _collect(b, 20)
            assert [m.tag for m in got] == list(range(20))
            assert b.stream_depth(1, 0) == 0
        finally:
            a.close(); b.close()

    def test_packed_and_tuple_payloads(self, tmp_path, tensor):
        session = str(tmp_path / "socksess2")
        a = SocketTransport(2, rank=0, session=session)
        b = SocketTransport(2, rank=1, session=session)
        try:
            data = np.arange(24, dtype=np.uint8).reshape(3, 8)
            burst = PackedBurst(torch.from_numpy(data) if tensor else data,
                                np.full(3, 8, np.int64), [9, 8, 7], 3)
            assert a.push_packed(WireMsg(
                WireKind.EAGER_PACKED_AM, 0, 1, payload=burst,
                size=24, rcomp=0)) == 3
            assert a.try_push(WireMsg(WireKind.CTS, 0, 1,
                                      payload=(5,), op_id=3))
            got = _collect(b, 2)
            assert port.msg_weight(got[0]) == 3
            assert np.array_equal(got[0].payload.data, data)
            assert got[1].payload == (5,)
        finally:
            a.close(); b.close()


def test_socket_large_frames_survive_partial_sends(tmp_path):
    """Frames far larger than one kernel send (fused doorbells of 64 KiB
    rows) leave in pieces, the unsent rest of a frame kept as a view:
    every frame arrives whole, in order, byte-exact."""
    session = str(tmp_path / "big")
    a = SocketTransport(2, rank=0, session=session)
    b = SocketTransport(2, rank=1, session=session)
    rng = np.random.default_rng(9)
    try:
        sent = []
        for i in range(6):
            data = rng.integers(0, 256, (16, 65536), dtype=np.uint8)
            sent.append(data)
            burst = PackedBurst(torch.from_numpy(data),
                                np.full(16, 65536, np.int64),
                                list(range(16 * i, 16 * i + 16)), 16)
            assert a.push_packed(WireMsg(WireKind.EAGER_PACKED_AM, 0, 1,
                                         payload=burst, size=data.nbytes,
                                         rcomp=0)) == 16
        got = []
        for _ in range(100_000):
            a.drain(0, 0)                 # a progress call flushes the rest
            got += b.drain(1, 0)
            if len(got) == len(sent):
                break
        assert [m.payload.tags[0] for m in got] == [16 * i for i in range(6)]
        for m, data in zip(got, sent):
            assert np.array_equal(m.payload.data, data)
        assert a.get_attr("socket_flush_frames") == 6
    finally:
        a.close(); b.close()


# ---------------------------------------------------------------------------
# cross-backend parity: the full protocol stack end to end
# ---------------------------------------------------------------------------

def _payload(kind, arr):
    return torch.from_numpy(arr) if kind == "tensor" else arr


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("backend", ["sim", "shm", "socket"])
class TestBackendParity:
    def test_eager_am_roundtrip(self, backend, kind):
        with port.LocalCluster(2, attrs={"fabric_backend": backend},
                               device="cpu") as cl:
            cq = cl[1].alloc_cq()
            rc = cl[1].register_rcomp(cq)
            buf = np.arange(64, dtype=np.uint8)
            port.post_am(cl[0], 1, _payload(kind, buf), remote_comp=rc)
            cl.quiesce()
            st = cq.pop()
            assert st.is_done()
            assert np.array_equal(_np(st.value).view(np.uint8)[:64], buf)

    def test_send_recv_all_protocols(self, backend, kind):
        """Inject, bufcopy and zero-copy rendezvous sizes all deliver
        byte-identical data on every backend, into numpy or CPU-tensor
        recv buffers (rendezvous rides the shm spill path)."""
        with port.LocalCluster(2, attrs={"fabric_backend": backend,
                                         "eager_max_bytes": 1024},
                               device="cpu") as cl:
            rng = np.random.default_rng(7)
            for size in (64, 8000, 3 * 1024 * 1024):
                src = rng.integers(0, 256, size, dtype=np.uint8)
                dst = _payload(kind, np.zeros(size, np.uint8))
                sync = cl[1].alloc_sync()
                port.post_recv(cl[1], 0, dst, size, tag=size % 997,
                               local_comp=sync)
                port.post_send(cl[0], 1, _payload(kind, src), size,
                               tag=size % 997)
                cl.quiesce()
                assert sync.test()[0]
                assert np.array_equal(_np(dst), src), f"size {size}"


def _fused_run(m, backend, kind, op, bf16):
    """A fused doorbell run through package ``m`` on ``backend``: 3
    doorbells of 8 float32 rows (bf16 on the wire when ``bf16``), as
    AMs or sends into pre-posted recv buffers; returns the delivered
    (tag, bytes) pairs in completion order."""
    kw = {"device": "cpu"} if m is port else {}
    rng = np.random.default_rng(21)
    with m.LocalCluster(2, attrs={"fabric_backend": backend,
                                  "wire_bf16": bf16}, **kw) as cl:
        ep0, ep1 = cl.alloc_endpoint(n_devices=1, name="fused")
        cq = cl[1].alloc_cq()
        rc = cl[1].register_rcomp(cq)
        out, bufs = [], []
        for d in range(3):
            rows = rng.standard_normal((8, 16)).astype(np.float32)
            pay = [torch.from_numpy(r) if (m is port and kind == "tensor")
                   else r for r in rows]
            tags = list(range(8 * d, 8 * d + 8))
            if op == "send":
                for t in tags:
                    buf = np.zeros(16, np.float32)
                    if m is port and kind == "tensor":
                        buf = torch.from_numpy(buf)
                    bufs.append(buf)
                    ep1.post_recv(0, buf, 64, tag=t, local_comp=cq)
                sts = ep0.post_send_many(1, pay, tags=tags)
            else:
                sts = ep0.post_am_many(1, pay, rc, tags=tags)
            assert not any(s.is_retry() for s in sts)
            cl.quiesce()
        while True:
            st = cq.pop()
            if not st.is_done():
                break
            out.append((st.tag, _np(st.get_buffer()).tobytes()))
        if op == "send":
            out.append(("bufs", b"".join(_np(b).tobytes() for b in bufs)))
        return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", ["am", "send"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("backend", ["shm", "socket"])
def test_fused_doorbell_matches_reference(backend, kind, op, bf16):
    """A fused doorbell of host or CPU-tensor rows over shm or socket
    delivers the reference's bytes, in the reference's order."""
    assert _fused_run(port, backend, kind, op, bf16) == \
        _fused_run(ref, backend, "numpy", op, bf16)


@pytest.mark.parametrize("backend", ["sim", "shm"])
def test_drain_limit_is_row_weighted(tmp_path, backend):
    t = Fabric(2, depth=64) if backend == "sim" else ShmTransport(2, depth=64)
    try:
        t.try_push(_am(0))
        data = torch.zeros((5, 4), dtype=torch.uint8)
        t.push_packed(WireMsg(WireKind.EAGER_PACKED_AM, 0, 1,
                              payload=PackedBurst(
                                  data, np.full(5, 4, np.int64),
                                  list(range(5)), 5),
                              size=20, rcomp=0))
        t.try_push(_am(1))
        assert t.stream_depth(1, 0) == 7
        out = t.drain(1, 0, limit=2)       # scalar + whole doorbell
        assert len(out) == 2 and port.msg_weight(out[1]) == 5
        assert t.stream_depth(1, 0) == 1
        assert t.ready(1, 0)
        assert len(t.drain(1, 0)) == 1
        assert t.stream_depth(1, 0) == 0
    finally:
        t.close()
