"""The port's serving on the comm core held against the JAX package on the
CPU.

Mirrors ``tests/test_serving.py``'s ``TestResultTokens``,
``TestSlotAllocator``, ``TestContinuousBatcher`` and the interleaved
exactly-once property, each case run through both packages:

* ``encode_token_row`` and ``ResultTokens.wire_rows`` give the reference's
  wire bytes (numpy, bytes and tensor inputs alike);
* ``SyntheticModel`` gives the reference's tokens, exact in int32;
* the same closed-loop schedule (numpy prompts from a seed, explicit
  rids) on ``LocalCluster`` (the port's with ``device="cpu"``) gives the
  same per-rid token streams and the same server counters, with and
  without ``chaos_drop`` (under chaos the retransmit timer runs on the
  wall clock, so there the streams and the completion counters are held,
  not the tick counts);
* a ``ServePlane`` over the port's ``ProcessCluster`` on ``shm``: rank 0
  the client, rank 1 the server, two OS processes
  (``tests/helpers/torch_serve_rank.py``), every stream exact.

On the CPU the server's rows are CPU tensors, so each fused decode
doorbell runs the doorbell gather's plain version
(``stage_copy_rows_ref``); ``tests/test_torch_cuda.py`` holds the same
path on the card.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from repro.core import attrs as RA
from repro.core.runtime import LocalCluster as RLocalCluster
from repro.serving import (ContinuousBatcher as RContinuousBatcher,
                           ResultTokens as RResultTokens,
                           ServePlane as RServePlane,
                           SlotAllocator as RSlotAllocator,
                           SyntheticModel as RSyntheticModel,
                           TokenClient as RTokenClient,
                           decode_token_row as r_decode_token_row,
                           encode_token_row as r_encode_token_row)

from repro_torch.core import attrs as A
from repro_torch.core import FatalError, LocalCluster
from repro_torch.core.telemetry import render_block
from repro_torch.kernels import doorbell as db
from repro_torch.serving import (ContinuousBatcher, ResultTokens, ServePlane,
                                 SlotAllocator, SlotData, SyntheticModel,
                                 TokenClient, decode_token_row,
                                 encode_token_row)
from repro_torch.serving.batching import EOT_MAX_NEW, PROMPT_RC, RESULT_RC
from repro_torch.serving.slots import SERVING_ATTRS

CPU = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))


# ---------------------------------------------------------------------------
# ResultTokens: the packed per-step array
# ---------------------------------------------------------------------------

class TestResultTokens:
    def test_pack_and_slot_views(self):
        args = dict(slots=[0, 2], rids=[7, 9], lengths=[1, 4],
                    dones=[0, 1], n_slots=4)
        rt = ResultTokens.pack(**args, tokens=torch.tensor([11, 13]))
        ref = RResultTokens.pack(**args, tokens=[11, 13])
        assert rt.data.dtype == torch.int32 and rt.data.device.type == "cpu"
        assert np.array_equal(rt.data.numpy(), ref.data)
        assert rt.n_slots == ref.n_slots == 4
        assert list(rt.active_slots()) == list(ref.active_slots()) == [0, 2]
        s2 = rt.get_result_at_slot(2)
        assert isinstance(s2, SlotData)
        assert s2.tokens[0] == 13 and s2.valid[0] == 1 and s2.lengths[0] == 4
        assert rt.get_result_at_slot(1).valid[0] == 0

    @pytest.mark.parametrize("tokens_as", ["list", "tensor"])
    def test_wire_rows_roundtrip(self, tokens_as):
        tokens = [100, 200]
        if tokens_as == "tensor":
            tokens = torch.tensor(tokens, dtype=torch.int32)
        rt = ResultTokens.pack(slots=[1, 3], rids=[5, 6], tokens=tokens,
                               lengths=[3, 1], dones=[1, 0], n_slots=4)
        ref = RResultTokens.pack(slots=[1, 3], rids=[5, 6],
                                 tokens=[100, 200], lengths=[3, 1],
                                 dones=[1, 0], n_slots=4)
        rows, rrows = rt.wire_rows(), ref.wire_rows()
        assert [rid for rid, _ in rows] == [rid for rid, _ in rrows] == [5, 6]
        for (_, row), (_, rrow) in zip(rows, rrows):
            assert row.dtype == torch.uint8 and row.nbytes == 16
            assert row.numpy().tobytes() == rrow.tobytes()
        assert decode_token_row(rows[0][1]) == (5, 2, 100, 1)
        assert decode_token_row(rows[1][1]) == (6, 0, 200, 0)
        assert {r.nbytes for _, r in rows} == {16}

    @pytest.mark.parametrize("seed", range(4))
    def test_wire_rows_of_a_decode_step(self, seed):
        """Unsorted slots, tokens from a device decode: the rows come out
        in ascending slot order with the reference's bytes; an array not
        built by pack gives the same rows from the data alone."""
        rng = np.random.default_rng(seed)
        n_slots = 16
        n = int(rng.integers(1, n_slots + 1))
        slots = [int(s) for s in rng.permutation(n_slots)[:n]]
        rids = [int(r) for r in rng.integers(1, 1 << 20, n)]
        lengths = [int(x) for x in rng.integers(1, 64, n)]
        dones = [int(x) for x in rng.integers(0, 2, n)]
        pos = [int(x) for x in rng.integers(0, 300, n)]
        model = SyntheticModel(seed=seed, device=CPU)
        toks = model.decode(rids, pos)
        rt = ResultTokens.pack(slots, rids, toks, lengths, dones, n_slots)
        ref = RResultTokens.pack(
            slots, rids, [int(t) for t in RSyntheticModel(seed).decode(
                rids, pos)], lengths, dones, n_slots)
        assert np.array_equal(rt.data.numpy(), ref.data)
        got = [(rid, row.numpy().tobytes()) for rid, row in rt.wire_rows()]
        want = [(rid, row.tobytes()) for rid, row in ref.wire_rows()]
        assert got == want
        raw = ResultTokens(rt.data.numpy())
        assert [(rid, row.numpy().tobytes())
                for rid, row in raw.wire_rows()] == want

    def test_rejects_bad_shape_and_row(self):
        for bad in (np.zeros((4, 3), np.int32), torch.zeros(4, 3)):
            with pytest.raises(ValueError, match=r"\(n_slots, 5\)"):
                ResultTokens(bad)
        with pytest.raises(ValueError, match="16 bytes, got 12"):
            decode_token_row(b"\x00" * 12)
        with pytest.raises(ValueError) as ref_err:
            r_decode_token_row(b"\x00" * 12)
        with pytest.raises(ValueError) as port_err:
            decode_token_row(torch.zeros(12, dtype=torch.uint8))
        assert str(port_err.value) == str(ref_err.value)
        assert decode_token_row(encode_token_row(1, 2, 3, 1)) == (1, 2, 3, 1)

    @pytest.mark.parametrize("form", ["numpy", "bytes", "memoryview",
                                      "tensor", "int32_tensor"])
    def test_token_rows_match_reference(self, form):
        rng = np.random.default_rng(7)
        for rid, seq, tok, done in rng.integers(0, 1 << 31, (8, 4)):
            want = r_encode_token_row(int(rid), int(seq), int(tok),
                                      int(done))
            row = encode_token_row(int(rid), int(seq), int(tok), int(done))
            assert row.dtype == np.uint8 and row.tobytes() == want.tobytes()
            buf = {"numpy": row, "bytes": row.tobytes(),
                   "memoryview": memoryview(row.tobytes()),
                   "tensor": torch.from_numpy(row.copy()),
                   "int32_tensor": torch.from_numpy(row.view(np.int32)
                                                    .copy())}[form]
            assert decode_token_row(buf) == r_decode_token_row(want)

    def test_token_row_from_a_tensor_token(self):
        """A tensor field builds the row as a tensor on its device."""
        tok = torch.tensor([31999], dtype=torch.int32)
        row = encode_token_row(5, 3, tok[0], 1)
        assert isinstance(row, torch.Tensor) and row.dtype == torch.uint8
        assert row.numpy().tobytes() == \
            r_encode_token_row(5, 3, 31999, 1).tobytes()


# ---------------------------------------------------------------------------
# SyntheticModel: the oracle
# ---------------------------------------------------------------------------

class TestSyntheticModel:
    @pytest.mark.parametrize("seed,vocab", [(0, 32000), (7, 32000),
                                            (123456, 50257), (3, 17)])
    def test_tokens_match_reference(self, seed, vocab):
        rng = np.random.default_rng(seed)
        rids = rng.integers(0, 1 << 31, 200)
        pos = rng.integers(0, 1 << 20, 200)
        m, r = SyntheticModel(seed, vocab, device=CPU), RSyntheticModel(seed,
                                                                      vocab)
        got = m.decode(list(rids), list(pos))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), r.decode(rids, pos))
        assert np.array_equal(m.expected(99, 17, 40), r.expected(99, 17, 40))
        prompt = rng.integers(0, vocab, 300).astype(np.int32)
        assert m.prefill(1, prompt) == r.prefill(1, prompt)

    def test_device_defaults_to_the_card(self):
        if torch.cuda.is_available():
            assert SyntheticModel().device.type == "cuda"
        else:
            with pytest.raises(FatalError, match="device='cpu'"):
                SyntheticModel()


# ---------------------------------------------------------------------------
# slot allocator: admission through the attr chain
# ---------------------------------------------------------------------------

class TestSlotAllocator:
    def test_attrs_validate_at_alloc(self):
        for kw, name in (({"kv_slots": 0}, "kv_slots"),
                         ({"kv_page_tokens": -1}, "kv_page_tokens"),
                         ({"kv_evict": "lru"}, "kv_evict")):
            with pytest.raises(A.AttrError, match=name):
                SlotAllocator(**kw)
            with pytest.raises(RA.AttrError, match=name):
                RSlotAllocator(**kw)

    def test_env_layer_reaches_allocator(self, monkeypatch):
        monkeypatch.setenv("REPRO_ATTR_KV_SLOTS", "3")
        monkeypatch.setenv("REPRO_ATTR_KV_EVICT", "preempt_longest")
        sa = SlotAllocator()
        assert sa.n_slots == 3
        assert sa.evict_policy == "preempt_longest"
        assert sa.get_attr("kv_slots") == 3
        monkeypatch.setenv("REPRO_ATTR_KV_EVICT", "bogus")
        with pytest.raises(A.AttrError, match="kv_evict"):
            SlotAllocator()

    def test_get_attr_surface(self):
        kw = dict(kv_slots=2, kv_page_tokens=4, kv_pages=6)
        sa, ref = SlotAllocator(**kw), RSlotAllocator(**kw)
        for name in ("kv_pages", "free_slots", "occupancy", "kv_evict",
                     "free_pages", "active_slots"):
            assert sa.get_attr(name) == ref.get_attr(name), name
        assert sa.attrs_echo() == ref.attrs_echo()
        with pytest.raises(A.AttrError, match="nope"):
            sa.get_attr("nope")

    def test_admission_is_ternary_and_all_or_nothing(self):
        sas = (SlotAllocator(kv_slots=2, kv_page_tokens=4, kv_pages=4),
               RSlotAllocator(kv_slots=2, kv_page_tokens=4, kv_pages=4))
        for sa in sas:
            st = sa.admit(1, 8)
            assert st.is_done() and st.value == 0
            assert sa.admit(2, 9).is_retry()
            assert sa.get_attr("free_pages") == 2
            assert sa.admit(2, 8).is_done()
            assert sa.admit(3, 4).is_retry()
            with pytest.raises(ValueError):
                sa.admit(1, 4)
            sa.release(1)
            assert sa.occupancy() == 0.5
            assert sa.admit(3, 4).is_done()
        assert sas[0].counters() == sas[1].counters()
        assert sas[0].counters()["rejections"] == 2

    def test_victim_is_largest_footprint(self):
        for cls in (SlotAllocator, RSlotAllocator):
            sa = cls(kv_slots=4, kv_page_tokens=4,
                     kv_evict="preempt_longest")
            for rid, tokens in ((1, 4), (2, 20), (3, 8)):
                assert sa.admit(rid, tokens).is_done()
            assert sa.victim() == 2
            refuse = cls(kv_slots=4, kv_page_tokens=4)
            refuse.admit(1, 20)
            assert refuse.victim() is None

    def test_serving_attrs_are_the_reference_set(self):
        from repro.serving.slots import SERVING_ATTRS as R_ATTRS
        assert SERVING_ATTRS == R_ATTRS


# ---------------------------------------------------------------------------
# the engine end to end, both packages on the same schedule
# ---------------------------------------------------------------------------

#: the counters both packages must agree on
COUNTERS = ("completed", "tokens_generated", "preemptions",
            "admission_rejections", "delivery_retries")


def _streams(client):
    """rid -> sorted [(seq, token, done)] the client's drains popped."""
    out = {}
    for chunk in client.drain.worker_results():
        for entry in chunk:
            st = entry[0] if isinstance(entry, tuple) else entry
            rid, seq, tok, done = decode_token_row(st.get_buffer())
            out.setdefault(rid, []).append((seq, tok, done))
    return {rid: sorted(v) for rid, v in out.items()}


def _serve(pkg, specs, *, seed, attrs=None, step_every=1, deadline_s=60.0,
           **server_kw):
    """The closed-loop schedule of ``tests/test_serving.py::_drive`` on
    one package (``"port"`` on the CPU, or ``"ref"``), with explicit rids
    1..n so both packages name the requests alike."""
    if pkg == "port":
        cluster = LocalCluster(2, attrs=attrs, device=CPU)
        model = SyntheticModel(seed=seed, device=CPU)
        classes = (ServePlane, ContinuousBatcher, TokenClient)
    else:
        cluster = RLocalCluster(2, attrs=attrs)
        model = RSyntheticModel(seed=seed)
        classes = (RServePlane, RContinuousBatcher, RTokenClient)
    try:
        plane = classes[0](cluster)
        server = classes[1](plane, model, **server_kw)
        client = classes[2](plane, model, drain_workers=2)
        rng = np.random.default_rng(1234)
        for i, (plen, max_new) in enumerate(specs):
            prompt = rng.integers(0, 1000, plen).astype(np.int32)
            rid, stat = client.submit(prompt, max_new, rid=i + 1)
            tries = 0
            while stat.is_retry():
                client.pump()
                server.step()
                tries += 1
                assert tries < 2000, "submit never accepted"
                rid, stat = client.submit(prompt, max_new, rid=rid)
            if i % step_every == 0:
                server.step()
        t0 = time.monotonic()
        while not (server.completed >= len(specs) and server.idle):
            server.step()
            assert time.monotonic() - t0 < deadline_s, (
                f"server stalled: {server.counters()}")
        while client.drain.drained < client.expected_tokens:
            client.pump()
            if time.monotonic() - t0 > deadline_s:
                break
        report = client.collect()
        return report, server.counters(), _streams(client), server
    finally:
        cluster.close()


def _assert_exactly_once(report, n_requests):
    assert report["completed"] == n_requests
    for key in ("lost", "duplicated", "mismatched", "out_of_order",
                "bad_done", "unexpected"):
        assert report[key] == 0, (key, report)


def _same_run(specs, *, seed, chaos=False, **kw):
    """Both packages on one schedule: exactly-once in each, the same
    streams, and the same counters (under chaos only the ones the wall
    clock cannot move)."""
    attrs = {"chaos_drop": 0.05, "chaos_seed": 99} if chaos else None
    port = _serve("port", specs, seed=seed, attrs=attrs, **kw)
    ref = _serve("ref", specs, seed=seed, attrs=attrs, **kw)
    for report, *_ in (port, ref):
        _assert_exactly_once(report, len(specs))
    assert port[2] == ref[2]
    assert len(port[2]) == len(specs)
    keys = ("completed", "tokens_generated") if chaos else COUNTERS
    assert {k: port[1][k] for k in keys} == {k: ref[1][k] for k in keys}
    if not chaos:
        assert port[1] == ref[1]
    return port, ref


class TestContinuousBatcher:
    def test_serve_roundtrip_exactly_once(self):
        specs = [(30, 8), (1, 1), (64, 4), (5, 12), (17, 3), (40, 6),
                 (2, 9), (33, 1)]
        launches = db.stage_copy_rows.launches
        (report, _, _, server), _ = _same_run(
            specs, seed=7, kv_slots=4, kv_page_tokens=8, prefill_chunk=16)
        assert report["tokens"] == sum(m for _, m in specs)
        assert len(report["ttft_s"]) == len(specs)
        assert server.slots.occupancy() == 0.0
        # CPU rows: the fused doorbells staged through the gather's plain
        # version, which counts no launch
        assert db.stage_copy_rows.launches == launches

    def test_engine_attr_chain_and_introspection(self):
        cluster = LocalCluster(2, attrs={"kv_slots": 6, "prefill_chunk": 4},
                               device=CPU)
        try:
            plane = ServePlane(cluster)
            model = SyntheticModel(device=CPU)
            server = ContinuousBatcher(plane, model, max_batch=5)
            assert server.get_attr("kv_slots") == 6
            assert server.get_attr("prefill_chunk") == 4
            assert server.get_attr("max_batch") == 5
            for name in SERVING_ATTRS:
                server.get_attr(name)
            assert server.get_attr("active_requests") == 0
            assert server.get_attr("occupancy") == 0.0
            echo = server.attrs_echo()
            assert echo["sources"]["kv_slots"] == "runtime"
            assert echo["sources"]["max_batch"] == "resource"
            with pytest.raises(A.AttrError, match="kv_page_tokens"):
                ContinuousBatcher(plane, model, kv_page_tokens=0)
        finally:
            cluster.close()

    def test_zero_means_derived_geometry(self):
        cluster = LocalCluster(2, device=CPU)
        try:
            server = ContinuousBatcher(ServePlane(cluster),
                                       SyntheticModel(device=CPU),
                                       kv_slots=3)
            assert server.slots.n_pages == 24
            assert server.max_batch == 3
        finally:
            cluster.close()

    def test_preempt_longest_never_duplicates(self):
        specs = [(4, 6), (2, 2), (2, 2), (1, 3), (2, 1)]
        (_, counters, _, _), _ = _same_run(
            specs, seed=2, step_every=2, kv_slots=3, kv_page_tokens=2,
            kv_pages=6, kv_evict="preempt_longest", prefill_chunk=4)
        assert counters["preemptions"] > 0

    def test_refuse_policy_backlogs_instead(self):
        (_, counters, _, _), _ = _same_run(
            [(8, 4)] * 5, seed=4, kv_slots=1, kv_page_tokens=4)
        assert counters["preemptions"] == 0
        assert counters["backlog_max_depth"] > 0

    def test_plane_requires_distinct_ranks_and_first_rcomp(self):
        cluster = LocalCluster(2, device=CPU)
        try:
            with pytest.raises(FatalError, match="distinct"):
                ServePlane(cluster, client_rank=0, server_rank=0)
            cluster[1].register_rcomp(cluster[1].alloc_cq())
            with pytest.raises(FatalError, match="first"):
                ServePlane(cluster)
        finally:
            cluster.close()
        assert PROMPT_RC == RESULT_RC == 0 and EOT_MAX_NEW == -1

    def test_stage_spans_cover_the_pipeline(self):
        cluster = LocalCluster(2, attrs={"telemetry_level": "timers"},
                               device=CPU)
        try:
            plane = ServePlane(cluster)
            model = SyntheticModel(seed=1, device=CPU)
            server = ContinuousBatcher(plane, model, kv_slots=4)
            client = TokenClient(plane, model, drain_workers=2)
            for rid, (plen, max_new) in enumerate([(20, 4), (3, 2)], 1):
                prompt = np.arange(plen, dtype=np.int32)
                assert client.submit(prompt, max_new, rid=rid)[1].is_done()
                server.step()
            server.run_until_idle()
            while client.drain.drained < client.expected_tokens:
                client.pump()
            _assert_exactly_once(client.collect(), 2)
            spans = render_block(cluster.tele.snapshot())["spans"]
            for stage in ("serve.enqueue", "serve.prefill", "serve.insert",
                          "serve.decode", "serve.deliver", "serve.drain"):
                assert spans.get(stage, {}).get("count", 0) > 0, stage
        finally:
            cluster.close()



# ---------------------------------------------------------------------------
# the exactly-once property under interleaving + chaos, both packages
# ---------------------------------------------------------------------------

def _specs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 11))
    return [(int(p), int(m)) for p, m in zip(rng.integers(1, 25, n),
                                             rng.integers(1, 9, n))], \
        int(rng.integers(1, 5))


@pytest.mark.parametrize("chaos", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_property_interleaved_serve_exactly_once(seed, chaos):
    """Interleaved prefill-insert/decode/drain with thread-safe CQs and 2
    drain workers: the port never drops, duplicates or reorders a
    client's stream, and gives the reference's streams, with or without
    ``chaos_drop=0.05`` underneath."""
    specs, step_every = _specs(seed)
    _same_run(specs, seed=len(specs), chaos=chaos, step_every=step_every,
              kv_slots=2, kv_page_tokens=4, prefill_chunk=8,
              deadline_s=60.0)


def test_chaos_burst_serve_matches_reference():
    """Enough concurrent streams that decode bursts fuse (4 rows or more)
    while 5% of the frames drop: every stream still arrives exactly once
    and equals the reference's."""
    rng = np.random.default_rng(11)
    specs = [(int(p), int(m)) for p, m in zip(rng.integers(1, 40, 24),
                                              rng.integers(4, 12, 24))]
    (_, counters, _, server), _ = _same_run(specs, seed=5, chaos=True,
                                            kv_slots=8, kv_page_tokens=8)
    assert counters["tokens_generated"] == sum(m for _, m in specs)
    assert server.runtime.engine.burst_posts > 0           # bursts fused


# ---------------------------------------------------------------------------
# ServePlane over ProcessCluster: two OS processes on shm
# ---------------------------------------------------------------------------

def test_serve_plane_across_two_processes_on_shm():
    """Rank 0 runs the TokenClient, rank 1 the ContinuousBatcher, over
    the port's shm transport through its SPMD launcher; the client sends
    the end-of-traffic message only after draining every token."""
    from repro_torch.launch import spmd
    outdir = tempfile.mkdtemp(prefix="torch-serve-xproc-")
    try:
        code = spmd.launch(
            [sys.executable, os.path.join(HERE, "helpers",
                                          "torch_serve_rank.py"), outdir],
            2, backend="shm", timeout=120,
            env={"PYTHONPATH": SRC + os.pathsep
                 + os.environ.get("PYTHONPATH", "")})
        reports = {}
        for r in range(2):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                reports[r] = json.load(f)
    finally:
        import shutil
        shutil.rmtree(outdir, ignore_errors=True)
    assert code == 0, reports
    client, server = reports[0], reports[1]
    assert client["role"] == "client" and server["role"] == "server"
    _assert_exactly_once(client["report"], client["n_requests"])
    assert server["counters"]["completed"] == client["n_requests"]
    assert server["counters"]["tokens_generated"] == \
        client["report"]["tokens"]
    # the streams equal the reference model's
    ref = RSyntheticModel(seed=client["seed"])
    for rid, (plen, max_new, toks) in client["streams"].items():
        assert toks == ref.expected(int(rid), plen, max_new).tolist()


def test_parked_rows_redeliver_in_order():
    """A result CQ of two entries rejects most of each burst at the
    client: the rejected completions park in the client device's backlog
    and every later completion to that CQ queues behind them, so each
    drain worker still sees a client's stream in order.  (The
    reference's engine lets a later completion overtake a parked one
    when a drain worker frees a slot in between: ROADMAP §C.  Its
    streams are compared as sets of rows, which that cannot change.)"""
    rng = np.random.default_rng(12)
    specs = [(int(p), int(m)) for p, m in zip(rng.integers(1, 30, 24),
                                              rng.integers(4, 12, 24))]
    port = _serve("port", specs, seed=6, attrs={"cq_capacity": 2},
                  kv_slots=8, kv_page_tokens=8)
    ref = _serve("ref", specs, seed=6, attrs={"cq_capacity": 2},
                 kv_slots=8, kv_page_tokens=8)
    _assert_exactly_once(port[0], len(specs))
    assert port[2] == ref[2]
    assert port[3].runtime.engine.burst_posts > 0


def test_completions_queue_behind_parked_ones():
    """The engine-level rule the test above rests on: while a rejected
    completion waits in the backlog, a later one to the same queue parks
    behind it instead of taking a slot a consumer freed."""
    from repro_torch.core import done
    cl = LocalCluster(1, device=CPU)
    try:
        rt = cl[0]
        cq = rt.alloc_cq(capacity=1)
        eng, dev = rt.engine, rt.default_device
        eng.signal(cq, done(0, tag=0), dev)
        eng.signal(cq, done(1, tag=1), dev)          # rejected: parks
        assert cq.pop().tag == 0                     # a slot frees
        eng.signal_many(cq, [done(2, tag=2)], dev)   # must not overtake
        eng.signal(cq, done(3, tag=3), dev)
        tags = []
        for _ in range(8):
            rt.progress()
            while True:
                st = cq.pop()
                if st.is_retry():
                    break
                tags.append(st.tag)
        assert tags == [1, 2, 3]
        assert not eng._parked_signals
    finally:
        cl.close()
