"""Slot-based continuous batching on the comm core (DESIGN.md §17).

The mirror of :mod:`repro.serving.batching` on the port.  Token values
stay on the engine's device from :meth:`SyntheticModel.decode` through
:class:`~repro_torch.serving.result_tokens.ResultTokens` to the fused
doorbell, whose rows the doorbell kernel gathers on the card; the
server's tick is steered by host quantities only (``generated``,
``max_new``, slots), so it never waits on the card.

The paper's "new possibilities" scenario made load-bearing: a serving
engine whose *entire* data plane is the LCI runtime.

* **Endpoint isolation** — prompts (large, bursty) ride a ``by_size``
  striped prefill endpoint; token returns (tiny, latency-critical) ride
  a separate decode endpoint, so a decode token never queues behind a
  bulk prompt on the same device stream (paper §3.2.3).
* **CompletionGraph interleaving** — every engine tick is a completion
  graph: per-request prefill-chunk chains (bounded by the
  ``prefill_chunk`` attr) end in an insert node whose first token is a
  *comm node* on the decode endpoint, while the decode step for already
  resident slots runs as an independent chain.  No edges connect the
  chains, so the graph's ready-set execution interleaves prefill with
  decode — a long prompt cannot stall resident streams.
* **Burst delivery** — each decode step packs its tokens into one
  :class:`~repro_torch.serving.result_tokens.ResultTokens` array and posts the
  uniform 16-byte rows through ``post_am_many`` — one doorbell, fused
  into a single ``PackedBurst`` when the run is long enough.
* **Exactly-once drains** — the client's thread-safe result CQ is popped
  by :class:`~repro_torch.serving.scheduler.ResultDrain` workers; rows a full
  CQ or fabric rejected with ``retry`` park per-client **in order** and
  redeliver ahead of new tokens, so a client's stream is never dropped,
  duplicated, or reordered — including under ``chaos_drop`` faults,
  where the reliability plane retransmits underneath.
* **Paged KV attrs** — slot count, page size, total pages, and the
  eviction policy resolve through the four-layer attr chain
  (:data:`~repro_torch.serving.slots.SERVING_ATTRS`) with full ``get_attr``
  introspection, and every stage is a telemetry span
  (``serve.enqueue/prefill/insert/decode/deliver/drain``).

Roles split cleanly across ranks so the same classes run single-process
(:class:`~repro_torch.core.runtime.LocalCluster`, both roles in one address
space) or as an SPMD job (:class:`~repro_torch.core.runtime.ProcessCluster`,
client and server in separate OS processes over shm rings).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import attrs as _attrs
from ..core.backlog import BacklogQueue
from ..core.graph import CompletionGraph
from ..core.post import post_am_x
from ..core.runtime import resolve_device
from ..core.status import FatalError
from .result_tokens import (ROW_BYTES, ResultTokens, decode_token_row,
                            encode_token_row, to_device)
from .scheduler import ResultDrain
from .slots import SERVING_ATTRS, SlotAllocator

#: deterministic remote-completion handles: each role registers exactly
#: one rcomp on its own runtime, first, so both sides can name the
#: peer's handle without an exchange (required for process mode, where
#: the peer's registry is another process's memory)
PROMPT_RC = 0
RESULT_RC = 0

#: a prompt whose max_new field carries this value is the end-of-traffic
#: control message (process-mode shutdown), not a request
EOT_MAX_NEW = -1

_rid_counter = itertools.count(1)


def _mix(r, p, seed: int, vocab: int):
    """Token ``(rid, pos)``: the reference's formula, on int64 numpy
    arrays or int64 tensors alike (every term is non-negative, so ``%``
    agrees across the two)."""
    return (r * 1_000_003 + p * 9_176_919 + seed * 2_654_435_761) % vocab


class SyntheticModel:
    """Deterministic stand-in for the model compute: token ``(rid, pos)``
    is a pure function, so the *client* can recompute the exact stream it
    must receive — the exactly-once verification oracle.

    :meth:`decode` runs on ``device`` (the card unless the caller asks
    for the CPU) and returns an int32 tensor there; :meth:`expected`,
    the client's oracle, stays on the host."""

    def __init__(self, seed: int = 0, vocab: int = 32000, device=None):
        self.seed = seed
        self.vocab = vocab
        self.device = resolve_device(device)

    def decode(self, rids, positions) -> torch.Tensor:
        """Tokens at ``(rids[i], positions[i])`` (host ints), an int32
        tensor on the model's device; the inputs cross in one copy that
        does not block the host."""
        rp = to_device(np.array([rids, positions], np.int64).reshape(2, -1),
                       self.device)
        return _mix(rp[0], rp[1], self.seed, self.vocab).to(torch.int32)

    def prefill(self, rid: int, tokens: np.ndarray) -> int:
        """One prefill chunk's "KV build" — a pure host reduction."""
        return int(np.sum(np.asarray(tokens, np.int64))) & 0x7FFFFFFF

    def expected(self, rid: int, prompt_len: int, n: int) -> np.ndarray:
        """The full token stream request ``rid`` must receive (host)."""
        return _mix(np.full(n, rid, np.int64),
                    prompt_len + np.arange(n, dtype=np.int64), self.seed,
                    self.vocab).astype(np.int32)


class ServePlane:
    """The serving comm plane: symmetric striped endpoints plus the two
    registered completion queues.

    Allocation is symmetric per rank (device streams match by index), so
    construction works on a :class:`LocalCluster` (both roles local) and
    on each rank of a :class:`ProcessCluster` (only the local role's CQ
    exists).  Each role registers its CQ as the *first* rcomp on its
    runtime, pinning the deterministic handles :data:`PROMPT_RC` /
    :data:`RESULT_RC` both sides rely on.
    """

    def __init__(self, cluster, *, client_rank: int = 0,
                 server_rank: int = 1, n_prefill: int = 2,
                 n_decode: int = 1):
        if client_rank == server_rank:
            raise FatalError("ServePlane: client and server must be "
                             "distinct ranks")
        self.cluster = cluster
        self.client_rank = client_rank
        self.server_rank = server_rank
        self.tele = cluster.tele
        self.prefill: Dict[int, object] = {}
        self.decode: Dict[int, object] = {}
        local = []
        for rt in cluster.local_runtimes():
            local.append(rt.rank)
            self.prefill[rt.rank] = rt.alloc_endpoint(
                n_prefill, "by_size", "dedicated",
                name=f"serve/prefill@{rt.rank}")
            self.decode[rt.rank] = rt.alloc_endpoint(
                n_decode, "round_robin", name=f"serve/decode@{rt.rank}")
        self.prompt_cq = None
        self.result_cq = None
        if server_rank in local:
            srv = cluster[server_rank]
            self.prompt_cq = srv.alloc_cq()
            rc = srv.register_rcomp(self.prompt_cq)
            if rc != PROMPT_RC:
                raise FatalError(
                    f"ServePlane must register the prompt CQ first on the "
                    f"server runtime (got rcomp handle {rc}); allocate the "
                    f"plane before other rcomp registrations")
        if client_rank in local:
            cli = cluster[client_rank]
            self.result_cq = cli.alloc_cq(threadsafe=True)
            rc = cli.register_rcomp(self.result_cq)
            if rc != RESULT_RC:
                raise FatalError(
                    f"ServePlane must register the result CQ first on the "
                    f"client runtime (got rcomp handle {rc}); allocate the "
                    f"plane before other rcomp registrations")

    def pump(self, rounds: int = 1) -> int:
        """Drive progress on every local endpoint device."""
        n = 0
        for eps in (self.prefill, self.decode):
            for ep in eps.values():
                n += ep.progress(rounds)
        return n

    def counters(self) -> dict:
        return {
            "prefill": [ep.counters() for ep in self.prefill.values()],
            "decode": [ep.counters() for ep in self.decode.values()],
        }


class _ServeReq:
    """Server-side request state (one resident slot's stream)."""

    __slots__ = ("rid", "prompt", "max_new", "generated")

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated = 0                 # == next token's seq number

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


class ContinuousBatcher(_attrs.AttrResource):
    """The server role: admit → prefill/insert → decode → burst-deliver.

    Every tunable (``kv_*``, ``prefill_chunk``, ``max_batch``) resolves
    through the four-layer attr chain at construction; ``get_attr``
    answers for all of them plus the discovered state (occupancy, active
    slots, parked rows).
    """

    def __init__(self, plane: ServePlane, model, **overrides):
        self.plane = plane
        self.model = model
        self.tele = plane.tele
        cluster = plane.cluster
        resolved = _attrs.resolve(
            SERVING_ATTRS, runtime=getattr(cluster, "_attr_layer", None),
            overrides=overrides)
        self.slots = SlotAllocator(resolved=resolved)
        self.prefill_chunk: int = resolved["prefill_chunk"]
        self.max_batch: int = resolved["max_batch"] or resolved["kv_slots"]
        self.runtime = cluster[plane.server_rank]
        self.decode_ep = plane.decode[plane.server_rank]
        self.active: Dict[int, _ServeReq] = {}       # resident (all states)
        self.decoding: Dict[int, _ServeReq] = {}     # past first token
        self._inserting: List[_ServeReq] = []        # admitted this tick
        self.backlog = BacklogQueue()
        # rows a full CQ / full fabric rejected: parked per client, FIFO,
        # redelivered ahead of that client's new tokens (order survives);
        # each row is a 16-byte view of its tick's wire image
        self._parked: Dict[int, List[torch.Tensor]] = {}
        self.eot_seen = False
        self.ticks = 0
        self.arrived = 0
        self.completed = 0
        self.tokens_generated = 0
        self.delivery_retries = 0
        self._init_attrs(resolved)
        self._export_attr("active_requests", lambda: len(self.active))
        self._export_attr("backlog_depth", lambda: len(self.backlog))
        self._export_attr("parked_rows", lambda: sum(
            len(q) for q in self._parked.values()))
        self._export_attr("occupancy", self.slots.occupancy)
        self.tele.attach("serve", self.counters)

    # -- admission -----------------------------------------------------------
    def _admit_now(self, req: _ServeReq) -> bool:
        if len(self.active) >= self.max_batch:
            return False
        total = req.prompt_len + req.max_new
        st = self.slots.admit(req.rid, total)
        if st.is_retry() and self.slots.evict_policy == "preempt_longest":
            victim = self._pick_victim(exclude=req.rid)
            if victim is not None:
                self._preempt(victim)
                st = self.slots.admit(req.rid, total)
        if st.is_retry():
            return False
        self.active[req.rid] = req
        self._inserting.append(req)
        return True

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Largest-footprint resident stream that is safely preemptible:
        already decoding and not back-pressured (a parked stream's pages
        cannot move without risking reorder)."""
        eligible = [r for r in self.decoding
                    if r != exclude and r not in self._parked]
        if not eligible:
            return None
        return max(eligible,
                   key=lambda r: self.slots.tokens_of.get(r, 0))

    def _preempt(self, rid: int) -> None:
        req = self.active.pop(rid)
        self.decoding.pop(rid, None)
        self.slots.release(rid)
        self.slots.preemptions += 1
        # generated-token count survives: on re-admission the stream
        # re-prefills prompt+generated and resumes at seq=generated —
        # recompute-style preemption with zero duplicated tokens
        self.backlog.push(req)

    def _ingest(self) -> None:
        cq = self.plane.prompt_cq
        while True:
            st = cq.pop()
            if st.is_retry():
                return
            with self.tele.span("serve.enqueue"):
                data = np.asarray(st.get_buffer()).view(np.int32)
                rid, max_new = int(data[0]), int(data[1])
                if max_new == EOT_MAX_NEW:
                    self.eot_seen = True
                    continue
                req = _ServeReq(rid, data[2:].copy(), max_new)
                self.arrived += 1
                if not self._admit_now(req):
                    self.backlog.push(req)

    def _readmit_backlog(self) -> None:
        while not self.backlog.empty_flag \
                and len(self.active) < self.max_batch:
            req, st = self.backlog.pop()
            if st.is_retry():
                return
            if not self._admit_now(req):
                self.backlog.push_front(req)
                return

    # -- the tick graph ------------------------------------------------------
    def _make_prefill_fn(self, req: _ServeReq, c0: int, c1: int):
        def fn(*_):
            with self.tele.span("serve.prefill"):
                chunk = req.prompt[c0:min(c1, req.prompt_len)]
                return self.model.prefill(req.rid, chunk)
        return fn

    def _make_insert_fn(self, req: _ServeReq, buf: torch.Tensor):
        def fn(*_):
            with self.tele.span("serve.insert"):
                seq = req.generated
                tok = self.model.decode([req.rid], [req.prompt_len + seq])
                req.generated += 1
                self.tokens_generated += 1
                is_done = req.generated >= req.max_new
                # the row is written on the token's device: the token is
                # never read back
                buf.copy_(encode_token_row(req.rid, seq, tok[0],
                                           int(is_done)))
                if is_done:
                    self._finish(req)
            return req.rid
        return fn

    def _make_activate_fn(self, req: _ServeReq):
        def fn(*_):
            if req.rid in self.active and req.generated < req.max_new:
                self.decoding[req.rid] = req
            return req.rid
        return fn

    def _build_graph(self) -> Optional[CompletionGraph]:
        decode_rids = [r for r in self.decoding if r not in self._parked]
        inserting, self._inserting = self._inserting, []
        if not decode_rids and not inserting:
            return None
        g = CompletionGraph(name=f"serve/tick{self.ticks}")
        if decode_rids:
            d = g.add_node(lambda: self._decode_step(decode_rids),
                           name="decode")
            g.add_node(lambda res: self._deliver(res.wire_rows()),
                       deps=(d,), name="deliver")
        for req in inserting:
            # resumed streams re-prefill their generated suffix too
            length = req.prompt_len + req.generated
            deps: Tuple[int, ...] = ()
            for c0 in range(0, max(length, 1), self.prefill_chunk):
                nid = g.add_node(
                    self._make_prefill_fn(req, c0, c0 + self.prefill_chunk),
                    deps=deps, name=f"prefill/{req.rid}/{c0}")
                deps = (nid,)
            buf = torch.zeros(ROW_BYTES, dtype=torch.uint8,
                              device=self.model.device)
            ins = g.add_node(self._make_insert_fn(req, buf), deps=deps,
                             name=f"insert/{req.rid}")
            # the first token is a comm NODE: posted at readiness on the
            # decode endpoint, completed by the progress engine — this is
            # what interleaves prefill chains with the decode chain
            cm = g.add_comm(
                post_am_x(self.runtime, self.plane.client_rank, buf)
                .remote_comp(RESULT_RC).tag(req.rid)
                .endpoint(self.decode_ep),
                deps=(ins,), name=f"first_tok/{req.rid}")
            g.add_node(self._make_activate_fn(req), deps=(cm,),
                       name=f"activate/{req.rid}")
        return g

    def _decode_step(self, rids: List[int]) -> ResultTokens:
        with self.tele.span("serve.decode"):
            reqs = [self.decoding[r] for r in rids]
            positions = [r.prompt_len + r.generated for r in reqs]
            toks = self.model.decode([r.rid for r in reqs], positions)
            slot_ids = [self.slots.slot_of[r.rid] for r in reqs]
            lengths, dones = [], []
            for req in reqs:
                req.generated += 1
                self.tokens_generated += 1
                lengths.append(req.generated)
                is_done = req.generated >= req.max_new
                dones.append(int(is_done))
                if is_done:
                    self._finish(req)
            return ResultTokens.pack(slot_ids, [r.rid for r in reqs], toks,
                                     lengths, dones,
                                     n_slots=self.slots.n_slots)

    def _finish(self, req: _ServeReq) -> None:
        self.slots.release(req.rid)
        self.active.pop(req.rid, None)
        self.decoding.pop(req.rid, None)
        self.completed += 1

    # -- burst delivery ------------------------------------------------------
    def _deliver(self, rows: List[Tuple[int, torch.Tensor]]) -> int:
        """Burst-post token rows over the decode endpoint.  Parked rows
        flush first; a client with parked rows gets its new rows parked
        behind them (per-client order is sacred)."""
        with self.tele.span("serve.deliver"):
            burst: List[Tuple[int, torch.Tensor]] = [
                (rid, buf) for rid, q in self._parked.items() for buf in q]
            for rid, buf in rows:
                if rid in self._parked:
                    self._parked[rid].append(buf)
                else:
                    burst.append((rid, buf))
            if not burst:
                return 0
            sts = self.decode_ep.post_am_many(
                self.plane.client_rank, [b for _, b in burst], RESULT_RC,
                tags=[r for r, _ in burst])
            parked: Dict[int, List[torch.Tensor]] = {}
            accepted = 0
            for (rid, buf), st in zip(burst, sts):
                if st.is_retry() or rid in parked:
                    parked.setdefault(rid, []).append(buf)
                    self.delivery_retries += 1
                else:
                    accepted += 1
            self._parked = parked
            return accepted

    # -- lifecycle -----------------------------------------------------------
    def step(self) -> int:
        """One engine tick; returns requests finished this tick."""
        self.ticks += 1
        self.plane.pump()
        if self._parked:
            self._deliver([])              # retry-rejected rows go first
        self._ingest()
        self._readmit_backlog()
        before = self.completed
        g = self._build_graph()
        if g is not None:
            g.start()
            g.wait(progress=self.plane.pump, max_rounds=200_000)
        return self.completed - before

    @property
    def idle(self) -> bool:
        return (not self.active and self.backlog.empty_flag
                and not self._parked)

    def run_until_idle(self, deadline_s: float = 30.0) -> None:
        """Drain everything resident/backlogged/parked (shutdown path)."""
        import time
        deadline = time.monotonic() + deadline_s
        while not self.idle:
            self.step()
            if time.monotonic() > deadline:
                raise FatalError(
                    f"serving engine failed to drain: active="
                    f"{len(self.active)} backlog={len(self.backlog)} "
                    f"parked={sum(len(q) for q in self._parked.values())}")

    def counters(self) -> dict:
        return {"ticks": self.ticks, "arrived": self.arrived,
                "completed": self.completed,
                "tokens_generated": self.tokens_generated,
                "delivery_retries": self.delivery_retries,
                "preemptions": self.slots.preemptions,
                "admission_rejections": self.slots.rejections,
                "backlog_max_depth": self.backlog.max_depth}


def _host_rows(statuses):
    """The token rows of ``statuses`` as host buffers, in order.  Rows
    that arrived as tensors (on ``sim`` the server's rows reach the
    client where the server staged them) cross to the host together:
    one stack and one copy per device, never one copy a row."""
    bufs = [st.get_buffer() for st in statuses]
    on: Dict[torch.device, List[int]] = {}
    for i, b in enumerate(bufs):
        if isinstance(b, torch.Tensor):
            on.setdefault(b.device, []).append(i)
    for idx in on.values():
        host = torch.stack([bufs[i].reshape(-1).view(torch.uint8)
                            for i in idx]).cpu().numpy()
        for i, row in zip(idx, host):
            bufs[i] = row
    return iter(bufs)


class TokenClient(_attrs.AttrResource):
    """The client role: open-loop submission plus worker-thread drains.

    ``drain_workers`` threads pop the thread-safe result CQ; every popped
    row is timestamped (TTFT / inter-token latency) and kept per worker,
    so :meth:`collect` can assert per-worker FIFO — the LCQ pops of one
    worker must see each client's sequence numbers strictly increasing.
    """

    def __init__(self, plane: ServePlane, model, *, stamp: bool = True,
                 **overrides):
        if plane.result_cq is None:
            raise FatalError("TokenClient needs the client rank local "
                             "(plane.result_cq is remote)")
        self.plane = plane
        self.model = model
        self.tele = plane.tele
        resolved = _attrs.resolve(
            ("drain_workers",),
            runtime=getattr(plane.cluster, "_attr_layer", None),
            overrides=overrides)
        self.n_drain: int = resolved["drain_workers"]
        self.prefill_ep = plane.prefill[plane.client_rank]
        # (t_submit, prompt_len, max_new) per submitted request
        self.records: Dict[int, Tuple[float, int, int]] = {}
        self.submit_retries = 0
        self.drain = ResultDrain(plane.result_cq, self.n_drain,
                                 stamp=stamp, tele=plane.tele).start()
        self._init_attrs(resolved)
        self._export_attr("submitted", lambda: len(self.records))
        self._export_attr("drained", lambda: self.drain.drained)

    def submit(self, prompt: np.ndarray, max_new: int,
               rid: Optional[int] = None, *, t_submit: float = 0.0):
        """Post one prompt over the prefill endpoint.  Returns
        ``(rid, status)``; on retry the caller pumps and resubmits with
        the same ``rid`` (open-loop harnesses bound this)."""
        import time
        rid = next(_rid_counter) if rid is None else rid
        prompt = np.asarray(prompt, np.int32)
        with self.tele.span("serve.enqueue"):
            payload = np.concatenate(
                [np.array([rid, max_new], np.int32), prompt]).view(np.uint8)
            st = self.prefill_ep.post_am(
                self.plane.server_rank, payload, remote_comp=PROMPT_RC,
                tag=rid)
        if st.is_retry():
            self.submit_retries += 1
        elif max_new != EOT_MAX_NEW:       # control messages aren't requests
            self.records[rid] = (t_submit or time.perf_counter(),
                                 len(prompt), max_new)
        return rid, st

    def send_eot(self) -> None:
        """Process-mode shutdown: tell the server traffic has ended."""
        while True:
            _, st = self.submit(np.zeros(1, np.int32), EOT_MAX_NEW, rid=0)
            if not st.is_retry():
                return
            self.plane.pump()

    def pump(self, rounds: int = 1) -> int:
        return self.plane.pump(rounds)

    @property
    def expected_tokens(self) -> int:
        return sum(m for _, _, m in self.records.values())

    def collect(self) -> dict:
        """Stop the drain workers, verify every stream against the
        model oracle, and return the traffic report."""
        self.drain.stop()
        streams = self.drain.worker_results()
        rows = _host_rows([entry[0] if isinstance(entry, tuple) else entry
                           for chunk in streams for entry in chunk])
        per_rid: Dict[int, List[Tuple[int, int, int, float, int]]] = {}
        out_of_order = unexpected = 0
        for wid, chunk in enumerate(streams):
            last_seq: Dict[int, int] = {}
            for entry in chunk:
                st, t = entry if isinstance(entry, tuple) else (entry, 0.0)
                rid, seq, tok, is_done = decode_token_row(next(rows))
                if rid not in self.records:
                    unexpected += 1
                    continue
                # one worker's pops are FIFO: within a worker, a client's
                # seqs must be strictly increasing (stream never reorders)
                if rid in last_seq and seq <= last_seq[rid]:
                    out_of_order += 1
                last_seq[rid] = seq
                per_rid.setdefault(rid, []).append(
                    (seq, tok, is_done, t, wid))
        lost = duplicated = mismatched = bad_done = completed = 0
        ttfts: List[float] = []
        gaps: List[float] = []
        for rid, (t_sub, prompt_len, max_new) in self.records.items():
            got = sorted(per_rid.get(rid, []))
            seqs = [g[0] for g in got]
            distinct = sorted(set(seqs))
            duplicated += len(seqs) - len(distinct)
            lost += max_new - len(distinct)
            expect = self.model.expected(rid, prompt_len, max_new)
            by_seq = {g[0]: g for g in got}
            for s in distinct:
                if not 0 <= s < max_new or \
                        by_seq[s][1] != int(expect[s]):
                    mismatched += 1
            dones = [g[0] for g in got if g[2]]
            if distinct == list(range(max_new)):
                completed += 1
                if dones != [max_new - 1]:
                    bad_done += 1
                first = min((g[3] for g in got if g[0] == 0),
                            default=0.0)
                if first:
                    ttfts.append(first - t_sub)
                if max_new > 1:
                    times = [min(g[3] for g in got if g[0] == s)
                             for s in range(max_new)]
                    gaps.extend(np.diff(times).tolist())
        return {"submitted": len(self.records),
                "completed": completed, "lost": lost,
                "duplicated": duplicated, "mismatched": mismatched,
                "out_of_order": out_of_order, "bad_done": bad_done,
                "unexpected": unexpected,
                "tokens": sum(len(v) for v in per_rid.values()),
                "submit_retries": self.submit_retries,
                "ttft_s": ttfts, "gap_s": gaps}
