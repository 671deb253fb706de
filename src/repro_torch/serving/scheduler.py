"""Serving scheduler — continuous batching on LCI admission semantics.

The mirror of :mod:`repro.serving.scheduler` on the port's host runtime.

Requests are *posted* to the engine; the scheduler returns the paper's
ternary status to the client: ``done`` (finished, payload = generated
ids), ``posted`` (admitted, completion object will be signaled), or
``retry`` (KV pages exhausted — the request goes to the **backlog queue**
and is re-admitted as pages free up).  Completion objects are real LCI
objects: pass a CompletionQueue to poll finished requests, or a handler
for push delivery.

With a :class:`ServeTransport`, request/response traffic actually rides
the host runtime: prompts (large, bursty) are posted on a **prefill
endpoint** striped by size class, generated tokens (tiny,
latency-sensitive) on a separate narrow **decode endpoint** — so decode
results never queue behind a bulk prompt on the same device stream (the
paper's size-class-isolation "new possibilities" scenario, §3.2.3).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.backlog import BacklogQueue
from ..core.completion import CompletionObject, CompletionQueue
from ..core.concurrency import ThreadSafeCompletionQueue
from ..core.concurrency import drain as drain_cq
from ..core.matching import HostMatchingEngine, MatchKind
from ..core.runtime import LocalCluster
from ..core.status import ErrorCode, FatalError, Status, done, posted, retry
from .kv_cache import PagedKVAllocator

_req_ids = itertools.count()


class ServeTransport:
    """Client<->server request plumbing over striped endpoints.

    One :class:`~repro_torch.core.runtime.LocalCluster` rank is the client, one
    the server.  Two symmetric endpoint bundles are allocated cluster-wide
    (device streams match by index, so every rank replicates the shape):

    * ``prefill`` — ``n_prefill`` devices, ``by_size`` stripe: prompt
      payloads sort into size classes, so a short prompt is never stuck
      behind a long one on the same stream.
    * ``decode``  — ``n_decode`` device(s), round-robin: the token-return
      path, isolated from all prompt traffic.
    """

    def __init__(self, cluster: LocalCluster, *, client_rank: int = 0,
                 server_rank: int = 1, n_prefill: int = 2,
                 n_decode: int = 1):
        self.cluster = cluster
        self.client_rank = client_rank
        self.server_rank = server_rank
        self.prefill = cluster.alloc_endpoint(
            n_devices=n_prefill, stripe="by_size", progress="dedicated",
            name="prefill")
        self.decode = cluster.alloc_endpoint(
            n_devices=n_decode, stripe="round_robin", name="decode")
        server = cluster[server_rank]
        client = cluster[client_rank]
        self.prompt_cq = server.alloc_cq()
        self._prompt_rc = server.register_rcomp(self.prompt_cq)
        self.result_cq = client.alloc_cq()
        self._result_rc = client.register_rcomp(self.result_cq)

    # -- client side ---------------------------------------------------------
    def send_prompt(self, rid: int, prompt: np.ndarray) -> Status:
        """Post the prompt to the server over the prefill endpoint."""
        payload = np.ascontiguousarray(prompt, np.int32).view(np.uint8)
        return self.prefill[self.client_rank].post_am(
            self.server_rank, payload, remote_comp=self._prompt_rc, tag=rid,
            allow_retry=False)

    def poll_results(self) -> List[Tuple[int, np.ndarray]]:
        """Drain finished (rid, generated tokens) pairs at the client."""
        out = []
        while True:
            st = self.result_cq.pop()
            if st.is_retry():
                return out
            out.append((st.tag, np.asarray(st.get_buffer())
                        .view(np.int32).copy()))

    # -- server side ---------------------------------------------------------
    def recv_prompts(self) -> List[Tuple[int, np.ndarray]]:
        """Drain (rid, prompt) pairs that arrived over the wire."""
        out = []
        while True:
            st = self.prompt_cq.pop()
            if st.is_retry():
                return out
            out.append((st.tag, np.asarray(st.get_buffer())
                        .view(np.int32).copy()))

    def send_result(self, rid: int, tokens: np.ndarray) -> Status:
        """Return generated ids over the decode endpoint (small messages —
        they stripe onto the isolated decode devices)."""
        payload = np.ascontiguousarray(tokens, np.int32).view(np.uint8)
        return self.decode[self.server_rank].post_am(
            self.client_rank, payload, remote_comp=self._result_rc, tag=rid,
            allow_retry=False)

    def send_results(self, batch: List[Tuple[int, np.ndarray]]
                     ) -> List[Status]:
        """Burst-post a step's finished results in one ``post_am_many``
        doorbell: one staged copy + one push per device instead of a
        host-synchronous scalar post per request.  Per-status ternary
        results come back positionally — ``retry`` entries are the
        caller's to park (see ``ServeScheduler._flush_results``)."""
        bufs = [np.ascontiguousarray(tokens, np.int32).view(np.uint8)
                for _, tokens in batch]
        return self.decode[self.server_rank].post_am_many(
            self.client_rank, bufs, self._result_rc,
            tags=[rid for rid, _ in batch])

    def pump(self, rounds: int = 4) -> int:
        """Drive progress on both sides' endpoint devices."""
        n = 0
        for eps in (self.prefill, self.decode):
            for ep in eps:
                n += ep.progress(rounds)
        return n

    def counters(self) -> dict:
        return {
            "prefill": [ep.counters() for ep in self.prefill],
            "decode": [ep.counters() for ep in self.decode],
        }

    @property
    def attrs(self) -> dict:
        """Queryable endpoint attributes per side (unified get_attr
        surface, DESIGN.md §12): what the transport actually runs with."""
        return {
            "prefill": self.prefill[0].attrs,
            "decode": self.decode[0].attrs,
        }


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (len,) int32
    max_new: int
    comp: Optional[CompletionObject]
    generated: List[int] = dataclasses.field(default_factory=list)
    position: int = 0
    remote: bool = False                  # arrived over the ServeTransport


class ServeScheduler:
    """Continuous batching: admit -> decode rounds -> complete.

    ``decode_fn(tokens (b,), positions (b,)) -> next tokens (b,)`` is the
    device-side step (the engine's serve_step bound to params/cache); the
    scheduler owns admission, the backlog, and completion delivery.  The
    matching engine routes finished requests back to per-client queues
    (client id = rank, request id = tag — exactly the send/recv pattern).
    """

    def __init__(self, decode_fn: Callable, *, max_batch: int,
                 allocator: PagedKVAllocator, eos_id: int = -1,
                 transport: Optional[ServeTransport] = None):
        self.decode_fn = decode_fn
        self.max_batch = max_batch
        self.alloc = allocator
        self.eos_id = eos_id
        self.transport = transport
        self.active: Dict[int, Request] = {}
        self.backlog = BacklogQueue()
        self.router = HostMatchingEngine()
        # completions rejected with retry (bounded client CQ full) —
        # redelivered each step, mirroring the progress-engine backlog
        self._pending_signals: collections.deque = collections.deque()
        # remote results finished this step, flushed as ONE post_am_many
        # burst; retry-rejected sends park here per client, in order
        self._outbox: List[Tuple[int, np.ndarray]] = []
        self._pending_sends: collections.deque = collections.deque()
        self.completed = 0
        self.retries = 0

    def alloc_cq(self, capacity: Optional[int] = None, *,
                 threadsafe: bool = False) -> CompletionObject:
        """Allocate a result queue through the unified comp API: routed to
        the transport's client runtime when one exists (so remote results
        and local completions share one allocation surface).
        ``threadsafe=True`` returns the LCQ-backed queue — required when
        results are drained by :meth:`start_result_drain` workers."""
        if self.transport is not None:
            client = self.transport.cluster[self.transport.client_rank]
            return client.alloc_cq(capacity, threadsafe=threadsafe)
        if threadsafe:
            return ThreadSafeCompletionQueue(capacity)
        return CompletionQueue(capacity)

    def start_result_drain(self, cq: CompletionObject,
                           n_workers: int = 2) -> "ResultDrain":
        """Drain a client CQ from ``n_workers`` threads while the caller
        keeps stepping the engine — the multithreaded-client pattern the
        concurrency subsystem exists for.  ``cq`` must be thread-safe
        (``alloc_cq(threadsafe=True)``)."""
        if isinstance(cq, CompletionQueue):
            raise FatalError("start_result_drain needs a thread-safe CQ: "
                             "alloc_cq(threadsafe=True)")
        return ResultDrain(cq, n_workers).start()

    # -- client API ----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int,
               comp: Optional[CompletionObject] = None,
               allow_retry: bool = True) -> Status:
        rid = next(_req_ids)
        req = Request(rid, np.asarray(prompt, np.int32), max_new, comp)
        st = self._admit(req)
        if st.is_retry():
            self.retries += 1
            if allow_retry:
                return st
            self.backlog.push(req)
            return posted(code=ErrorCode.POSTED_BACKLOG, ctx=rid)
        return posted(ctx=rid)

    def _admit(self, req: Request) -> Status:
        if len(self.active) >= self.max_batch:
            return retry(ErrorCode.RETRY_NOSLOT)
        st = self.alloc.admit(req.rid, len(req.prompt) + req.max_new)
        if st.is_retry():
            return st
        req.position = len(req.prompt)
        self.active[req.rid] = req
        return done()

    def submit_remote(self, prompt: np.ndarray, max_new: int) -> int:
        """Client-side submit: the prompt rides the prefill endpoint to the
        server; results come back via ``transport.poll_results()``."""
        if self.transport is None:
            raise ValueError("submit_remote needs a ServeTransport")
        rid = next(_req_ids)
        payload = np.concatenate([np.array([max_new], np.int32),
                                  np.asarray(prompt, np.int32)])
        self.transport.send_prompt(rid, payload)
        return rid

    def _ingest_transport(self) -> None:
        """Server side: admit prompts that arrived over the wire."""
        self.transport.pump()
        for rid, data in self.transport.recv_prompts():
            req = Request(rid, data[1:], int(data[0]), comp=None,
                          remote=True)
            if self._admit(req).is_retry():
                self.retries += 1
                self.backlog.push(req)

    # -- engine progress -----------------------------------------------------
    def step(self) -> int:
        """One decode round over the active set; returns #finished."""
        if self.transport is not None:
            self._ingest_transport()
        # redeliver completions a full client CQ rejected earlier — one
        # full CQ must not block other clients' results, and a client's
        # own results must stay in order (once one of its signals is
        # rejected, its later ones wait behind it)
        rejected, blocked = [], set()
        for _ in range(len(self._pending_signals)):
            comp, st = self._pending_signals.popleft()
            if id(comp) in blocked or self._signal_rejected(comp, st):
                rejected.append((comp, st))
                blocked.add(id(comp))
        self._pending_signals.extendleft(reversed(rejected))
        # (3) drain the backlog first, exactly like the progress engine
        while not self.backlog.empty_flag and len(self.active) < \
                self.max_batch:
            req, st = self.backlog.pop()
            if st.is_retry():
                break
            if self._admit(req).is_retry():
                self.backlog.push(req)
                break

        if not self.active:
            self._flush_results()      # parked sends still redeliver
            return 0
        reqs = list(self.active.values())
        tokens = np.array([r.prompt[-1] if not r.generated
                           else r.generated[-1] for r in reqs], np.int32)
        positions = np.array([r.position for r in reqs], np.int32)
        nxt = np.asarray(self.decode_fn(tokens, positions))

        finished = 0
        for r, t in zip(reqs, nxt):
            r.generated.append(int(t))
            r.position += 1
            if len(r.generated) >= r.max_new or int(t) == self.eos_id:
                self._complete(r)
                finished += 1
        self._flush_results()
        return finished

    def _flush_results(self) -> int:
        """Send parked + newly finished remote results as one burst.

        Parked results go first (a client's stream stays in order); the
        burst rides the single decode stream with prefix-accept, so a
        ``retry`` for one client re-parks that client's later results
        behind it while other clients' results still land."""
        if self.transport is None or not (self._outbox
                                          or self._pending_sends):
            return 0
        batch = list(self._pending_sends) + self._outbox
        self._pending_sends.clear()
        self._outbox = []
        sts = self.transport.send_results(batch)
        blocked, accepted = set(), 0
        for (rid, tokens), st in zip(batch, sts):
            if st.is_retry() or rid in blocked:
                self._pending_sends.append((rid, tokens))
                blocked.add(rid)
            else:
                accepted += 1
        self.transport.pump()
        return accepted

    def _complete(self, req: Request) -> None:
        del self.active[req.rid]
        self.alloc.release(req.rid)
        if req.remote:
            self._outbox.append((req.rid,
                                 np.array(req.generated, np.int32)))
            self.completed += 1
            return
        st = done(np.array(req.generated, np.int32), tag=req.rid)
        if req.comp is not None:
            # park behind any already-parked result for the same comp (a
            # direct delivery would overtake it and break per-client
            # ordering), or when the comp rejects the signal (CQ full)
            queued = any(c is req.comp for c, _ in self._pending_signals)
            if queued or self._signal_rejected(req.comp, st):
                self._pending_signals.append((req.comp, st))  # never drop
        else:
            self.router.insert(req.rid, MatchKind.SEND, st)
        self.completed += 1

    @staticmethod
    def _signal_rejected(comp, st: Status) -> bool:
        result = comp.signal(st)
        return isinstance(result, Status) and result.is_retry()

    def poll(self, rid: int) -> Status:
        """Pull-style completion for clients without a completion object."""
        match = self.router.insert(rid, MatchKind.RECV, None)
        if match is None:
            return retry()
        return match


class ResultDrain:
    """Worker threads concurrently popping finished results off one CQ.

    Each worker collects into its own list (no shared mutable state on
    the hot path); ``stop()`` joins the workers, performs one final drain
    so nothing signaled between the stop flag and the join is stranded,
    and returns every collected status.  The LCQ backend guarantees no
    result is lost or double-delivered across the workers — asserted by
    the threaded stress tests.

    With ``stamp=True`` every entry is ``(status, perf_counter())`` —
    receive timestamps for TTFT / inter-token latency — and
    :meth:`worker_results` exposes the per-worker streams so callers can
    assert per-worker FIFO (one worker's pops of a client's stream must
    see strictly increasing sequence numbers).
    """

    def __init__(self, cq: CompletionObject, n_workers: int = 2, *,
                 stamp: bool = False, tele=None):
        if n_workers < 1:
            raise FatalError("result drain needs n_workers >= 1")
        self.cq = cq
        self.n_workers = n_workers
        self.stamp = stamp
        self._tele = tele
        self._threads: List[threading.Thread] = []
        self._stopping = False
        # one list per worker + one for stop()'s final sweep
        self._collected: List[list] = [[] for _ in range(n_workers + 1)]

    def start(self) -> "ResultDrain":
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._run, args=(w,), daemon=True,
                             name=f"result-drain/{w}")
            for w in range(self.n_workers)
        ]
        for t in self._threads:
            t.start()
        return self

    def _run(self, wid: int) -> None:
        out = self._collected[wid]
        span = self._tele.span if self._tele is not None else None
        delay = 1e-5
        while not self._stopping:
            st = self.cq.pop()
            if st.is_retry():
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
            else:
                if span is not None:
                    with span("serve.drain"):
                        out.append((st, time.perf_counter())
                                   if self.stamp else st)
                else:
                    out.append((st, time.perf_counter())
                               if self.stamp else st)
                delay = 1e-5

    @property
    def drained(self) -> int:
        return sum(len(c) for c in self._collected)

    def worker_results(self) -> List[list]:
        """Per-worker collected entries (the last list is ``stop()``'s
        final sweep, popped single-threaded after the join)."""
        return [list(c) for c in self._collected]

    def stop(self, timeout: float = 10.0) -> List[Status]:
        """Join workers (deadlock fails fast) and return all results."""
        self._stopping = True
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                raise FatalError(f"result-drain worker stuck: {t.name}")
        self._threads = []
        final = drain_cq(self.cq)          # final sweep: nothing stranded
        now = time.perf_counter()
        self._collected[-1].extend((st, now) if self.stamp else st
                                   for st in final)
        return [entry[0] if self.stamp else entry
                for chunk in self._collected for entry in chunk]
