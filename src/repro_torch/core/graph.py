"""Completion graph (paper §3.2.5) — DAGs of comm/compute with partial order.

Paper: "Graph is a more advanced completion object type similar to CUDA
Graph that allows users to specify a set of communication operations or
user-provided functions with a partial execution order. If operation u
precedes operation v in that order, then v will be started only after u
completes. ... Every node in the completion graph uses an atomic counter to
track the number of received signals. Every ready node will be immediately
fired, and a completed node will signal all its descendants."

The graph is a true completion object (:class:`~.completion.CompletionObject`):

* **function nodes** run a host callable inline when ready;
* **communication nodes** hold a *deferred* operation — an unfired OFF
  builder (``post_send_x(...)`` etc., see :mod:`repro_torch.core.off`).  When the
  node becomes ready the graph *posts* the op; the progress engine signals
  the node on completion, and descendants fire as signals arrive.  This is
  the paper's headline graph feature: comm ops as nodes, completed
  asynchronously, never fired host-side.
* **signal nodes** complete when ``graph.signal(status)`` is delivered from
  outside — this is how the graph itself serves as the completion object of
  an external operation.

Lifecycle: ``alloc_graph`` → build (``add_node``/``add_comm``/``add_edge``)
→ ``start()`` (posts ready comm nodes, runs ready fn nodes) → drive
progress → ``test()``/``wait()``.  The old synchronous ``execute()`` is
kept as a thin shim over start+drain and behaves identically for pure
host-function graphs.

The same executor also drives the async checkpoint commit pipeline
(``checkpoint/store.py``) and the 1F1B pipeline-parallel schedule
(``distributed/pipeline.py``).

Execution keeps the paper's *counter* semantics observable: each node holds
a signal counter; nodes fire from a ready set (counter == indegree), never
by naive list order, and ``fire_order`` records the *completion* sequence
for tests to assert the partial order.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from .completion import CompletionObject, _as_progress_fn
from .off import OffBuilder
from .status import ErrorCode, FatalError, Status, done

_FN, _COMM, _SIGNAL = "fn", "comm", "signal"


@dataclasses.dataclass
class _Node:
    nid: int
    fn: Any                  # callable (fn), OffBuilder (comm), None (signal)
    deps: tuple
    name: str
    kind: str = _FN
    # paper: "every node ... uses an atomic counter to track the number of
    # received signals"
    signals: int = 0
    fired: bool = False      # started (posted, for comm nodes)
    completed: bool = False
    value: Any = None


class _GraphNodeComp(CompletionObject):
    """Per-node completion proxy handed to a comm node's posting op."""

    def __init__(self, graph: "CompletionGraph", nid: int):
        self.graph = graph
        self.nid = nid

    def signal(self, status: Status) -> Status:
        self.graph._on_comm_complete(self.nid, status)
        return done()

    def test(self):
        node = self.graph._nodes[self.nid]
        return node.completed, node.value


class CompletionGraph(CompletionObject):
    """A DAG of host callables and deferred comm ops; a completion object."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self._nodes: List[_Node] = []
        self._succs: Dict[int, List[int]] = {}
        self.fire_order: List[int] = []
        self._started = False
        self._n_done = 0
        self._inflight = 0                    # comm ops posted, not signaled
        self._ready: collections.deque = collections.deque()
        self._parked: collections.deque = collections.deque()  # comm retries
        self._ext_signals: collections.deque = collections.deque()
        self._progress_sources: list = []
        # read-only discovered attrs (the unified get_attr surface)
        self._export_attr("n_nodes", lambda: len(self._nodes))
        self._export_attr("n_comm_nodes", lambda: sum(
            1 for n in self._nodes if n.kind != _FN))
        self._export_attr("started", lambda: self._started)
        self._export_attr("n_done", lambda: self._n_done)

    # -- construction -------------------------------------------------------
    def _insert(self, fn, deps: Sequence[int], name: Optional[str],
                kind: str) -> int:
        nid = len(self._nodes)
        for d in deps:
            if d >= nid or d < 0:
                raise FatalError(f"graph node {nid}: bad dep {d}")
            self._succs.setdefault(d, []).append(nid)
        self._nodes.append(_Node(nid, fn, tuple(deps),
                                 name or f"{kind}{nid}", kind=kind))
        return nid

    def add_node(self, fn, deps: Sequence[int] = (),
                 name: Optional[str] = None) -> int:
        """Add a node. A callable receives the *values* of its deps, in
        order; an unfired OFF builder becomes a communication node."""
        if isinstance(fn, OffBuilder):
            return self.add_comm(fn, deps, name)
        return self._insert(fn, deps, name or f"n{len(self._nodes)}", _FN)

    def add_comm(self, op: OffBuilder, deps: Sequence[int] = (),
                 name: Optional[str] = None) -> int:
        """Add a *communication* node: an unfired OFF builder (e.g.
        ``post_send_x(rt, 1, buf, 8, tag).endpoint(ep)``).  The graph posts
        it when the node becomes ready and completes the node when the
        progress engine signals the operation's local completion."""
        if not isinstance(op, OffBuilder):
            raise FatalError(f"add_comm needs an unfired OFF builder, got "
                             f"{type(op).__name__} (use add_node for "
                             f"host callables)")
        if op.get("local_comp") is not None:
            raise FatalError("comm node op must leave local_comp unset — "
                             "the graph owns the node's completion")
        nid = self._insert(op, deps, name, _COMM)
        op.set("local_comp", _GraphNodeComp(self, nid))
        # the graph is the retry mechanism for its nodes: retries come back
        # as values and the node is re-posted from _parked.  allow_retry
        # False would instead park the op in the engine backlog, where a
        # backlogged *inject* completes without ever signaling local_comp
        # (paper §3.2.5) — the node would never finish.
        try:
            op.set("allow_retry", True)
        except TypeError:             # op without the option: nothing to fix
            pass
        self._note_progress_source(op)
        return nid

    def add_signal_node(self, deps: Sequence[int] = (),
                        name: Optional[str] = None) -> int:
        """Add a node completed by an external ``graph.signal(status)`` —
        how the graph serves as the completion object of ops outside it."""
        return self._insert(None, deps, name, _SIGNAL)

    def add_edge(self, u: int, v: int) -> None:
        """Impose ordering u -> v without value flow.

        Validated at insertion (paper: fatal errors raise): self-edges,
        duplicate edges, and backward edges (``u >= v`` — node ids are
        topologically ordered, so such an edge can only create a cycle)
        are all rejected here instead of surfacing as a cycle error deep
        inside execution.
        """
        n = len(self._nodes)
        if not (0 <= u < n and 0 <= v < n):
            raise FatalError(f"add_edge({u}, {v}): unknown node "
                             f"(graph has {n} nodes)")
        if u == v:
            raise FatalError(f"add_edge({u}, {u}): self-edge would deadlock "
                             "the node on its own completion")
        if u > v:
            raise FatalError(f"add_edge({u}, {v}): backward edge — node ids "
                             "are topologically ordered, so u must precede "
                             "v (this edge would create a cycle)")
        node = self._nodes[v]
        if u in node.deps:
            raise FatalError(f"add_edge({u}, {v}): duplicate edge (already "
                             "a dependency)")
        if node.fired:
            raise FatalError(f"add_edge({u}, {v}): node {v} already fired "
                             "in a running graph")
        node.deps = node.deps + (u,)
        self._succs.setdefault(u, []).append(v)

    def add_progress(self, source) -> None:
        """Register an extra progress driver for ``wait()``/``execute()``."""
        if source not in self._progress_sources:
            self._progress_sources.append(source)

    def _note_progress_source(self, op: OffBuilder) -> None:
        # post_* builders carry the runtime first; drive its whole cluster
        # so peer ranks react too (thread-mode: one address space).
        args = getattr(op, "_args", ())
        if args:
            rt = args[0]
            src = getattr(rt, "cluster", None) or \
                (rt if hasattr(rt, "progress") else None)
            if src is not None and src not in self._progress_sources:
                self._progress_sources.append(src)

    # -- the async lifecycle: start -> progress -> test/wait -----------------
    def start(self, *root_args) -> "CompletionGraph":
        """Reset state, then fire every ready node: host-fn nodes run
        inline, comm nodes are *posted* (their completion arrives through
        the progress engine).  Returns self for chaining."""
        if self._inflight:
            raise FatalError(f"graph {self.name!r} restarted with "
                             f"{self._inflight} comm nodes still in flight")
        for n in self._nodes:
            n.signals = 0
            n.fired = False
            n.completed = False
            n.value = None
        self.fire_order = []
        self._started = True
        self._n_done = 0
        self._ready.clear()
        self._parked.clear()
        # _ext_signals deliberately survives the reset: signal() may be
        # delivered (and buffered) before start() — dropping it here would
        # lose a completion that signal() already accepted with done()
        self._root_args = root_args
        for n in self._nodes:
            if not n.deps:
                self._ready.append(n.nid)
        self._pump()
        return self

    def _pump(self) -> None:
        """Fire every currently-ready node (FIFO: deterministic order)."""
        while self._ready:
            self._fire(self._ready.popleft())

    def _fire(self, nid: int) -> None:
        node = self._nodes[nid]
        if node.fired:
            raise FatalError(f"node {node.name} fired twice")
        node.fired = True
        if node.kind == _FN:
            args = (list(self._root_args) if not node.deps
                    else [self._nodes[d].value for d in node.deps])
            self._complete(nid, node.fn(*args))
        elif node.kind == _COMM:
            self._post_comm_node(nid)
        else:                                  # _SIGNAL
            if self._ext_signals:
                self._complete(nid, self._ext_signals.popleft())
            # else: stays fired-but-incomplete until graph.signal() arrives

    def _post_comm_node(self, nid: int) -> None:
        node = self._nodes[nid]
        st = node.fn()                         # fire the OFF builder
        if not isinstance(st, Status):
            raise FatalError(f"comm node {node.name} did not return a "
                             f"Status (got {type(st).__name__})")
        if st.is_done():
            # completed inline (inject / pre-matched recv): comps are NOT
            # signaled for done (paper §3.2.5) — complete the node now
            self._complete(nid, st)
        elif st.is_posted():
            if st.code == ErrorCode.POSTED_BACKLOG:
                # should be unreachable (add_comm forces allow_retry=True):
                # a backlogged inject never signals its comp
                raise FatalError(f"comm node {node.name} was parked in the "
                                 "engine backlog; post it with "
                                 "allow_retry=True so the graph can retry")
            self._inflight += 1               # progress engine will signal
        else:                                  # retry: repost on next pump
            node.fired = False
            self._parked.append(nid)

    def _complete(self, nid: int, value: Any) -> None:
        node = self._nodes[nid]
        if node.completed:
            raise FatalError(f"node {node.name} completed twice")
        node.fired = True
        node.completed = True
        node.value = value
        self._n_done += 1
        self.fire_order.append(nid)
        # completed node signals all its descendants
        for s in self._succs.get(nid, ()):
            snode = self._nodes[s]
            snode.signals += 1
            if snode.signals == len(snode.deps):
                self._ready.append(s)

    def _on_comm_complete(self, nid: int, status: Status) -> None:
        node = self._nodes[nid]
        if not self._started or not node.fired or node.completed:
            raise FatalError(f"stray completion signal for node "
                             f"{node.name} (started={self._started})")
        self._inflight -= 1
        self._complete(nid, status)
        self._pump()                           # descendants fire as signals arrive

    # -- the unified comp protocol ------------------------------------------
    def signal(self, status: Status) -> Status:
        """External delivery (graph used as another op's completion object):
        completes the oldest ready signal node, or buffers the status until
        one becomes ready."""
        if not any(n.kind == _SIGNAL for n in self._nodes):
            raise FatalError(f"graph {self.name!r} signaled but has no "
                             "signal nodes (add_signal_node)")
        for n in self._nodes:
            if n.kind == _SIGNAL and n.fired and not n.completed:
                self._complete(n.nid, status)
                self._pump()
                return done()
        self._ext_signals.append(status)
        return done()

    def test(self) -> tuple[bool, Optional[Dict[int, Any]]]:
        """Non-blocking: repost parked comm nodes, then report completion.
        Payload is the ``{nid: value}`` map once every node completed."""
        if not self._started:
            return False, None
        for _ in range(len(self._parked)):     # retry parked comm posts
            self._ready.append(self._parked.popleft())
        self._pump()
        if self._n_done == len(self._nodes):
            return True, {n.nid: n.value for n in self._nodes}
        if (self._inflight == 0 and not self._parked and not self._ready
                and not any(n.kind == _SIGNAL and n.fired and not n.completed
                            for n in self._nodes)):
            pending = [n.name for n in self._nodes if not n.completed]
            raise FatalError(f"completion graph stalled (cycle or orphan "
                             f"dependency); unfired: {pending}")
        return False, None

    def wait(self, progress=None, max_rounds: int = 100_000
             ) -> Dict[int, Any]:
        """Drive progress until every node completed; returns the values.
        With ``progress=None`` the graph drives the clusters/runtimes its
        comm nodes post on (collected at ``add_comm`` time)."""
        if progress is None and self._progress_sources:
            drivers = [_as_progress_fn(s) for s in self._progress_sources]

            def progress():                    # noqa: F811 - deliberate
                for drive in drivers:
                    drive()
        return super().wait(progress, max_rounds)

    # -- compatibility shim: the old synchronous execute ---------------------
    def execute(self, *root_args) -> Dict[int, Any]:
        """start + drain.  For pure host-function graphs this is exactly the
        old synchronous semantics; with comm nodes it drives the involved
        clusters' progress until the graph completes."""
        self.start(*root_args)
        return self.wait()

    def value(self, nid: int) -> Any:
        return self._nodes[nid].value

    def __len__(self) -> int:
        return len(self._nodes)

    # -- introspection for tests/benchmarks ----------------------------------
    def assert_partial_order(self) -> None:
        """Validate the last execution respected every edge."""
        pos = {nid: i for i, nid in enumerate(self.fire_order)}
        for n in self._nodes:
            for d in n.deps:
                if pos[d] >= pos[n.nid]:
                    raise FatalError(
                        f"partial order violated: {d} fired after {n.nid}")

    def critical_path_len(self) -> int:
        """Longest chain length — the graph's serialization lower bound."""
        depth: Dict[int, int] = {}
        for n in self._nodes:               # nodes are topologically indexed
            depth[n.nid] = 1 + max((depth[d] for d in n.deps), default=0)
        return max(depth.values(), default=0)

    def counters(self) -> dict:
        """Node-state snapshot (telemetry, benchmark evidence)."""
        kinds = collections.Counter(n.kind for n in self._nodes)
        return {
            "name": self.name,
            "nodes": len(self._nodes),
            "fn_nodes": kinds.get(_FN, 0),
            "comm_nodes": kinds.get(_COMM, 0),
            "signal_nodes": kinds.get(_SIGNAL, 0),
            "completed": self._n_done,
            "inflight": self._inflight,
            "critical_path": self.critical_path_len(),
        }
