"""Pipeline parallelism scheduled as an LCI completion graph (1F1B).

The paper's completion graph ("operations + user functions with a partial
execution order ... every ready node fires immediately") is exactly a
pipeline schedule: node (s, m, dir) = stage s processing microbatch m in
direction fwd/bwd, edges = (a) stage order within a microbatch, (b) the
1F1B resource constraint within a stage.  Building the schedule as a
:class:`repro_torch.core.graph.CompletionGraph` gives us the paper's
semantics (fire order = completion order) plus its introspection: the
critical path length of the graph IS the pipeline's bubble-inclusive step
count.

The reference's three deployments (``repro.distributed.pipeline``) are
ported:

* :func:`schedule_1f1b` — build + validate the schedule (tested against
  the analytic bubble formula);
* :func:`build_1f1b_comm_graph` — the *async* deployment: one cluster
  rank per stage, activation hand-offs as real send/recv **comm nodes**
  riding per-stage endpoints, the landing buffers uint8 tensors on the
  cluster's device (on the card, CUDA payloads: eager up to
  ``eager_max_bytes``, by rendezvous from ``rdv_threshold``).
  ``graph.start()`` posts the ready ops, the progress engine signals
  completions, and downstream stages fire as signals arrive.

* :class:`PipelinedModel` — stage-split training on the host schedule:
  the graph's fire order runs each stage's forward and backward (torch
  autograd of one stage at a time), handing activations forward and
  cotangents back explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.graph import CompletionGraph
from ..core.post import post_recv_x, post_send_x
from ..core.tree import leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class PPNode:
    stage: int
    micro: int
    is_fwd: bool


def schedule_1f1b(n_stages: int, n_micro: int
                  ) -> Tuple[CompletionGraph, Dict[PPNode, int]]:
    """Build the 1F1B dependency graph (no weights, pure schedule).

    Edges:
      fwd(s, m)  needs fwd(s-1, m)
      bwd(s, m)  needs bwd(s+1, m) and fwd(s, m)
      1F1B steady state: fwd(s, m) needs bwd(s, m - (n_stages - s))
      (limits in-flight microbatches per stage = its warmup depth)
    """
    g = CompletionGraph("1f1b")
    ids: Dict[PPNode, int] = {}

    def deps_of(node: PPNode) -> List[PPNode]:
        s, m = node.stage, node.micro
        if node.is_fwd:
            deps = []
            if s > 0:
                deps.append(PPNode(s - 1, m, True))
            lookback = m - (n_stages - s)       # 1F1B in-flight limit
            if lookback >= 0:
                deps.append(PPNode(s, lookback, False))
            return deps
        deps = [PPNode(s, m, True)]
        if s < n_stages - 1:
            deps.append(PPNode(s + 1, m, False))
        return deps

    # insert in a dependency-satisfying order (1F1B interleaves fwd/bwd,
    # so neither all-fwd-first nor per-microbatch order is topological)
    pending = [PPNode(s, m, f) for m in range(n_micro)
               for s in range(n_stages) for f in (True, False)]
    while pending:
        progressed = False
        rest = []
        for node in pending:
            deps = deps_of(node)
            if all(d in ids for d in deps):
                ids[node] = g.add_node(
                    lambda *a, n=node: n, deps=[ids[d] for d in deps],
                    name=f"{'F' if node.is_fwd else 'B'}"
                         f"{node.stage}.{node.micro}")
                progressed = True
            else:
                rest.append(node)
        if not progressed:
            raise RuntimeError("1F1B schedule has a dependency cycle")
        pending = rest
    return g, ids


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Analytic 1F1B bubble: (S-1) / (S-1+M) of the step is idle."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)


@dataclasses.dataclass
class PipelineCommGraph:
    """The async 1F1B deployment: graph + node maps + landing buffers."""

    graph: CompletionGraph
    compute_ids: Dict[PPNode, int]          # (stage, micro, dir) -> node id
    comm_ids: Dict[Tuple[str, int, int], int]   # ("SF"/"RF"/"SB"/"RB", s, m)
    act_in: Dict[Tuple[int, int], torch.Tensor]   # fwd landing at stage s+1
    grad_in: Dict[Tuple[int, int], torch.Tensor]  # bwd landing at stage s


def build_1f1b_comm_graph(cluster, n_micro: int, payload_bytes: int = 32,
                          endpoints: Optional[List] = None,
                          fwd_fn: Optional[Callable] = None,
                          bwd_fn: Optional[Callable] = None
                          ) -> PipelineCommGraph:
    """1F1B with activation hand-offs as *real comm nodes* — one cluster
    rank per stage; fwd activations and bwd grads ride the fabric.

    Node kinds per (stage s, micro m):

    * ``CF``/``CB`` — compute (fn nodes, on the cluster's device);
      ``fwd_fn(x, s, m)`` maps the incoming activation's bytes (an int64
      tensor) to the outgoing ones (cast back to uint8), ``bwd_fn(g, s,
      m)`` the incoming gradient's (defaults: mod-251 marker arithmetic
      so tests can assert end-to-end content).
    * ``SF``/``RF`` — send/recv of the fwd activation s → s+1 (comm nodes,
      tag ``2m``); ``SB``/``RB`` — the bwd gradient s → s-1 (tag ``2m+1``).

    Dependencies keep the paper schedule: ``CF`` needs its ``RF`` plus the
    1F1B lookback edge to ``CB(s, m-(S-s))``; ``CB`` needs ``CF`` and its
    ``RB``.  Receives are pre-posted at ``start()`` (no deps): the matching
    engine pairs them with sends whenever they arrive; *completion* still
    follows the wire, which is what the partial order asserts.

    ``endpoints`` (optional, one per rank) routes every comm node through
    that rank's striped endpoint via ``.endpoint(...)``.
    """
    n_stages = cluster.n_ranks
    if n_stages < 2:
        raise ValueError("async 1F1B needs >= 2 stages (cluster ranks)")
    fwd_fn = fwd_fn or (lambda x, s, m: (x + s + 1) % 251)
    bwd_fn = bwd_fn or (lambda g, s, m: (g * 2 + s) % 251)

    g = CompletionGraph("1f1b-comm")
    dev = cluster.device

    def buf():
        return torch.zeros(payload_bytes, dtype=torch.uint8, device=dev)
    act_in = {(s, m): buf()
              for s in range(n_stages - 1) for m in range(n_micro)}
    act_out = {(s, m): buf()
               for s in range(n_stages - 1) for m in range(n_micro)}
    grad_in = {(s, m): buf()
               for s in range(n_stages - 1) for m in range(n_micro)}
    grad_out = {(s, m): buf()
                for s in range(1, n_stages) for m in range(n_micro)}

    def _ep(rank):
        return endpoints[rank] if endpoints is not None else None

    def _comm(builder, rank):
        ep = _ep(rank)
        return builder.endpoint(ep) if ep is not None else builder

    def make_cf(s, m):
        def cf(*_deps):
            x = act_in[(s - 1, m)] if s > 0 else \
                torch.full((payload_bytes,), m % 251, dtype=torch.uint8,
                           device=dev)
            y = fwd_fn(x.to(torch.int64), s, m).to(torch.uint8)
            if s < n_stages - 1:
                act_out[(s, m)].copy_(y)
            return y
        return cf

    def make_cb(s, m):
        def cb(*_deps):
            gsrc = grad_in[(s, m)] if s < n_stages - 1 else \
                compute_vals[PPNode(s, m, True)]
            gy = bwd_fn(gsrc.to(torch.int64), s, m).to(torch.uint8)
            if s > 0:
                grad_out[(s, m)].copy_(gy)
            return gy
        return cb

    compute_vals: Dict[PPNode, torch.Tensor] = {}

    def make_record(node, fn):
        def wrapped(*deps):
            out = fn(*deps)
            compute_vals[node] = out
            return out
        return wrapped

    # descriptor -> (dep descriptors); inserted via the same worklist
    # approach as schedule_1f1b (1F1B interleaving is not insertion-ordered)
    def deps_of(kind, s, m):
        if kind in ("RF", "RB"):
            return []
        if kind == "CF":
            # RF/SF are keyed by the *sender* stage: stage s consumes the
            # landing of the s-1 -> s activation
            deps = [("RF", s - 1, m)] if s > 0 else []
            lb = m - (n_stages - s)
            if lb >= 0:
                deps.append(("CB", s, lb))
            return deps
        if kind == "SF":
            return [("CF", s, m)]
        if kind == "CB":
            deps = [("CF", s, m)]
            if s < n_stages - 1:
                deps.append(("RB", s, m))
            return deps
        return [("CB", s, m)]                           # SB

    def builder_of(kind, s, m):
        if kind == "SF":   # fwd activation s -> s+1, tag 2m
            return _comm(post_send_x(cluster[s], s + 1, act_out[(s, m)],
                                     payload_bytes, 2 * m), s)
        if kind == "RF":   # landing at s+1 for the s -> s+1 activation
            return _comm(post_recv_x(cluster[s + 1], s, act_in[(s, m)],
                                     payload_bytes, 2 * m), s + 1)
        if kind == "SB":   # bwd grad s -> s-1, tag 2m+1
            return _comm(post_send_x(cluster[s], s - 1, grad_out[(s, m)],
                                     payload_bytes, 2 * m + 1), s)
        # RB: landing at s for the s+1 -> s gradient
        return _comm(post_recv_x(cluster[s], s + 1, grad_in[(s, m)],
                                 payload_bytes, 2 * m + 1), s)

    todo = []
    for m in range(n_micro):
        for s in range(n_stages):
            todo.append(("CF", s, m))
            todo.append(("CB", s, m))
            if s < n_stages - 1:
                todo.append(("SF", s, m))
                todo.append(("RF", s, m))       # lands at s+1
                todo.append(("RB", s, m))       # lands at s
            if s > 0:
                todo.append(("SB", s, m))

    ids: Dict[Tuple[str, int, int], int] = {}
    while todo:
        progressed, rest = False, []
        for key in todo:
            kind, s, m = key
            dep_keys = deps_of(kind, s, m)
            if not all(d in ids for d in dep_keys):
                rest.append(key)
                continue
            dep_ids = [ids[d] for d in dep_keys]
            name = f"{kind}{s}.{m}"
            if kind in ("CF", "CB"):
                node = PPNode(s, m, kind == "CF")
                fn = make_record(node, make_cf(s, m) if kind == "CF"
                                 else make_cb(s, m))
                ids[key] = g.add_node(fn, deps=dep_ids, name=name)
            else:
                ids[key] = g.add_comm(builder_of(kind, s, m),
                                      deps=dep_ids, name=name)
            progressed = True
        if not progressed:
            raise RuntimeError("1F1B comm schedule has a dependency cycle")
        todo = rest

    compute_ids = {PPNode(s, m, f): ids[("CF" if f else "CB", s, m)]
                   for s in range(n_stages) for m in range(n_micro)
                   for f in (True, False)}
    comm_ids = {k: v for k, v in ids.items() if k[0] not in ("CF", "CB")}
    g.add_progress(cluster)
    return PipelineCommGraph(g, compute_ids, comm_ids, act_in, grad_in)


class PipelinedModel:
    """Stage-split training on the completion-graph schedule.

    ``stage_fns[s](params_s, x) -> y`` for forward (``params_s`` a tensor
    or a tree of dicts and lists); backward is torch autograd per stage
    with explicit activation hand-off: a forward node keeps its output
    (no graph recorded), a backward node runs its stage again under
    autograd from the kept input and pulls the cotangent that stage
    s + 1 handed back (the last stage the loss's) through it — the
    reference's ``jax.vjp`` a stage.  The graph supplies the order, this
    class the dataflow.  Single-host (semantics and tests)."""

    def __init__(self, stage_fns: List[Callable], n_micro: int):
        self.stage_fns = stage_fns
        self.n_stages = len(stage_fns)
        self.n_micro = n_micro

    def forward_backward(self, stage_params: List[Any],
                         micro_xs: List[torch.Tensor], loss_fn: Callable
                         ) -> Tuple[torch.Tensor, List[Any]]:
        """Returns (mean loss, per-stage grads summed over microbatches)."""
        graph, _ = schedule_1f1b(self.n_stages, self.n_micro)
        acts: Dict[Tuple[int, int], torch.Tensor] = {}
        dacts: Dict[Tuple[int, int], torch.Tensor] = {}
        grads = [tree_map(torch.zeros_like, sp) for sp in stage_params]
        losses = []

        graph.execute()                       # fire order with 1F1B deps
        for nid in graph.fire_order:
            node = graph.value(nid)
            s, m = node.stage, node.micro
            x = micro_xs[m] if s == 0 else acts[(s - 1, m)]
            if node.is_fwd:
                with torch.no_grad():
                    acts[(s, m)] = self.stage_fns[s](stage_params[s], x)
                continue
            tracked = tree_map(lambda p: p.detach().requires_grad_(),
                               stage_params[s])
            leaves = [p for _, p in leaves_with_paths(tracked)]
            xin = x.detach().requires_grad_(x.is_floating_point())
            with torch.enable_grad():
                y = self.stage_fns[s](tracked, xin)
                if s == self.n_stages - 1:
                    out, cot = loss_fn(y, m), None    # scalar loss
                    losses.append(out.detach())
                else:
                    out, cot = y, dacts[(s + 1, m)]
                srcs = leaves + ([xin] if xin.requires_grad else [])
                got = torch.autograd.grad(out, srcs, cot)
            for (_, acc), g in zip(leaves_with_paths(grads[s]), got):
                acc.add_(g)
            if xin.requires_grad:
                dacts[(s, m)] = got[-1]
        graph.assert_partial_order()
        return torch.stack(losses).mean(), grads
