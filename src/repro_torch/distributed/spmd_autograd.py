"""Autograd through the collectives on the rank thread: the per-rank tape.

The reference differentiates its ``shard_map`` body with JAX's AD, which
transposes every collective in place (a ring's ``ppermute`` to the
reverse ring, ``all_gather`` to a reduce-scatter, ``psum`` to ``psum``).
In the port a rank's collectives run on an
:class:`~repro_torch.core.axis.LciAxis` that belongs to its
``spmd-rank<r>`` thread, and that thread holds the mesh's baton, which
it hands on only inside the axis' waits.  Torch's autograd engine runs
the backward nodes of CUDA tensors on one worker thread a device, shared
by every rank: a collective inside a backward node would wait there for
a peer whose own nodes queue behind it, off its rank thread and without
the baton.  So no collective of a rank's backward runs inside an
autograd node; a :class:`Tape` runs each on the rank thread instead:

* **a cut.**  In forward, a collective whose inputs require a gradient
  runs under ``no_grad`` and its output enters the graph as a fresh leaf;
  the tape records the inputs, that leaf and the collective's transpose
  (:meth:`Tape.cut`, which ``Comm``'s methods call while a tape records).
* **a segment.**  ``checkpoint(fn, *args)`` with a tape recording runs
  ``fn`` under ``no_grad``, keeps its inputs and gives its outputs as
  fresh leaves; in backward it first recomputes ``fn`` under
  ``enable_grad`` on the rank thread, with a tape of its own, so the
  recompute's collectives are cuts again (the tape's remat, in place of
  ``torch.utils.checkpoint``).
* **what a recompute leaves out.**  The reference's ``jax.checkpoint``
  recomputes only what its backward reads (JAX drops the rest of the
  segment's recompute as dead code), and it keeps the loss chunk's
  residuals instead of recomputing them.  So every collective a segment
  runs goes through :func:`run_collective`, which numbers them in call
  order.  During the segment's first run a dispatch mode
  (:class:`_Liveness`) follows each collective's output: ops that only
  move or add values (views, ``add``, ``cat``, casts, ...) pass its
  mark on to their outputs, and any other op that reads a marked value
  (a matmul, a norm, a kernel through its cost hook, the host) makes
  the collective *live*; so does a matmul collective's own transpose,
  for its inputs, and ``ag_matmul``'s, which reads the chunks its ring
  moved.  In the recompute a collective that is not live is not run:
  its output is an uninitialised tensor of its shape (its value reaches
  only the segment's outputs, whose recomputed values nothing reads),
  and its cut still records the transpose.  The tracking runs on the
  first segment of a function at given argument shapes in a tape (a
  model's first layer); the later ones whose collectives (their
  forwards' code, shapes and dtypes, in order) are the same take its
  live set untracked, and any other counts every collective live.  A
  segment made with
  ``keep=True`` (the loss chunk) keeps its collectives' outputs from the
  first run instead, and its recompute reuses them: the values the
  reference keeps as residuals.  Either way the recompute sends only
  what the reference's recompute sends.
* **the walk.**  Each entry opens a region: the autograd nodes made
  after it and before the next (autograd numbers a thread's nodes in
  creation order).  While a tape records, a torch function that reads a
  graph tensor of an older region reads a junction leaf in its stead
  (:class:`_Junctions`, one leaf a tensor and region), so each region's
  graph ends at leaves.  :meth:`Tape.backward` takes the regions from
  the newest: one ``torch.autograd.backward`` of every cotangent that
  waits at a tensor of the region, so each node runs once, on its whole
  cotangent, as in JAX's backward pass (a residual stream that feeds a
  later cut and the roots is not pushed through twice); then the
  region's junction leaves hand their gradients to their tensors, and
  the entry that opened it runs its transpose (a collective, on this
  thread) or its recompute, whose cotangents wait at its inputs.  A
  leaf (a param, or an entry's output) takes its cotangent into
  ``.grad`` directly.  The graph is kept until the walk's last push; a
  segment's recompute is freed when its push is done.

Without a recording tape, :func:`checkpoint` is ``torch.utils.
checkpoint`` (one device: no collective is in the graph) and ``Comm``
falls back to its ``autograd.Function`` s, whose backward runs the
transpose in the node (on the CPU the node runs on the calling thread;
``DistAxis`` ranks are processes).  :func:`param_leaves` gives the
params as the tape's leaves: each layer of a stacked ``(L, ...)`` param
its own leaf, every ``.grad`` a view of one zeroed buffer a param, so
no push ever builds a whole stack's gradient.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint as _torch_checkpoint
from torch.utils.weak import WeakIdKeyDictionary

_state = threading.local()


def active() -> Optional["Tape"]:
    """The tape recording on this thread, or None."""
    return getattr(_state, "tape", None)


def run_collective(fwd: Callable, inputs: Sequence[torch.Tensor], *,
                   reads: bool = False, residual: bool = False):
    """``fwd(*inputs)`` -> ``(out, residual)``, a collective's forward, as
    the segment run on this thread has it (see the module docstring):
    run, left out or kept.  ``reads``: its transpose reads the inputs'
    values; ``residual``: it reads the residual, so the collective runs
    whenever its segment is recomputed."""
    seg = getattr(_state, "segment", None)
    if seg is None:
        return fwd(*inputs)
    return seg.collective(fwd, inputs, reads, residual)


@contextmanager
def _segment(run):
    prev = getattr(_state, "segment", None)
    _state.segment = run
    try:
        yield run
    finally:
        _state.segment = prev


#: aten ops whose backward reads none of their inputs' values: they only
#: move, cast, add or sum them (``mul`` / ``div`` by a number too)
_MOVES = frozenset((
    "add", "add_", "sub", "sub_", "neg", "clone", "_to_copy", "copy",
    "copy_", "cat", "stack", "sum", "mean", "constant_pad_nd",
    "_unsafe_view", "detach", "alias", "lift_fresh"))
_SCALED = frozenset(("mul", "mul_", "div", "div_"))


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


class _Liveness(TorchDispatchMode):
    """A segment's first run: marks each storage with the collectives its
    values came from through value-moving ops, and makes the marks of
    every other op's inputs live.  A cost sink too (``kernel``: the
    kernel wrappers report each call's reads there; inside
    ``cost_paused`` a kernel's plain version is not followed)."""

    cost_sink = True

    def __init__(self, first: "_FirstRun"):
        super().__init__()
        self.first = first
        self.marks = WeakIdKeyDictionary()
        self.paused = 0

    def _marks(self, tensors) -> frozenset:
        got = frozenset()
        for t in tensors:
            got = got | self.marks.get(t.untyped_storage(), frozenset())
        return got

    def _mark(self, tensors, ks) -> None:
        for t in tensors:
            st = t.untyped_storage()
            self.marks[st] = self.marks.get(st, frozenset()) | ks

    def note(self, k: int, inputs, out, reads: bool) -> None:
        """Collective ``k`` ran on ``inputs`` (their values read when
        ``reads``), giving ``out``."""
        ks = self._marks(inputs)
        if reads:
            self.first.live |= ks
            ks = frozenset()
        self._mark([out], ks | {k})

    def kernel(self, name, flops, nbytes, launches=1, reads=()) -> None:
        self.first.live |= self._marks(reads)

    def collective(self, *args) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or not self.marks:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        ks = self._marks(ins)
        if not ks:
            return out
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        name = func._overloadpacket.__name__
        moves = (name in _MOVES or (name in _SCALED and len(ins) == 1)
                 or getattr(func, "is_view", False))
        if moves and all(o.device == ins[0].device for o in outs):
            self._mark(outs, ks)
        else:
            self.first.live |= ks
        return out


class _FirstRun:
    """A segment's first run (under ``no_grad``): its collectives' shapes
    in call order, and which are live, or (``keep``) their outputs.
    ``known``: the (calls, live set) an earlier segment of the same
    function on the same shapes found; if this run's calls are those, it
    takes that live set untracked, else every collective is live."""

    def __init__(self, keep: bool, known=None):
        self.keep = keep
        self.known = known
        self.calls: List[Tuple[Any, torch.Size, torch.dtype]] = []
        self.kept: List[Optional[torch.Tensor]] = []
        self.live = set()
        self.tracker = None if keep or known else _Liveness(self)

    @contextmanager
    def running(self):
        with _segment(self):
            if self.tracker is None:
                yield
            else:
                with self.tracker:
                    yield
        self.tracker = None
        if self.known is not None:
            calls, live = self.known
            self.live = set(live if calls == self.calls
                            else range(len(self.calls)))

    def collective(self, fwd, inputs, reads, residual):
        k = len(self.calls)
        if self.tracker is not None:
            self.tracker.paused += 1
        try:
            out, res = fwd(*inputs)
        finally:
            if self.tracker is not None:
                self.tracker.paused -= 1
        self.calls.append((getattr(fwd, "__code__", None), out.shape,
                           out.dtype))
        if residual:
            self.live.add(k)
        if self.keep:
            self.kept.append(None if residual else out)
        elif self.tracker is not None:
            self.tracker.note(k, inputs, out, reads)
        return out, res


class _Replay:
    """A segment's recompute: collective ``k`` runs only if its first run
    found it live (or it reads its residual), else is left out or
    reused."""

    def __init__(self, first: _FirstRun):
        self.first = first
        self.n = 0

    def collective(self, fwd, inputs, reads, residual):
        k, first = self.n, self.first
        self.n += 1
        _, shape, dtype = first.calls[k]
        if first.keep and not residual:
            return first.kept[k].detach(), None
        if k not in first.live:
            return torch.empty(shape, dtype=dtype,
                               device=inputs[0].device), None
        out, res = fwd(*inputs)
        assert (out.shape, out.dtype) == (shape, dtype), (k, out.shape)
        return out, res


class _Entry:
    """One step of the tape: ``inputs`` (graph tensors that take its
    cotangents), ``outputs`` (its leaves), ``backward`` (the outputs'
    gradients -> the inputs') and ``boundary``: autograd's node number
    when it was made, so the nodes of its region (made after it, before
    the next) are those numbered above it.  A junction (``backward``
    None) is a leaf standing, in one region, for a tensor of an older
    one: its gradient is its input's cotangent."""

    __slots__ = ("inputs", "outputs", "backward", "boundary")

    def __init__(self, inputs, outputs, backward, boundary):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.backward = backward
        self.boundary = boundary


_SEQ_PROBE = torch.zeros((), requires_grad=True)


def _node_count() -> int:
    """A number above that of every autograd node made on this thread so
    far, and below that of every node made later."""
    with torch.enable_grad():
        return _SEQ_PROBE.view_as(_SEQ_PROBE).grad_fn._sequence_nr()


def _seq(t: torch.Tensor) -> int:
    return t.grad_fn._sequence_nr() if t.grad_fn is not None else -1


class _Pending:
    """The cotangents that wait at graph tensors, summed a tensor."""

    def __init__(self):
        self.at: Dict[int, list] = {}

    def add(self, tensors, grads) -> None:
        for t, g in zip(tensors, grads):
            if g is None or not t.requires_grad:
                continue
            g = g.to(t.dtype)
            if t.grad_fn is None:           # a leaf: into ``.grad``
                if t.grad is None:
                    t.grad = g
                else:
                    t.grad.add_(g)      # in place: a view stays one
                continue
            got = self.at.get(id(t))
            if got is None:
                self.at[id(t)] = [t, g]
            else:
                got[1] = got[1] + g

    def push(self, above: int, *, retain: bool) -> None:
        """Push every waiting cotangent of a tensor made after node
        ``above`` through the graph, in one ``torch.autograd.backward``."""
        ready = [k for k, (t, _) in self.at.items() if _seq(t) > above]
        if not ready:
            return
        pairs = [self.at.pop(k) for k in ready]
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs],
                                retain_graph=retain)


class _Junctions(TorchFunctionMode):
    """While a tape records: every torch function (and every kernel
    wrapper's ``autograd.Function``, applied through
    :func:`repro_torch.kernels.apply`) reading a graph tensor made
    before the tape's newest entry reads a junction leaf instead, one a
    tensor and region, so the graph of a region ends at its leaves (an
    in-place op keeps its own first argument).  Off while a segment's
    first run records no graph."""

    def __init__(self, tape: "Tape"):
        super().__init__()
        self.tape = tape

    def _sub(self, a):
        if isinstance(a, torch.Tensor):
            return self.tape.junction(a)
        if isinstance(a, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in a):
            return type(a)(self._sub(x) for x in a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (self.tape.entries and torch.is_grad_enabled()
                and name != "__get__"):
            inplace = name.endswith("_") and not name.endswith("__")
            args = tuple(a if inplace and i == 0 else self._sub(a)
                         for i, a in enumerate(args))
            kwargs = {k: self._sub(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class Tape:
    """One rank's record of its collectives and remat segments, in
    creation order (see the module docstring)."""

    def __init__(self):
        self.entries: List[_Entry] = []
        self._joined: Dict[int, torch.Tensor] = {}
        #: (segment function, argument shapes) -> (its collectives, the
        #: live ones) of the first such segment (a model's layers)
        self._known: Dict[Any, Tuple[list, frozenset]] = {}
        self._mode: Optional[_Junctions] = None

    @contextmanager
    def recording(self):
        """Make this the thread's recording tape inside the block."""
        prev = active()
        _state.tape = self
        self._mode = _Junctions(self)
        try:
            with self._mode:
                yield self
        finally:
            _state.tape = prev
            self._mode = None

    @contextmanager
    def _no_junctions(self):
        """The junction mode off (a segment's first run: no graph)."""
        mode = self._mode
        if mode is None:
            yield
            return
        mode.__exit__(None, None, None)
        try:
            yield
        finally:
            mode.__enter__()

    def junction(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, or where it is a graph tensor of an older region than
        the newest entry's, its junction leaf in this region."""
        node = t.grad_fn
        if node is None or node._sequence_nr() > self.entries[-1].boundary:
            return t
        leaf = self._joined.get(id(t))
        if leaf is None:
            leaf = t.detach().requires_grad_()
            self._joined[id(t)] = leaf
            self.entries.append(_Entry([t], [leaf], None,
                                       self.entries[-1].boundary))
        return leaf

    def cut(self, fwd: Callable, transpose: Callable,
            inputs: Sequence[torch.Tensor], *, reads: bool = False,
            residual: bool = False) -> torch.Tensor:
        """``fwd(*inputs)`` -> ``(out, res)`` (a collective, through
        :func:`run_collective`) under ``no_grad``, its output a fresh
        leaf; ``transpose(inputs, g, res)`` (detached inputs, the
        output's cotangent) gives each input's cotangent in backward."""
        det = [x.detach() for x in inputs]
        with torch.no_grad():
            out, res = run_collective(fwd, det, reads=reads,
                                      residual=residual)
        leaf = out.detach().requires_grad_()
        self._append(inputs, [leaf], lambda gs: transpose(det, gs[0], res))
        return leaf

    def checkpoint(self, fn: Callable, *args, keep: bool = False):
        """``fn(*args)`` as a remat segment: run under ``no_grad`` now,
        recomputed under ``enable_grad`` on this thread in backward, with
        only its live collectives (``keep``: none, their first outputs
        reused)."""
        flat, spec = tree_flatten(args)
        kind = (getattr(fn, "__code__", fn), tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else type(a) for a in flat))
        first = _FirstRun(keep, None if keep else self._known.get(kind))
        with torch.no_grad(), self._no_junctions(), first.running():
            out = fn(*args)
        if not keep and kind not in self._known:
            self._known[kind] = (list(first.calls), frozenset(first.live))
        oflat, ospec = tree_flatten(out)
        oflat = [o.detach().requires_grad_() if _is_float(o) else o
                 for o in oflat]
        outs = [i for i, o in enumerate(oflat) if _is_float(o)]
        # leaves (params, earlier cuts' and segments' outputs) are used
        # as they are and take their gradients directly; a graph tensor
        # gets a detached copy whose gradient is pushed back
        needs = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)
                 and a.requires_grad and a.grad_fn is not None]

        def backward(gs):
            flat2 = list(flat)
            for i in needs:
                flat2[i] = flat[i].detach().requires_grad_()
            inner = Tape()
            replay = _Replay(first)
            with torch.enable_grad(), inner.recording(), _segment(replay):
                out2 = fn(*tree_unflatten(flat2, spec))
            assert replay.n == len(first.calls), (replay.n, len(first.calls))
            o2 = tree_flatten(out2)[0]
            roots = [(o2[i], g) for i, g in zip(outs, gs)
                     if o2[i].requires_grad]
            inner.backward([r for r, _ in roots], [g for _, g in roots])
            return [flat2[i].grad for i in needs]

        self._append([flat[i] for i in needs], [oflat[i] for i in outs],
                     backward)
        return tree_unflatten(oflat, ospec)

    def backward(self, roots: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> None:
        """Push ``grads`` from ``roots``, then walk the regions from the
        newest, each on this thread (the tape empties): one push of all
        the cotangents waiting in the region (its nodes run once, on
        their whole cotangents), then its junctions' gradients wait at
        their tensors, and the entry that opened it runs its backward."""
        pending = _Pending()
        pending.add(roots, grads)
        joined = []
        while self.entries:
            e = self.entries.pop()
            if e.backward is None:
                joined.append(e)
                continue
            pending.push(e.boundary, retain=True)
            for j in joined:
                pending.add(j.inputs, [j.outputs[0].grad])
            joined = []
            gs = [o.grad if o.grad is not None else torch.zeros_like(o)
                  for o in e.outputs]
            e.outputs = []
            pending.add(e.inputs, e.backward(gs))
        pending.push(-1, retain=False)

    def _append(self, inputs, outputs, backward) -> None:
        self.entries.append(_Entry(inputs, outputs, backward,
                                   _node_count()))
        self._joined = {}


def checkpoint(fn: Callable, *args, keep: bool = False):
    """``fn(*args)`` rematerialized in backward: a tape segment while a
    tape records on this thread (``keep``: its collectives' outputs kept,
    not recomputed), else ``torch.utils.checkpoint``."""
    tape = active()
    if tape is not None:
        return tape.checkpoint(fn, *args, keep=keep)
    return _torch_checkpoint(fn, *args, use_reentrant=False)


def _leaf(p: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    t = p.detach().requires_grad_()
    t.grad = grad
    return t


def param_leaves(params: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                  Dict[str, Any]]:
    """(tracked, grads): the params as the tape's leaves, and a tree like
    ``params`` of zeroed buffers that their gradients accumulate into.  A
    layer stack (a dict of stacked ``(L, ...)`` params: ``layers``,
    ``encoder``, ``cross_layers``) becomes a list of L per-layer dicts,
    as ``models/lm.py::_unbind`` gives them, each leaf's ``.grad`` a view
    of its layer in the stacked buffer."""
    tracked: Dict[str, Any] = {}
    grads: Dict[str, Any] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            g = {n: torch.zeros_like(t) for n, t in v.items()}
            n_layers = len(next(iter(v.values()))) if v else 0
            tracked[k] = [{n: _leaf(t[i], g[n][i]) for n, t in v.items()}
                          for i in range(n_layers)]
            grads[k] = g
        else:
            grads[k] = torch.zeros_like(v)
            tracked[k] = _leaf(v, grads[k])
    return tracked, grads


def loss_and_grads(loss_fn: Callable, params: Dict[str, Any]):
    """(loss, metrics, grads) of ``loss_fn(tracked) -> (loss, metrics)``
    with every collective and recompute of the backward on this thread."""
    tracked, grads = param_leaves(params)
    tape = Tape()
    with tape.recording():
        loss, metrics = loss_fn(tracked)
    tape.backward([loss], [torch.ones_like(loss)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads
