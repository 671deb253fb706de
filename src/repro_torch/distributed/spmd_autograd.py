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
  ``torch.utils.checkpoint``).  Collective outputs are recomputed, not
  kept.
* **the walk.**  :meth:`Tape.backward` pushes the roots' cotangents
  through the graph (``torch.autograd.backward``), then takes the
  entries in reverse order of creation: each entry's output leaves hold
  their whole gradient by then (every later entry was pushed already),
  so the entry's transpose (a collective, on this thread) or its
  recompute gives its inputs' cotangents, which are pushed on.  A leaf
  input (a param, or an earlier entry's output) takes its cotangent
  into ``.grad`` directly.  The graph is kept until the walk's last push
  (an earlier entry's input may share it); a segment's recompute is
  freed when its push is done.

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
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_state = threading.local()


def active() -> Optional["Tape"]:
    """The tape recording on this thread, or None."""
    return getattr(_state, "tape", None)


class _Entry:
    """One step of the tape: ``inputs`` (graph tensors that take its
    cotangents), ``outputs`` (its leaves) and ``backward`` (the outputs'
    gradients -> the inputs')."""

    __slots__ = ("inputs", "outputs", "backward")

    def __init__(self, inputs, outputs, backward):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.backward = backward


def _push(tensors: Sequence[torch.Tensor], grads: Sequence, *,
          retain: bool) -> None:
    """Add each cotangent into its tensor: a leaf's into ``.grad`` (in
    place, so a view into a stacked buffer stays one), the graph's
    through one ``torch.autograd.backward`` (``retain``: the graph is
    kept while an entry still to be pushed may share it)."""
    roots, root_grads = [], []
    for t, g in zip(tensors, grads):
        if g is None or not t.requires_grad:
            continue
        g = g.to(t.dtype)
        if t.grad_fn is None:
            if t.grad is None:
                t.grad = g
            else:
                t.grad.add_(g)
        else:
            roots.append(t)
            root_grads.append(g)
    if roots:
        torch.autograd.backward(roots, root_grads, retain_graph=retain)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class Tape:
    """One rank's record of its collectives and remat segments, in
    creation order (see the module docstring)."""

    def __init__(self):
        self.entries: List[_Entry] = []

    @contextmanager
    def recording(self):
        """Make this the thread's recording tape inside the block."""
        prev = active()
        _state.tape = self
        try:
            yield self
        finally:
            _state.tape = prev

    def cut(self, fwd: Callable, transpose: Callable,
            inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``fwd(*inputs)`` (a collective) under ``no_grad``, its output a
        fresh leaf; ``transpose(inputs, g)`` (detached inputs, the
        output's cotangent) gives each input's cotangent in backward."""
        det = [x.detach() for x in inputs]
        with torch.no_grad():
            out = fwd(*det)
        leaf = out.detach().requires_grad_()
        self.entries.append(_Entry(inputs, [leaf],
                                   lambda gs: transpose(det, gs[0])))
        return leaf

    def checkpoint(self, fn: Callable, *args):
        """``fn(*args)`` as a remat segment: run under ``no_grad`` now,
        recomputed under ``enable_grad`` on this thread in backward."""
        flat, spec = tree_flatten(args)
        with torch.no_grad():
            out = fn(*args)
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
            with torch.enable_grad(), inner.recording():
                out2 = fn(*tree_unflatten(flat2, spec))
            o2 = tree_flatten(out2)[0]
            roots = [(o2[i], g) for i, g in zip(outs, gs)
                     if o2[i].requires_grad]
            inner.backward([r for r, _ in roots], [g for _, g in roots])
            return [flat2[i].grad for i in needs]

        self.entries.append(_Entry([flat[i] for i in needs],
                                   [oflat[i] for i in outs], backward))
        return tree_unflatten(oflat, ospec)

    def backward(self, roots: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> None:
        """Push ``grads`` from ``roots``, then walk the entries in reverse
        order of creation, each on this thread (the tape empties)."""
        _push(roots, grads, retain=bool(self.entries))
        while self.entries:
            e = self.entries.pop()
            gs = [o.grad if o.grad is not None else torch.zeros_like(o)
                  for o in e.outputs]
            e.outputs = []
            _push(e.inputs, e.backward(gs), retain=bool(self.entries))


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` rematerialized in backward: a tape segment while a
    tape records on this thread, else ``torch.utils.checkpoint``."""
    tape = active()
    if tape is not None:
        return tape.checkpoint(fn, *args)
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
