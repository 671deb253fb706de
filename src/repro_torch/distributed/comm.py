"""The ``Comm`` object — how model code talks to the LCI-X layer.

The mirror of :mod:`repro.distributed.comm`.  Model code is written in
*local view* (the shapes one rank sees), and every data movement goes
through a :class:`Comm`, the in-graph analogue of an LCI *device*.  Two
deployments of the same model code:

* **local** (``local_comm()``) — no mesh axes; every collective is the
  local computation (the identity, or ``x @ w``).  Single-card runs.
* **multi-rank** — the axes are bound :class:`~repro_torch.core.axis.Axis`
  objects (the reference binds axis names inside ``shard_map``); the
  collectives run the ring schedules of :mod:`repro_torch.core.collectives`
  in the mode ``CommConfig`` picks.  :func:`repro_torch.distributed.
  spmd_map.spmd_map` builds one such Comm per rank.

Every collective whose input requires a gradient is differentiable, with
the transpose that JAX's AD derives for the reference's ``Comm`` method
under ``shard_map(check_vma=False)`` (the ``_*_t`` functions below):

=================  ==========================  ===========================
method             forward                     backward
=================  ==========================  ===========================
``ag_matmul``      ``all_gather(x) @ w``       dx: the reverse rings of
                                               ``g wᵀ`` in x's dtype; dw:
                                               Σ ``chunkᵀ g`` over the
                                               shards the ring moved
``matmul_rs``      ``reduce_scatter(x @ w)``   g relayed on the reverse
                                               rings in the accumulator's
                                               dtype: dx = g' wᵀ, dw = xᵀ g'
``matmul_ar``      ``psum(x @ w)``             ``psum(g)``, then the matmul's
``ag_seq``         all-gather                  the reverse rings, g's
                                               slices summed in g's dtype
``rs_seq``         reduce-scatter              g relayed on the reverse
                                               rings in float32
``psum_model``     ``psum``                    ``psum``
``psum_model_ge``  ``psum``                    identity
``a2a``            all-to-all                  all-to-all, split and concat
                                               swapped
``weight``         all-gather over each data   ``ag_seq``'s over each,
                   axis, innermost first       innermost last
=================  ==========================  ===========================

``pmax_model`` has none: it is only ever taken on detached values.  Each
transpose sends what JAX's AD of the reference's ring sends, message for
message (:mod:`repro_torch.core.collectives`' ``*_t``): the reverse
ring, on the channel of its own direction, in the dtype the forward's
hop carried; a BSP collective's transpose is the monolithic one.
While a :class:`~repro_torch.distributed.spmd_autograd.Tape` records on
the rank thread (training at tp > 1, or with FSDP gathers), each such
call is a cut of the tape and its transpose runs on the rank thread in
the tape's backward; otherwise it is an ``autograd.Function`` whose
backward runs the transpose in its node.  Every collective's forward
goes through :func:`~repro_torch.distributed.spmd_autograd.
run_collective`, so a remat segment's recompute can leave out the ones
its backward does not read.

Axis conventions: ``model_axis`` = the TP/EP/SP axis; ``data_axis`` = the
DP/FSDP axis (an Axis, or a tuple of Axes for a multi-axis data
dimension, outermost first).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..core import attrs as _attrs
from ..core import collectives as C
from ..core.axis import Axis
from ..core.modes import CommConfig, CommMode
from ..core.progress import EndpointSpec
from ..core.runtime import resolve_device
from ..kernels import apply
from ..core.tree import tree_map
from . import spmd_autograd

AxisSpec = Union[Axis, Tuple[Axis, ...], None]


def _axes(a: AxisSpec) -> Tuple[Axis, ...]:
    if a is None:
        return ()
    return (a,) if isinstance(a, Axis) else tuple(a)


@dataclasses.dataclass(frozen=True)
class Comm:
    """In-graph communication device handed to model code."""

    config: CommConfig
    model_axis: AxisSpec = None
    data_axis: AxisSpec = None
    fsdp: bool = True          # gather FSDP-dim weights in weight()
    # Endpoint spec: which resource bundle this Comm's collectives ride.
    # On the host runtime an EndpointSpec materializes as N devices; in
    # the in-graph layer the same knob selects the collective channel
    # count (chunk-streams) and the shared/dedicated schedule mode.
    endpoint: Optional[EndpointSpec] = None

    @property
    def cfg(self) -> CommConfig:
        """The CommConfig the collectives run with: the endpoint spec
        overrides channel count and mode (BSP is never overridden — the
        baseline stays the baseline)."""
        if self.endpoint is None or self.config.mode == CommMode.BSP:
            return self.config
        mode = (CommMode.LCI_DEDICATED
                if self.endpoint.progress == "dedicated"
                else CommMode.LCI_SHARED)
        return dataclasses.replace(self.config, mode=mode,
                                   n_channels=self.endpoint.n_devices)

    def with_endpoint(self, spec: EndpointSpec) -> "Comm":
        return dataclasses.replace(self, endpoint=spec)

    # -- attribute introspection: the Comm is a view over the effective
    #    config its collectives run with ---------------------------------
    def get_attr(self, name: str):
        """One attribute of the *effective* config (endpoint spec layered
        over the CommConfig), plus the mesh widths ``tp``/``dp``."""
        name = _attrs.canonical_name(name)
        if name == "tp":
            return self.tp
        if name == "dp":
            return self.dp
        if self.endpoint is not None:
            try:
                return self.endpoint.get_attr(name)
            except _attrs.AttrError:
                pass                       # not an endpoint attr: fall back
        return self.cfg.get_attr(name)

    @property
    def attrs(self) -> dict:
        out = dict(self.cfg.attrs)
        if self.endpoint is not None:
            out.update(self.endpoint.attrs)
        return out

    # -- axis sizes (1 when unbound) ----------------------------------------
    @property
    def tp(self) -> int:
        return math.prod([a.size for a in _axes(self.model_axis)] or [1])

    @property
    def dp(self) -> int:
        return math.prod([a.size for a in _axes(self.data_axis)] or [1])

    def _one_model_axis(self) -> Optional[Axis]:
        ax = _axes(self.model_axis)
        if len(ax) > 1:
            raise ValueError("model axis must be a single mesh axis")
        return ax[0] if ax else None

    # -- tensor-parallel matmuls (SP <-> TP boundary) ------------------------
    def ag_matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``allgather(x, axis=0 over model) @ w`` — column-parallel entry.
        x: (s_local, ..., k) seq-sharded; w: (k, n_local)."""
        ax = self._one_model_axis()
        if ax is None:
            return torch.matmul(x, w).to(x.dtype)
        cfg = self.cfg
        return _differentiable(
            lambda x, w: C.all_gather_matmul(x, w, ax, cfg,
                                             keep_chunks=True),
            lambda ins, g, chunks: _ag_matmul_t(ax, cfg, ins, g, chunks),
            x, w, reads=True, residual=True)

    def matmul_rs(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``reduce_scatter(x @ w, axis=0 over model)`` — row-parallel exit.
        x: (s, ..., k_local); w: (k_local, n).  Returns (s/TP, ..., n)."""
        ax = self._one_model_axis()
        if ax is None:
            return torch.matmul(x, w).to(x.dtype)
        cfg = self.cfg
        return _differentiable(
            lambda x, w: C.matmul_reduce_scatter(x, w, ax, cfg),
            lambda ins, g, _: _matmul_rs_t(ax, cfg, ins, g), x, w,
            reads=True)

    def matmul_ar(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``allreduce(x @ w)`` — row-parallel exit without SP (decode,
        where s is too small to scatter)."""
        ax = self._one_model_axis()
        y = torch.matmul(x, w).to(x.dtype)
        if ax is None:
            return y
        return _differentiable(ax.psum,
                               lambda ins, g, _: _psum_t(ax, ins, g), y)

    # -- raw collectives over the model axis ---------------------------------
    def ag_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        """All-gather the SP (sequence) dim back to full length."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        cfg = self.cfg
        return _differentiable(
            lambda x: C.all_gather(x, ax, cfg, axis=axis),
            lambda ins, g, _: _ag_seq_t(ax, cfg, axis, ins, g), x)

    def rs_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        ax = self._one_model_axis()
        if ax is None:
            return x
        cfg = self.cfg
        return _differentiable(
            lambda x: C.reduce_scatter(x, ax, cfg, axis=axis),
            lambda ins, g, _: _rs_seq_t(ax, cfg, axis, ins, g), x)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """psum over the model axis; its transpose is the psum (each
        rank's operand feeds every rank's differing consumer, as the SSM
        gated norm's sum of squares does)."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        return _differentiable(ax.psum,
                               lambda ins, g, _: _psum_t(ax, ins, g), x)

    def psum_model_ge(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient-exact psum over the model axis (router aux means, the
        loss's exp-sums and target logits).

        The forward value is the psum; the backward passes the cotangent
        through untouched, the reference's ``x + stop_gradient(psum(x) -
        x)``: the value is replicated over the axis, so each rank's
        cotangent already is the whole one."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return apply(_PsumGradExact, x, ax)
        return spmd_autograd.run_collective(_plain(ax.psum), [x])[0]

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """pmax over the model axis, of values no gradient flows through
        (the loss's detached logit max, the decode combine's)."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        return spmd_autograd.run_collective(_plain(ax.pmax), [x])[0]

    def a2a(self, x: torch.Tensor, *, split_axis: int, concat_axis: int
            ) -> torch.Tensor:
        """All-to-all over the model axis (MoE dispatch and combine)."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        cfg = self.cfg
        return _differentiable(
            lambda x: C.all_to_all(x, ax, split_axis=split_axis,
                                   concat_axis=concat_axis, config=cfg),
            lambda ins, g, _: _a2a_t(ax, cfg, split_axis, concat_axis, ins,
                                     g), x)

    def model_index(self) -> int:
        ax = self._one_model_axis()
        return 0 if ax is None else ax.index

    # -- FSDP (data axis) weight gather --------------------------------------
    def weight(self, w: torch.Tensor, *, fsdp_axis: Optional[int]
               ) -> torch.Tensor:
        """Gather a weight's FSDP-sharded dim back to full size (in LCI
        modes a ring; innermost data axis first); its transpose
        reduce-scatters the gradient over the same axes, so an FSDP
        leaf's gradient arrives summed over data."""
        if fsdp_axis is None or not self.fsdp:
            return w
        axes = _axes(self.data_axis)
        if not axes:
            return w
        cfg = self.cfg

        def gather(w):
            for a in reversed(axes):
                w = C.all_gather(w, a, cfg, axis=fsdp_axis)
            return w
        return _differentiable(
            gather,
            lambda ins, g, _: _weight_t(axes, cfg, fsdp_axis, ins, g), w)

    # -- data-parallel reductions --------------------------------------------
    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        for a in _axes(self.data_axis):
            x = a.psum(x)
        return x

    def data_index(self) -> int:
        """Flat index along the (possibly multi-axis) data dimension."""
        idx = 0
        for a in _axes(self.data_axis):
            idx = idx * a.size + a.index
        return idx

    def ag_data(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        """All-gather over the data axes along ``axis`` (tiny tensors —
        the 2D-TP serving column reassembly)."""
        for a in reversed(_axes(self.data_axis)):
            x = C.all_gather(x, a, self.cfg, axis=axis)
        return x

    def pmean_data(self, x):
        if not _axes(self.data_axis):
            return x
        return tree_map(lambda v: self.psum_data(v) / self.dp, x)

    def psum_all(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum_model(self.psum_data(x))

    def pmean_all(self, x):
        """Mean over every mesh axis — makes a metric fully replicated."""
        n = self.tp * self.dp
        return tree_map(lambda v: self.psum_all(v) / n, x)

    # -- barrier (paper §6 primitive) ----------------------------------------
    def barrier(self, device=None) -> torch.Tensor:
        """The dissemination barrier over the model axis, then each data
        axis; the token lies on the axes' device, or on ``device``
        (default ``cuda``) when no axis is bound."""
        ax = self._one_model_axis()
        bound = _axes(self.model_axis) + _axes(self.data_axis)
        tok = torch.ones((), dtype=torch.int32,
                         device=bound[0].device if bound
                         else resolve_device(device))
        if ax is not None:
            tok = C.dissemination_barrier(ax)
        for a in _axes(self.data_axis):
            tok = tok * 0 + C.dissemination_barrier(a)
        return tok


# ---------------------------------------------------------------------------
# the transposes: ``(inputs, g[, residual]) -> [cotangent of each input]``,
# the inputs detached; each runs its collectives on the calling (rank)
# thread
# ---------------------------------------------------------------------------

def _ag_matmul_t(ax, cfg, ins, g, chunks):
    x, w = ins
    return list(C.all_gather_matmul_t(x, w, g, chunks, ax, cfg))


def _matmul_rs_t(ax, cfg, ins, g):
    x, w = ins
    return list(C.matmul_reduce_scatter_t(x, w, g, ax, cfg))


def _psum_t(ax, ins, g):
    return [ax.psum(g.contiguous())]


def _ag_seq_t(ax, cfg, axis, ins, g):
    return [C.all_gather_t(g, ax, cfg, axis=axis)]


def _rs_seq_t(ax, cfg, axis, ins, g):
    return [C.reduce_scatter_t(g, ax, cfg, axis=axis)]


def _a2a_t(ax, cfg, split_axis, concat_axis, ins, g):
    return [C.all_to_all(g, ax, split_axis=concat_axis,
                         concat_axis=split_axis, config=cfg)]


def _weight_t(axes, cfg, fsdp_axis, ins, g):
    for a in axes:                    # outermost first: innermost last
        g = C.all_gather_t(g, a, cfg, axis=fsdp_axis)
    return [g]


def _plain(fwd):
    """``fwd`` as a forward with no residual: ``(out, None)``."""
    return lambda *xs: (fwd(*xs), None)


class _Collective(torch.autograd.Function):
    """``fwd(*inputs)`` with ``transpose(inputs, g, residual)`` as its
    backward (run in the backward node: the path without a tape)."""

    @staticmethod
    def forward(ctx, fwd, transpose, *inputs):
        ctx.transpose = transpose
        ctx.save_for_backward(*inputs)
        out, ctx.residual = fwd(*inputs)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(ctx.transpose(
            [t.detach() for t in ctx.saved_tensors], g, ctx.residual))


def _differentiable(fwd, transpose, *inputs: torch.Tensor,
                    reads: bool = False, residual: bool = False
                    ) -> torch.Tensor:
    """``fwd(*inputs)`` (returning ``(out, residual)`` when ``residual``,
    the transpose's third argument); where a gradient is wanted, a cut
    of the thread's recording tape, or else a :class:`_Collective`.
    ``reads``: the transpose reads the inputs' values (a matmul's), for
    :func:`~repro_torch.distributed.spmd_autograd.run_collective`."""
    run = fwd if residual else _plain(fwd)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return spmd_autograd.run_collective(run, inputs, reads=reads,
                                            residual=residual)[0]
    tape = spmd_autograd.active()
    if tape is not None:
        return tape.cut(run, transpose, inputs, reads=reads,
                        residual=residual)
    return _Collective.apply(run, transpose, *inputs)


class _PsumGradExact(torch.autograd.Function):
    """``axis.psum`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return spmd_autograd.run_collective(_plain(axis.psum), [x])[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


def local_comm(config: Optional[CommConfig] = None) -> Comm:
    """A Comm with no mesh axes: collectives degenerate to local compute."""
    return Comm(config or CommConfig(), model_axis=None, data_axis=None)
