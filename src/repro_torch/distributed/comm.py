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
from ..core.tree import tree_map

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
        return C.all_gather_matmul(x, w, ax, self.cfg)

    def matmul_rs(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``reduce_scatter(x @ w, axis=0 over model)`` — row-parallel exit.
        x: (s, ..., k_local); w: (k_local, n).  Returns (s/TP, ..., n)."""
        ax = self._one_model_axis()
        if ax is None:
            return torch.matmul(x, w).to(x.dtype)
        return C.matmul_reduce_scatter(x, w, ax, self.cfg)

    def matmul_ar(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``allreduce(x @ w)`` — row-parallel exit without SP (decode,
        where s is too small to scatter)."""
        ax = self._one_model_axis()
        y = torch.matmul(x, w).to(x.dtype)
        if ax is None:
            return y
        return ax.psum(y)

    # -- raw collectives over the model axis ---------------------------------
    def ag_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        """All-gather the SP (sequence) dim back to full length."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        return C.all_gather(x, ax, self.cfg, axis=axis)

    def rs_seq(self, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
        ax = self._one_model_axis()
        if ax is None:
            return x
        return C.reduce_scatter(x, ax, self.cfg, axis=axis)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        ax = self._one_model_axis()
        if ax is None:
            return x
        return ax.psum(x)

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
        return _PsumGradExact.apply(x, ax)

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        ax = self._one_model_axis()
        if ax is None:
            return x
        return ax.pmax(x)

    def a2a(self, x: torch.Tensor, *, split_axis: int, concat_axis: int
            ) -> torch.Tensor:
        """All-to-all over the model axis (MoE dispatch and combine)."""
        ax = self._one_model_axis()
        if ax is None:
            return x
        return C.all_to_all(x, ax, split_axis=split_axis,
                            concat_axis=concat_axis, config=self.cfg)

    def model_index(self) -> int:
        ax = self._one_model_axis()
        return 0 if ax is None else ax.index

    # -- FSDP (data axis) weight gather --------------------------------------
    def weight(self, w: torch.Tensor, *, fsdp_axis: Optional[int]
               ) -> torch.Tensor:
        """Gather a weight's FSDP-sharded dim back to full size (in LCI
        modes a ring; innermost data axis first)."""
        if fsdp_axis is None or not self.fsdp:
            return w
        axes = _axes(self.data_axis)
        if not axes:
            return w
        for a in reversed(axes):
            w = C.all_gather(w, a, self.cfg, axis=fsdp_axis)
        return w

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


class _PsumGradExact(torch.autograd.Function):
    """``axis.psum`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def local_comm(config: Optional[CommConfig] = None) -> Comm:
    """A Comm with no mesh axes: collectives degenerate to local compute."""
    return Comm(config or CommConfig(), model_axis=None, data_axis=None)
