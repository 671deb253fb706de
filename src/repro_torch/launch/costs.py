"""Per-rank op and collective counter — FLOPs, bytes and collectives of
eager PyTorch code (the counterpart of :mod:`repro.launch.costs`).

The reference walks a jaxpr and multiplies scan bodies by their trip
count.  Eager code runs every loop iteration, so the port counts what
runs: :func:`count_costs` runs a function under a :class:`CostCounter`
(a ``TorchDispatchMode``) and adds up

* ``flops``     — ``2·batch·m·n·k`` of every matmul-class aten op the
  code dispatches (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``: what ``matmul``, ``linear`` and ``einsum`` lower to), plus
  each kernel wrapper's formula (``repro_torch/kernels``: the work the
  hand-written kernel does on the card, recorded once a call on the
  meta device, the CPU and the card alike);
* ``dot_bytes`` — Σ (lhs + rhs + out) bytes of every matmul, plus each
  kernel's bytes: the HBM-traffic model of the roofline;
* ``coll_bytes`` — the transfer of every collective recorded on an
  :class:`~repro_torch.core.axis.Axis` (``LciAxis``, ``DistAxis`` and the
  dry run's shape-only axis alike), under the reference's ring models;
  ppermute bytes split by ring *direction* (``dst == (src + 1) % n`` of
  the first pair), with per-direction step counts.

No loop is multiplied, so ``unknown_while`` stays 0: a Python loop runs
its iterations, each counted.  The counter is per thread (a rank thread
counts its own rank, as the reference's walker counts one device's
program); autograd carries it to the worker thread that runs a card's
backward.  Besides the reference's fields a counter keeps, for the dry
run, ``bytes_accessed`` (the bytes every non-view op reads and writes,
each tensor argument and output counted whole), the live bytes of the
storages created inside it (``live_bytes``, their peak ``peak_bytes``),
the storages it wrote in place that it did not create
(:meth:`CostCounter.written`) and those no op touched
(:meth:`CostCounter.unused`).

Ring models (bytes one rank puts on a link, per op):
  ppermute: |operand|;  all_gather(tiled): |in|·(P-1);
  reduce_scatter: |out|·(P-1);  psum: 2·|x|·(P-1)/P;
  all_to_all: |x|·(P-1)/P;  pmax: like psum.

The card's peak figures (H100 SXM 80GB data sheet) live here, for the
roofline (:mod:`repro_torch.launch.dryrun`) and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

#: dense bf16 tensor-core peak, FLOP/s (H100 SXM 80GB data sheet)
PEAK_BF16_FLOPS = 989e12
#: float32 CUDA-core peak, FLOP/s (H100 SXM 80GB data sheet)
PEAK_F32_FLOPS = 67e12
#: HBM3 bandwidth, B/s (H100 SXM 80GB data sheet)
HBM_BYTES_PER_S = 3.35e12
#: one direction of a link, B/s: NVLink 4's 900 GB/s aggregate (H100 SXM
#: 80GB data sheet) both ways, which one ring step through NVSwitch uses
LINK_BYTES_PER_S = 450e9
#: the peaks by dtype name
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    dot_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    ppermute_fwd_bytes: float = 0.0
    ppermute_bwd_bytes: float = 0.0
    ppermute_fwd_steps: float = 0.0
    ppermute_bwd_steps: float = 0.0
    unknown_while: int = 0
    #: each kernel's {"launches", "flops", "bytes"} (the formulas)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: each collective kind's {"count", "xfer_bytes"}
    coll_ops: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    bytes_accessed: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def link_bytes(self) -> float:
        """Worst single-link traffic: counter-rotating rings use both
        directions concurrently, so the busier direction + everything
        that is not direction-split."""
        other = self.total_coll_bytes - self.ppermute_fwd_bytes \
            - self.ppermute_bwd_bytes
        return max(self.ppermute_fwd_bytes, self.ppermute_bwd_bytes) + other

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "dot_bytes": self.dot_bytes,
            "coll_bytes_by_kind": dict(self.coll_bytes),
            "coll_bytes_total": self.total_coll_bytes,
            "coll_link_bytes": self.link_bytes,
            "ppermute_fwd_bytes": self.ppermute_fwd_bytes,
            "ppermute_bwd_bytes": self.ppermute_bwd_bytes,
            "ppermute_fwd_steps": self.ppermute_fwd_steps,
            "ppermute_bwd_steps": self.ppermute_bwd_steps,
            "unknown_while": self.unknown_while,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def ring_xfer(kind: str, nbytes: int, p: int) -> float:
    """Bytes one rank puts on a link for one collective of ``kind`` over
    ``p`` ranks on an operand of ``nbytes`` (the module's ring models)."""
    if kind == "ppermute":
        return float(nbytes)
    if kind == "all_gather":
        return float(nbytes * (p - 1))
    if kind == "reduce_scatter":
        return float(nbytes // p * (p - 1))
    if kind in ("psum", "pmax"):
        return 2.0 * nbytes * (p - 1) / max(p, 1)
    if kind == "all_to_all":
        return nbytes * (p - 1) / max(p, 1)
    raise ValueError(f"unknown collective kind {kind!r}")


def _matmul_dims(name: str, args) -> Tuple[int, Any, Any]:
    """(batch·m·n·k, lhs, rhs) of a matmul-class op (one of
    :data:`_MATMULS`; ``addmm``, ``baddbmm`` and ``addmv`` take their
    operands after the addend)."""
    i = 1 if name in ("addmm", "baddbmm", "addmv") else 0
    a, b = args[i], args[i + 1]
    k = a.shape[-1]
    n = b.shape[-1] if b.dim() >= 2 else 1
    lead = a.numel() // max(k, 1)           # batch · m
    return lead * n * k, a, b


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """The counter (see the module docstring).  ``costs`` holds the
    counts; ``paused`` > 0 stops matmul counting (a kernel's plain version
    running on the CPU after its formula was recorded)."""

    cost_sink = True

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.paused = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        # reentrant: a storage's finalizer (``_free``) can run on this
        # thread inside the counter's own bookkeeping, when the
        # collector runs there
        self._lock = threading.RLock()
        self._made = WeakIdKeyDictionary()
        self._written = WeakIdKeyDictionary()
        self._read = WeakIdKeyDictionary()

    # -- hooks the kernels and the axes call --------------------------------
    def kernel(self, name: str, flops: float, nbytes: float,
               launches: int = 1, reads=()) -> None:
        for t in reads:
            self._read[t.untyped_storage()] = True
        with self._lock:
            k = self.costs.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += launches
            k["flops"] += flops
            k["bytes"] += nbytes
            self.costs.flops += flops
            self.costs.dot_bytes += nbytes
            self.costs.bytes_accessed += nbytes

    def collective(self, kind: str, nbytes: int, p: int,
                   pair: Optional[Tuple[int, int]] = None,
                   n: int = 0) -> None:
        c = self.costs
        xfer = ring_xfer(kind, nbytes, p)
        with self._lock:
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + xfer
            op = c.coll_ops.setdefault(kind, {"count": 0, "xfer_bytes": 0.0})
            op["count"] += 1
            op["xfer_bytes"] += xfer
            if kind == "ppermute":
                fwd = pair is None or pair[1] == (pair[0] + 1) % n
                if fwd:
                    c.ppermute_fwd_bytes += xfer
                    c.ppermute_fwd_steps += 1
                else:
                    c.ppermute_bwd_bytes += xfer
                    c.ppermute_bwd_steps += 1

    # -- memory ---------------------------------------------------------------
    def _free(self, nbytes: int) -> None:
        with self._lock:
            self.live_bytes -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._made:
                continue
            size = st.nbytes()
            self._made[st] = size
            weakref.finalize(st, self._free, size)
            with self._lock:
                self.live_bytes += size
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def written(self, tensors) -> int:
        """The bytes of the storages among ``tensors`` (made before the
        counter) that an op wrote in place while it counted."""
        return self._bytes_of(tensors, self._written)

    def unused(self, tensors) -> int:
        """The bytes of the storages among ``tensors`` that no op read or
        wrote while it counted."""
        return self._bytes_of(tensors, self._read, invert=True)

    @staticmethod
    def _bytes_of(tensors, marked, invert: bool = False) -> int:
        seen = WeakIdKeyDictionary()
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if (st in marked) != invert and st not in seen:
                seen[st] = True
                total += st.nbytes()
        return total

    # -- the dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _op_info(func)
        is_view, matmul, writes = info
        if is_view:
            return out
        outs = _flat(out)
        ins = _flat(args)
        if kwargs:
            ins += _flat(tuple(kwargs.values()))
        for t in ins:
            self._read[t.untyped_storage()] = True
        c = self.costs
        touched = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        with self._lock:
            c.bytes_accessed += touched
            if matmul and not self.paused:
                work, a, b = _matmul_dims(matmul, args)
                c.flops += 2.0 * work
                c.dot_bytes += _nbytes(a) + _nbytes(b) + sum(
                    map(_nbytes, outs))
        for i, name in writes:
            v = args[i] if i < len(args) else kwargs.get(name)
            for t in _flat((v,)):
                self._written[t.untyped_storage()] = True
        self._track(outs)
        return out


#: per aten op: (is a view, its matmul name or None, the (index, name) of
#: the arguments it writes)
_OP_INFO: Dict[Any, Tuple[bool, Optional[str], Tuple]] = {}
_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "addmv", "mv", "dot")


def _op_info(func) -> Tuple[bool, Optional[str], Tuple]:
    name = func._overloadpacket.__name__
    writes = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write)
    return (bool(getattr(func, "is_view", False)),
            name if name in _MATMULS else None, writes)


def _flat(xs) -> List[torch.Tensor]:
    """The tensors of ``xs`` (a tensor, or a tuple / list of tensors and
    of lists of tensors, as aten ops take and return them)."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def count_costs(fn: Callable, *args, **kwargs) -> Tuple[Any, Costs]:
    """``(fn(*args, **kwargs), its Costs)`` on this thread."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs
