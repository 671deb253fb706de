"""``spmd_map`` — the port's counterpart of ``shard_map``.

The reference runs a function once per device of a mesh under
``shard_map``: the inputs are cut by ``PartitionSpec`` trees, axis names
are bound, and the outputs are put back together.  PyTorch has none of
that, so this module does the three steps itself:

* :func:`shard` cuts a full tensor into one rank's shard by a
  :class:`PartitionSpec` (``P("model", None)``: dim 0 over the ``model``
  axis; a tuple of names shards one dim over several axes, outermost
  first, as JAX does);
* :func:`spmd_map` runs ``fn(comm, *local_args)`` once per rank, each
  with its own :class:`~repro_torch.distributed.comm.Comm` whose axes are
  bound :class:`~repro_torch.core.axis.Axis` objects (a 2-D mesh
  ``("data", "model")`` gives every rank one Axis for its row and one for
  its column);
* :func:`unshard` puts the per-rank outputs back together by the output
  specs (a dim an output spec does not name is taken from the ranks at
  coordinate 0 of the axes it leaves out).

A :class:`Mesh` holds the substrate.  ``substrate="lci"`` runs one thread
a rank on a :class:`~repro_torch.core.runtime.LocalCluster` (the comm
core, on the card or the CPU: the paper's thread mode);
``substrate="dist"`` spawns one process a rank joined by
``torch.distributed`` (gloo on the CPU; NCCL across several GPUs is
unverified, as one H100 cannot hold two ranks of a communicator).

Input leaves with a ``PartitionSpec`` (``P()`` included) reach each rank
as its own contiguous copy, so a rank may update them in place; leaves
whose spec is ``None`` are shared by the rank threads as they are and
must be read only.  An argument whose spec is :data:`PER_RANK` is a list
of one tree a rank, each rank's already cut (a sharded train state
between steps): rank ``r`` gets element ``r`` as it is; an output whose
spec is :data:`PER_RANK` comes back as the list of the ranks' trees,
ungathered.  Ranks are numbered row-major over the mesh shape.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import math
import os
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.axis import DistAxis, LciAxis, mesh_groups
from ..core.modes import CommConfig
from ..core.runtime import LocalCluster, resolve_device
from ..core.status import FatalError
from .comm import Comm


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: each entry is an axis name, a
    tuple of names, or ``None`` (that dim is not sharded)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class _PerRank:
    def __repr__(self) -> str:
        return "PER_RANK"


#: the spec of an argument or output held as one tree a rank (no cut, no
#: gather)
PER_RANK = _PerRank()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A device mesh of ``shape`` with axis ``names`` over a substrate.

    ``substrate="lci"``: one :class:`LocalCluster` of ``prod(shape)``
    ranks bound to ``device`` (default ``cuda``), each rank with a shared
    endpoint (one device) and a dedicated one (two devices, one per ring
    direction), allocated symmetrically.  The
    cluster's protocol thresholds are the library's, except that
    rendezvous starts where eager ends (``rdv_threshold`` =
    ``eager_max_bytes``): a collective's pieces are eager up to 64 KiB and
    go by rendezvous above, never through the packet-sized buffer copy.

    ``substrate="dist"``: ``prod(shape)`` spawned processes joined by
    ``torch.distributed`` (gloo on the CPU, nccl on cards)."""

    def __init__(self, shape: Sequence[int], names: Sequence[str], *,
                 substrate: str = "lci", device=None):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and names {names} differ "
                             "in length")
        if substrate not in ("lci", "dist"):
            raise ValueError(f"unknown substrate {substrate!r}; pick 'lci' "
                             "or 'dist'")
        self.shape = tuple(int(n) for n in shape)
        self.names = tuple(names)
        self.size = math.prod(self.shape)
        self.substrate = substrate
        self.device = resolve_device(device)
        self.coords = list(itertools.product(*[range(n)
                                               for n in self.shape]))
        self.groups = mesh_groups(self.shape, self.names)
        self.cluster = None
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        if substrate == "lci":
            self.cluster = LocalCluster(self.size, device=self.device, attrs={
                "rdv_threshold": CommConfig().inject_max_bytes})
            # a rank with nothing to progress sleeps on its bell until the
            # fabric lands a message for it; the rank threads take turns
            # on the baton
            self.bells = [threading.Event() for _ in range(self.size)]
            self.baton = threading.Lock()
            self.cluster.fabric.on_push = lambda dst: self.bells[dst].set()
            self.shared = self.cluster.alloc_endpoint(
                1, progress="shared", name="collectives")
            self.dedicated = self.cluster.alloc_endpoint(
                2, progress="dedicated",
                name="collectives_dedicated")

    def close(self) -> None:
        if self.cluster is not None:
            self.cluster.close()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def coord(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.names, self.coords[rank]))

    def _group_of(self, name: str, rank: int) -> List[int]:
        return next(g for g in self.groups[name] if rank in g)

    def lci_axes(self, rank: int, abort: Optional[threading.Event] = None
                 ) -> Dict[str, LciAxis]:
        """Rank ``rank``'s bound axes on the comm core."""
        rt = self.cluster[rank]
        return {name: LciAxis(rt, self._group_of(name, rank), name=name,
                              uid=i, shared=self.shared[rank],
                              dedicated=self.dedicated[rank], abort=abort,
                              bells=self.bells, baton=self.baton)
                for i, name in enumerate(self.names)}

    def protocol_totals(self) -> Dict[str, int]:
        """Messages and bytes by protocol, summed over every rank."""
        out: Dict[str, int] = {}
        for rt in self.cluster.local_runtimes():
            for k, v in dataclasses.asdict(rt.stats).items():
                out[k] = out.get(k, 0) + v
        return out


def dist_axes(shape: Sequence[int], names: Sequence[str], *,
              device=None) -> Dict[str, DistAxis]:
    """This process' bound axes over an initialized ``torch.distributed``
    world of ``prod(shape)`` ranks (row-major), on ``device`` (default
    ``cuda``, the process' current card; ``"cpu"`` for gloo).  Every rank
    must call it: it creates one process group per row and column of the
    mesh, in the same order everywhere."""
    import torch.distributed as dist
    me = dist.get_rank()
    out = {}
    for name, groups in mesh_groups(shape, names).items():
        for g in groups:
            pg = dist.new_group(g)
            if me in g:
                out[name] = DistAxis(g, pg, name=name, device=device)
    return out


# ---------------------------------------------------------------------------
# cutting and assembling
# ---------------------------------------------------------------------------

def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh: Mesh, coord: Dict[str, int], axes) -> Tuple[int, int]:
    """(block index, block count) of a dim sharded over ``axes``."""
    axes = [a for a in axes if a in mesh.names]
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape[mesh.names.index(a)]
        idx = idx * size + coord[a]
        n *= size
    return idx, n


def shard(t, spec, mesh: Mesh, rank: int):
    """Rank ``rank``'s shard of the full tensor (or numpy array) ``t``: a
    contiguous copy for a :class:`PartitionSpec`, ``t`` itself for
    ``None``."""
    if spec is None or not hasattr(t, "shape"):
        return t
    coord = mesh.coord(rank)
    out = t
    for d, entry in enumerate(spec):
        i, n = _block(mesh, coord, _dim_axes(entry))
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {n} ranks ({spec})")
        size = out.shape[d] // n
        if isinstance(out, torch.Tensor):
            out = out.narrow(d, i * size, size)
        else:
            out = out.take(range(i * size, (i + 1) * size), axis=d)
    if isinstance(out, torch.Tensor):
        return out.clone(memory_format=torch.contiguous_format)
    return out.copy()


def unshard(parts: Sequence, spec, mesh: Mesh):
    """The full tensor from every rank's ``parts[rank]`` by ``spec``."""
    if spec is None or not isinstance(parts[0], torch.Tensor):
        return parts[0]
    dims = [(d, _dim_axes(e)) for d, e in enumerate(spec)]
    named = {a for _, axes in dims for a in axes if a in mesh.names}
    blocks: Dict[tuple, torch.Tensor] = {}
    for r, part in enumerate(parts):
        coord = mesh.coord(r)
        if any(coord[a] for a in mesh.names if a not in named):
            continue
        key = tuple(_block(mesh, coord, axes)[0] for _, axes in dims)
        blocks[key] = part

    def build(prefix: tuple, d: int):
        if d == len(dims):
            return blocks[prefix]
        n = _block(mesh, mesh.coord(0), dims[d][1])[1]
        pieces = [build(prefix + (i,), d + 1) for i in range(n)]
        return pieces[0] if n == 1 else torch.cat(pieces, dim=d)
    return build((), 0)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) and \
        not dataclasses.is_dataclass(x)


def _spec_of(spec):
    """The spec of each child: one spec (a :class:`PartitionSpec` or
    None) covers a whole subtree; a spec tree mirrors the tree."""
    if spec is None or isinstance(spec, PartitionSpec):
        return lambda key: spec
    if dataclasses.is_dataclass(spec):
        return lambda key: getattr(spec, key)
    return lambda key: spec[key]


def _rebuild(first, child):
    """``first``'s container (dict, list, tuple or dataclass) with each
    child ``child(key)``."""
    if isinstance(first, dict):
        return {k: child(k) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(child(i) for i in range(len(first)))
    return dataclasses.replace(first, **{
        f.name: child(f.name) for f in dataclasses.fields(first)})


def _get(tree, key):
    return getattr(tree, key) if dataclasses.is_dataclass(tree) \
        else tree[key]


def tree_map2(fn: Callable, tree, spec):
    """Map ``fn(leaf, spec_leaf)`` over ``tree`` (dicts, lists, tuples and
    dataclasses such as ``DecodeCache``); ``spec`` mirrors the tree or is
    one spec for the whole subtree."""
    if _is_leaf(tree):
        return fn(tree, spec)
    of = _spec_of(spec)
    return _rebuild(tree, lambda k: tree_map2(fn, _get(tree, k), of(k)))


def unshard_tree(parts: List, spec, mesh: Mesh):
    """Per-rank trees -> the full tree, each leaf put together by its
    spec (``spec`` mirrors the trees or is one spec for a subtree)."""
    if spec is PER_RANK:
        return list(parts)
    if _is_leaf(parts[0]):
        return unshard(parts, spec, mesh)
    of = _spec_of(spec)
    return _rebuild(parts[0], lambda k: unshard_tree(
        [_get(p, k) for p in parts], of(k), mesh))


# ---------------------------------------------------------------------------
# spmd_map
# ---------------------------------------------------------------------------

def _comm_for(axes: Dict[str, Any], config: CommConfig, model_axis,
              data_axis) -> Comm:
    def pick(spec):
        if spec is None:
            return None
        if isinstance(spec, str):
            return axes.get(spec)
        got = tuple(axes[a] for a in spec if a in axes)
        return got or None
    return Comm(config, model_axis=pick(model_axis),
                data_axis=pick(data_axis))


def spmd_map(fn: Callable, mesh: Mesh, in_specs: Sequence, out_specs, *,
             config: Optional[CommConfig] = None, model_axis="model",
             data_axis="data") -> Callable:
    """``f(*args)`` runs ``fn(comm, *local_args)`` once per rank of
    ``mesh`` and returns the outputs put together by ``out_specs``.

    ``model_axis`` / ``data_axis`` name the mesh axes the per-rank Comm
    binds (a tuple of names for a multi-axis data dim; an absent name
    leaves that axis unbound).  The Comm gathers FSDP-sharded weights;
    ``fn`` picks another endpoint with ``comm.with_endpoint(...)``."""
    config = config or CommConfig()

    def run(*args):
        locals_ = [[a[r] if sp is PER_RANK else
                    tree_map2(lambda t, s: shard(t, s, mesh, r), a, sp)
                    for a, sp in zip(args, in_specs)]
                   for r in range(mesh.size)]
        if mesh.substrate == "lci":
            outs = _run_threads(fn, mesh, locals_, config, model_axis,
                                data_axis)
        else:
            outs = _run_processes(fn, mesh, locals_, config, model_axis,
                                  data_axis)
        return unshard_tree(outs, out_specs, mesh)

    return run


def _run_threads(fn, mesh: Mesh, locals_, config, model_axis, data_axis
                 ) -> List:
    abort = threading.Event()
    outs: List = [None] * mesh.size
    errors: List = []

    def rank_main(r):
        try:
            if mesh.device.type == "cuda":   # a new thread's current card
                torch.cuda.set_device(mesh.device)
            with mesh.baton:                 # the rank threads take turns
                comm = _comm_for(mesh.lci_axes(r, abort), config,
                                 model_axis, data_axis)
                outs[r] = fn(comm, *locals_[r])
        except BaseException as e:          # surfaced after the join
            errors.append((r, e))
            abort.set()
            for b in mesh.bells:
                b.set()

    threads = [threading.Thread(target=rank_main, args=(r,),
                                name=f"spmd-rank{r}", daemon=True)
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the rank that failed first, not the peers that gave up on it
        r, e = next((x for x in errors if not (
            isinstance(x[1], FatalError) and "peer rank failed" in
            str(x[1]))), errors[0])
        raise RuntimeError(f"spmd_map: rank {r} failed: {e!r}") from e
    return outs


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_rank_main(rank, world, port, backend, shape, names, device, fn,
                    args, config, model_axis, data_axis, queue):
    import torch.distributed as dist
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        axes = dist_axes(shape, names, device=device)
        comm = _comm_for(axes, config, model_axis, data_axis)
        out = fn(comm, *args)
        # by value: a tensor sent through the queue would be shared
        # through this process, which exits first
        buf = io.BytesIO()
        torch.save(out, buf)
        queue.put((rank, buf.getvalue(), None))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:               # reported to the parent
        queue.put((rank, None, repr(e)))


def _run_processes(fn, mesh: Mesh, locals_, config, model_axis, data_axis
                   ) -> List:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_dist_rank_main, args=(
            r, mesh.size, port, mesh.backend, mesh.shape, mesh.names,
            str(mesh.device), fn, locals_[r], config, model_axis, data_axis,
            queue), daemon=True)
            for r in range(mesh.size)]
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    outs: List = [None] * mesh.size
    errors = []
    try:
        for _ in range(mesh.size):
            r, out, err = queue.get(timeout=600)
            if err is not None:
                errors.append((r, err))
                break
            outs[r] = torch.load(io.BytesIO(out), weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError(f"spmd_map: rank {errors[0][0]} failed: "
                           f"{errors[0][1]}")
    return outs
