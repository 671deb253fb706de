"""Sharded async checkpointing with atomic commit and elastic restore.

Layout on disk (the reference's, byte for byte)::

    <dir>/step_00001234/
        manifest.json        # tree structure, shapes, dtypes, hashes, meta
        <leaf-path>.npy      # one file per tree leaf (the full tensor)
    <dir>/LATEST             # atomically-updated pointer

For the same tree, every file the port writes is byte-identical to the
reference's (``repro.checkpoint.store``), so each package restores the
other's checkpoints:

* leaf names and the manifest's order are those of
  ``jax.tree_util.tree_flatten_with_path``: dict keys sorted at every
  level, a name the path's keys and list indices joined by ``_``;
* a bf16 leaf is written as the reference writes an ``ml_dtypes``
  bfloat16 array: a ``<V2`` .npy of its bits, ``"bfloat16"`` in the
  manifest.  On the host the port carries it as a numpy ``V2`` array
  (what numpy loads from that file) and restores it as bf16 by the
  manifest's dtype; the reference hands such a leaf back as ``V2``.

Fault-tolerance properties (DESIGN.md §7):

* **atomic commit** — leaves are written into ``step_*.tmp`` and the
  directory is ``rename``d only after every file (and the manifest with
  content hashes) is fsync'd; a crash mid-save never corrupts LATEST.
* **async** — ``save_async`` copies every tensor to host memory before
  it returns (a snapshot no later write to the tensor reaches, on the
  card or on the CPU), then writes on a background thread; the returned
  :class:`Synchronizer` is signaled on commit; ``sync.wait()`` blocks on
  it, ``sync.test()`` polls.  Serving or training continues during the
  write (hashing and file writes release the GIL).
* **the commit pipeline is a completion graph** — prepare → one write
  node per leaf → manifest → atomic rename → signal.  The partial order
  *is* the crash-safety argument, and it is asserted after every commit.
* **elastic restore** — the manifest stores *global* shapes;
  ``restore_resharded`` cuts every leaf for each rank of a new
  :class:`~repro_torch.distributed.Mesh` by its ``PartitionSpec``.
* **integrity** — every leaf file carries a SHA-256 in the manifest;
  restore verifies before handing tensors back.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.completion import Synchronizer
from ..core.graph import CompletionGraph
from ..core.runtime import resolve_device
from ..core.status import FatalError, done

_EXECUTOR = cf.ThreadPoolExecutor(max_workers=2,
                                  thread_name_prefix="ckpt-writer")

#: a bf16 leaf on the host: its bits, as numpy loads the reference's file
_BF16_BITS = np.dtype("V2")


# ---------------------------------------------------------------------------
# trees: the reference's leaf names and order, without JAX
# ---------------------------------------------------------------------------

def _named(tree: Any, path: tuple = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted, lists and tuples by index, ``None`` an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        kids = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = list(enumerate(tree))
    else:
        return [("_".join(str(k) for k in path), tree)]
    return [x for k, v in kids for x in _named(v, path + (k,))]


def _rebuild(tree: Any, value: Callable[[str, Any], Any],
             path: tuple = ()) -> Any:
    """``tree``'s containers with each leaf replaced by
    ``value(name, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, value, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, value, path + (i,))
                          for i, v in enumerate(tree))
    return value("_".join(str(k) for k in path), tree)


# ---------------------------------------------------------------------------
# leaves on the host
# ---------------------------------------------------------------------------

def _to_host(leaf: Any, copy: bool = False) -> np.ndarray:
    """A C-ordered host array of ``leaf``.  A tensor is copied into fresh
    host memory (synchronously from the card), so no later write to it
    reaches the array; a host array is copied only if ``copy``."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, order="C") if copy else \
            np.asarray(leaf, order="C")
    host = torch.empty(leaf.shape, dtype=leaf.dtype)
    host.copy_(leaf.detach())
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(_BF16_BITS)
    return host.numpy()


def _snapshot(tree: Any) -> Any:
    """``tree`` with every leaf copied to host memory."""
    return _rebuild(tree, lambda _name, leaf: _to_host(leaf, copy=True))


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)


def _leaf_files(tree: Any) -> Dict[str, np.ndarray]:
    return {name: _to_host(leaf) for name, leaf in _named(tree)}


def _bytes(arr: np.ndarray) -> np.ndarray:
    """``arr``'s bytes, C order, as a flat uint8 view (a copy only if
    ``arr`` is not C-contiguous)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(_bytes(arr)).hexdigest()


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, but a bf16 leaf's header says ``<V2`` as the
    reference's does (numpy spells a ``V2`` array ``|V2``)."""
    if arr.dtype != _BF16_BITS:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(_bytes(arr))


def _write_leaf(tmp: str, name: str, arr: np.ndarray) -> tuple:
    path = os.path.join(tmp, name + ".npy")
    _save_npy(path, arr)
    with open(path, "rb") as f:
        os.fsync(f.fileno())
    return name, {"shape": list(arr.shape), "dtype": _dtype_name(arr),
                  "sha256": _sha(arr)}


def _to_tensor(name: str, arr: np.ndarray, dtype: str, device
               ) -> torch.Tensor:
    """The loaded leaf as a tensor of the manifest's ``dtype`` on
    ``device``."""
    if dtype == "bfloat16" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif str(arr.dtype) == dtype:
        t = torch.from_numpy(arr)
    else:
        raise FatalError(f"checkpoint leaf {name}: file dtype {arr.dtype}, "
                         f"manifest dtype {dtype}")
    return t.to(device)


# ---------------------------------------------------------------------------
# the commit pipeline
# ---------------------------------------------------------------------------

def build_commit_graph(ckpt_dir: str, step: int, host_tree: Any,
                       meta: Optional[Dict], sync: Synchronizer
                       ) -> CompletionGraph:
    """The commit pipeline as an LCI completion graph.

    prepare → write(leaf)* → manifest → rename-commit → signal(sync).
    The graph's partial order is the crash-safety invariant: the atomic
    rename fires only after every leaf write *and* the fsync'd manifest
    completed, and ``sync`` is signaled only after LATEST moved.
    """
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def prepare():
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def write_manifest(*leaf_infos):
        # the graph's queryable attrs ride the manifest: a restore can see
        # how the commit pipeline was shaped
        manifest = {"step": step, "meta": meta or {},
                    "commit_graph": {"n_nodes": g.get_attr("n_nodes"),
                                     "n_comm_nodes":
                                         g.get_attr("n_comm_nodes")},
                    "leaves": {name: info for name, info in leaf_infos}}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        return mpath

    def commit(_manifest_path):
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic commit
        _update_latest(ckpt_dir, step)
        return final

    g = CompletionGraph(f"ckpt-commit-{step}")
    prep = g.add_node(prepare, name="prepare")
    # ``_write_leaf`` is looked up when the node fires, so a test can
    # slow it down to kill a commit midway
    writes = [g.add_node(lambda _tmp, n=name, a=arr: _write_leaf(_tmp, n, a),
                         deps=[prep], name=f"write:{name}")
              for name, arr in _leaf_files(host_tree).items()]
    man = g.add_node(write_manifest, deps=writes, name="manifest")
    com = g.add_node(commit, deps=[man], name="commit")
    g.add_node(lambda path: sync.signal(done(path)), deps=[com],
               name="signal")
    return g


def _update_latest(ckpt_dir: str, step: int) -> None:
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def save_sync(ckpt_dir: str, step: int, tree: Any,
              meta: Optional[Dict] = None) -> str:
    """Blocking save with atomic rename commit. Returns final path."""
    host_tree = _snapshot(tree)
    sync = Synchronizer(expected=1)
    g = build_commit_graph(ckpt_dir, step, host_tree, meta, sync)
    g.execute()                                 # host-only graph: synchronous
    g.assert_partial_order()
    (status,) = sync.wait()
    return status.get_buffer()


def save_async(ckpt_dir: str, step: int, tree: Any,
               meta: Optional[Dict] = None) -> Synchronizer:
    """Snapshot to host now; write + commit on a background thread.

    Every leaf is copied to host memory before this returns.  Returns an
    LCI Synchronizer signaled (once) when the commit lands;
    ``sync.wait()`` blocks until then (no progress driver needed — the
    writer thread delivers the signal), ``sync.test()`` polls.
    """
    host_tree = _snapshot(tree)
    sync = Synchronizer(expected=1)
    g = build_commit_graph(ckpt_dir, step, host_tree, meta, sync)

    def work():
        try:
            g.execute()
            g.assert_partial_order()
        except BaseException as e:                       # noqa: BLE001
            # never leave waiters blocked OR fooled: ready/test()/wait()
            # re-raise this as a FatalError — a failed commit can never
            # look like a landed checkpoint
            sync.fail(e)
            raise

    _EXECUTOR.submit(work)
    return sync


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None, *,
            device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (its leaves may be
    tensors on the ``meta`` device: only their shapes are read), every
    leaf a tensor of the manifest's dtype on ``device`` (default the
    card; ``"cpu"`` for the host).

    Verifies content hashes; raises FatalError on mismatch/corruption.
    """
    dev = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FatalError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    leaves = {}
    for name, like in _named(tree_like):
        info = manifest["leaves"].get(name)
        if info is None:
            raise FatalError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(path, name + ".npy"))
        if _sha(arr) != info["sha256"]:
            raise FatalError(f"checkpoint leaf {name} corrupt (hash)")
        shape = getattr(like, "shape", None)
        if shape is not None and tuple(shape) != arr.shape:
            raise FatalError(f"checkpoint leaf {name} has shape "
                             f"{arr.shape}, tree_like {tuple(shape)}")
        leaves[name] = _to_tensor(name, arr, info["dtype"], dev)
    return _rebuild(tree_like, lambda name, _like: leaves[name]), manifest


def restore_resharded(ckpt_dir: str, tree_like: Any, specs: Any, mesh,
                      step: Optional[int] = None) -> Tuple[List, Dict]:
    """Elastic restore onto a new mesh: one tree per rank of ``mesh``
    (a :class:`~repro_torch.distributed.Mesh`), each leaf
    ``shard(full, spec, mesh, rank)`` on the mesh's device.

    ``specs`` is a tree of ``PartitionSpec`` (or one spec for a whole
    subtree) matching ``tree_like``; global shapes must agree with the
    manifest, the mesh need not."""
    from ..distributed.elastic import reshard_state
    tree, manifest = restore(ckpt_dir, tree_like, step, device=mesh.device)
    return reshard_state(tree, specs, mesh), manifest


@dataclasses.dataclass
class CheckpointStore:
    """Convenience wrapper used by the train loop."""

    directory: str
    keep_last: int = 3

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None,
             *, blocking: bool = False):
        if blocking:
            save_sync(self.directory, step, tree, meta)
            self.gc()
            return None
        sync = save_async(self.directory, step, tree, meta)
        return sync

    def gc(self) -> None:
        """Drop all but the newest ``keep_last`` committed checkpoints."""
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, tree_like: Any, step: Optional[int] = None, *,
                device=None):
        return restore(self.directory, tree_like, step, device=device)
