"""Dry run: trace every (arch × shape × mesh) cell on the meta device (the
counterpart of :mod:`repro.launch.dryrun`).

This is how the distribution config is proven coherent without a card:
rank 0's step (train, prefill or decode) must run on the meta device on
the (16, 16) single-pod mesh AND the (2, 16, 16) multi-pod mesh for all
33 runnable cells, with its shards cut by the same specs the card's
``spmd_map`` cuts them by.  Nothing is allocated and nothing runs: every
tensor is a meta tensor, every kernel wrapper takes its meta dispatch
and records its formula (``repro_torch/kernels``), and every collective
runs on a :class:`CostAxis`, which returns a meta tensor of the exact
output shape.  A :class:`~repro_torch.launch.costs.CostCounter` around
the step gives the roofline's counts and the memory figures.

One traced rank stands for the SPMD program, as the reference's
per-device jaxpr does: rank 0.  Where a rank's shapes depend on its
index they are rank 0's: a MoE rank's capacity rows are the same on
every rank, and Plan B's q offset changes positions, not shapes, so the
counts hold for every rank.  The trace runs on the calling thread:
training at tp > 1 records its collectives on the rank's
:class:`~repro_torch.distributed.spmd_autograd.Tape` as on a card, and
the tape's thread guard (the tests' check that every ``LciAxis`` call
runs on its ``spmd-rank<r>`` thread) is scoped to ``LciAxis``, which
the dry run never builds.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k [--mesh single|multi]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh multi]

Artifacts: ``build/dryrun_torch/<arch>__<shape>__<mesh>__<mode>.json``
(or ``--out DIR``), with every key of the reference's.  The meta device
is the tool's device by design: it touches no card and falls back to
nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..configs import (ARCH_NAMES, SHAPES, cells, get_config,
                       shape_applicable)
from ..core.axis import Axis, mesh_groups
from ..core.modes import CommConfig, CommMode, parse_mode
from ..core.tree import tree_map
from ..distributed.spmd_map import P, tree_map2
from ..models.common import ModelConfig
from ..models.registry import build_model
from ..optim import AdamWConfig, OptState, adamw_init
from ..serving.engine import (cache_pspecs, init_cache, make_prefill_step,
                              make_serve_step)
from ..train.step import TrainState, make_train_step
from .costs import (HBM_BYTES_PER_S, LINK_BYTES_PER_S, PEAK_FLOPS,
                    CostCounter, Costs)
from .mesh import batch_pspecs, data_axes, make_comm, shard

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")
META = torch.device("meta")
#: the collectives' kinds under XLA's names (the reference's artifacts)
XLA_KIND = {"ppermute": "collective-permute", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "psum": "all-reduce",
            "pmax": "all-reduce", "all_to_all": "all-to-all"}
#: artifact keys of the reference's that eager torch has no value for
NO_COUNTERPART = {
    "lower_s": "eager: no lowering; the trace's seconds are trace_s",
    "compile_s": "eager: nothing is compiled; the trace's seconds are "
                 "trace_s",
    "generated_code_size_in_bytes": "eager: no generated code (the "
                                    "kernels are built once, not a cell)",
}


# ---------------------------------------------------------------------------
# the abstract mesh and the shape-only axis
# ---------------------------------------------------------------------------

class AbstractMesh:
    """A mesh that holds only its shape, names, coords and groups (no
    cluster, no ranks): what :func:`~repro_torch.launch.mesh.shard`,
    ``batch_pspecs`` and :func:`make_comm` read.  ``axes(rank)`` gives
    the rank's :class:`CostAxis` objects."""

    substrate = "abstract"
    device = META

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        self.shape = tuple(int(n) for n in shape)
        self.names = tuple(names)
        self.size = math.prod(self.shape)
        self.groups = mesh_groups(self.shape, self.names)

    def coord(self, rank: int) -> Dict[str, int]:
        out, r = {}, rank
        for name, n in reversed(list(zip(self.names, self.shape))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.names}

    def axes(self, rank: int) -> Dict[str, "CostAxis"]:
        c = self.coord(rank)
        return {name: CostAxis(n, c[name], name)
                for name, n in zip(self.names, self.shape)}


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") across pods (``repro/launch/mesh.py:31``)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


class _Done:
    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class CostAxis(Axis):
    """A shape-only axis: each collective returns a fresh meta tensor of
    its exact output shape (and :class:`Axis` records the call)."""

    def __init__(self, size: int, index: int, name: str = "axis"):
        self.size = size
        self.index = index
        self.name = name
        self.device = META

    def ppermute_start(self, x, perm, *, channel=None):
        return _Done(torch.empty_like(x, memory_format=torch.contiguous_format))

    def all_gather(self, x, axis: int = 0):
        shape = list(x.shape)
        shape[axis] *= self.size
        return x.new_empty(shape)

    def psum(self, x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def pmax(self, x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def psum_scatter(self, x, dim: int = 0):
        if x.shape[dim] % self.size:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not divide over {self.size} ranks")
        shape = list(x.shape)
        shape[dim] //= self.size
        return x.new_empty(shape)

    def all_to_all_n(self, xs, split_axis: int, concat_axis: int, *,
                     channels=None):
        out = []
        for x in xs:
            if x.shape[split_axis] % self.size:
                raise ValueError(f"all_to_all: split axis {split_axis} "
                                 f"does not divide over {self.size} ranks")
            shape = list(x.shape)
            shape[split_axis] //= self.size
            shape[concat_axis] *= self.size
            out.append(x.new_empty(shape))
        return out


# ---------------------------------------------------------------------------
# abstract inputs per cell
# ---------------------------------------------------------------------------

def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def input_specs(cfg: ModelConfig, shape, mesh) -> Tuple[Dict, Dict]:
    """Meta stand-ins + specs for the batch of one cell (whisper's frames
    padded to a multiple of 16: they shard over the model axis)."""
    s, b = shape.seq_len, shape.global_batch
    kind = shape.kind
    specs = batch_pspecs(cfg, kind, mesh, batch=b)
    batch: Dict[str, Any] = {}
    i32 = dict(dtype=torch.int32, device=META)
    if kind == "decode":
        batch["tokens"] = torch.empty((b,), **i32)
    else:
        batch["tokens"] = torch.empty((s, b), **i32)
        if kind == "train":
            batch["labels"] = torch.empty((s, b), **i32)
    if cfg.family == "vlm" and kind != "decode":
        batch["image_embeds"] = torch.empty(
            (cfg.n_image_tokens, b, cfg.d_model), dtype=cfg.dtype,
            device=META)
    if cfg.is_encdec and kind != "decode":
        batch["frames"] = torch.empty(
            (_pad_to(cfg.n_audio_frames, 16), b, cfg.d_model),
            dtype=cfg.dtype, device=META)
    specs = {k: v for k, v in specs.items() if k in batch}
    return batch, specs


def n_memory_tokens(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.n_image_tokens
    if cfg.is_encdec:
        return _pad_to(cfg.n_audio_frames, 16)
    return 0


# ---------------------------------------------------------------------------
# collective accounting (the reference's ``collective_stats``, from the
# recorded calls)
# ---------------------------------------------------------------------------

def collective_stats(costs: Costs) -> Dict[str, Any]:
    """``n_ops``, ``by_kind`` (XLA's kind names: ``{"count",
    "xfer_bytes"}``) and ``total_xfer_bytes`` of the recorded calls, under
    the per-op ring models of ``repro/launch/dryrun.py::collective_stats``
    (collective-permute: the operand; all-gather: result·(P-1)/P;
    reduce-scatter: result·(P-1); all-reduce: 2·result·(P-1)/P;
    all-to-all: result·(P-1)/P)."""
    by: Dict[str, Dict[str, float]] = {}
    for kind, op in costs.coll_ops.items():
        k = by.setdefault(XLA_KIND[kind], {"count": 0, "xfer_bytes": 0.0})
        k["count"] += op["count"]
        k["xfer_bytes"] += op["xfer_bytes"]
    return {"n_ops": sum(k["count"] for k in by.values()), "by_kind": by,
            "total_xfer_bytes": sum(k["xfer_bytes"] for k in by.values())}


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map2(lambda t, _: out.append(t) if isinstance(t, torch.Tensor)
              else t, tree, None)
    return out


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``
    (dicts, lists, tuples, dataclasses)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def cell_config(arch, *, fsdp: bool = True, tp_mlp: bool = True,
                pad_heads: bool = False) -> ModelConfig:
    """``get_config(arch)`` (or ``arch`` itself, a :class:`ModelConfig`)
    with the reference's variant knobs applied
    (``pad_heads``: head counts padded to the model axis' width, so the
    attention and SSD branches shard instead of replicating)."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if pad_heads:
        def _pad(n, t):
            return ((n + t - 1) // t) * t
        t = cfg.tp_target
        updates = {"n_heads": _pad(cfg.n_heads, t),
                   "n_kv_heads": _pad(cfg.n_kv_heads, t // 2)}
        if cfg.ssm_state and cfg.ssm_heads % t:
            updates["ssm_headdim"] = cfg.ssm_d_inner // _pad(cfg.ssm_heads,
                                                             t)
        cfg = dataclasses.replace(cfg, **updates)
    if not fsdp:
        cfg = dataclasses.replace(cfg, fsdp_params=False)
    if not tp_mlp:
        cfg = dataclasses.replace(cfg, tp_mlp=False)
    return cfg


def _shape(shape_name):
    return SHAPES[shape_name] if isinstance(shape_name, str) else shape_name


def build_cell(arch, shape_name, mesh: AbstractMesh,
               mode: CommMode, *, remat: bool = True, tp2d: bool = False,
               fsdp: bool = True, tp_mlp: bool = True,
               wire_bf16: bool = False, pad_heads: bool = False,
               rank: int = 0):
    """Returns ``(fn, args)``: rank ``rank``'s step closure and its
    abstract arguments, the rank's meta shards cut by the params'
    ``ParamSpec.pspec()``, the train state's specs, ``batch_pspecs`` and
    ``cache_pspecs``.  train: ``make_train_step`` on the sharded state
    (through the rank's tape at tp > 1); prefill: ``make_prefill_step``;
    decode: ``make_serve_step`` (``joint_kv`` at batch 1, ``tp2d`` on
    request).  ``arch`` may be a :class:`ModelConfig` and ``shape_name``
    a :class:`~repro_torch.configs.Shape`."""
    cfg = cell_config(arch, fsdp=fsdp, tp_mlp=tp_mlp, pad_heads=pad_heads)
    shape = _shape(shape_name)
    model = build_model(cfg, device=META)
    comm = make_comm(mesh, mesh.axes(rank),
                     CommConfig(mode=mode, wire_bf16=wire_bf16),
                     fsdp=cfg.fsdp_params)
    daxes = data_axes(mesh)
    dspec = daxes[0] if len(daxes) == 1 else daxes
    params_abs, specs = model.abstract_params()
    param_pspecs = tree_map(lambda sp: sp.pspec(data_axis=dspec), specs)
    batch_abs, bspecs = input_specs(cfg, shape, mesh)
    batch = shard(mesh, batch_abs, bspecs, rank)

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        state_abs = TrainState(params_abs, adamw_init(params_abs, opt_cfg))
        state_specs = TrainState(param_pspecs, OptState(
            P(), param_pspecs, param_pspecs, param_pspecs))
        state = shard(mesh, state_abs, state_specs, rank)
        step = make_train_step(model, specs, opt_cfg, comm, remat=remat)
        return step, (state, batch)

    params = shard(mesh, params_abs, param_pspecs, rank)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, comm), (params, batch)

    b = shape.global_batch
    joint = b == 1
    serve = make_serve_step(cfg, comm, joint_kv=joint, tp2d=tp2d)
    cache_abs = init_cache(cfg, shape.seq_len, b,
                           n_memory=n_memory_tokens(cfg), device=META)
    cspecs = cache_pspecs(cfg, batch=b, data_axis=daxes, tp2d=tp2d)
    cache = shard(mesh, cache_abs, cspecs, rank)
    tok_spec = P() if (joint or tp2d) else P(dspec)
    tokens = shard(mesh, torch.empty((b,), dtype=torch.int32, device=META),
                   tok_spec, rank)
    return serve, (params, cache, tokens)


def local_cell(arch, shape_name, *, device, remat: bool = True,
               seed: int = 0):
    """One rank with a local Comm (a (1, 1) mesh: every collective the
    identity): ``(fn, args)`` of the cell's step of ``arch`` (a name or a
    :class:`ModelConfig`) on ``device``.  On ``"meta"`` the params and
    inputs are shapes alone; elsewhere the params are drawn from ``seed``
    and the tokens from ``seed`` too.  Both devices run the same code, so
    a :class:`~repro_torch.launch.costs.CostCounter` counts the same work
    on each: the dry run held against a card."""
    from ..distributed.comm import local_comm
    cfg = cell_config(arch)
    shape = _shape(shape_name)
    dev = torch.device(device)
    model = build_model(cfg, device=dev)
    if dev.type == "meta":
        params, specs = model.abstract_params()
        tok = torch.empty((shape.seq_len, shape.global_batch),
                          dtype=torch.int32, device=META)
    else:
        params, specs = model.init(seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = torch.randint(0, cfg.vocab, (shape.seq_len,
                                           shape.global_batch),
                            generator=gen, device=dev, dtype=torch.int32)
    if cfg.family == "vlm" or cfg.is_encdec:
        raise ValueError(f"local_cell: {cfg.name}'s steps need a memory "
                         "(image embeddings or frames)")
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        state = TrainState(params, adamw_init(params, opt_cfg))
        step = make_train_step(model, specs, opt_cfg, local_comm(),
                               remat=remat)
        return step, (state, {"tokens": tok, "labels": tok.clone()})
    if shape.kind == "prefill":
        return make_prefill_step(cfg, local_comm()), (params,
                                                      {"tokens": tok})
    raise ValueError(f"local_cell: no {shape.kind} cell")


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape, n_dev: int) -> float:
    """The reference's useful FLOPs a device: 6 N T (train), 2 N T
    (prefill), 2 N b (decode), N the active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch / n_dev
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch / n_dev
    return 2.0 * n * shape.global_batch / n_dev


def roofline(costs: Costs, cfg: ModelConfig, shape, n_dev: int
             ) -> Dict[str, Any]:
    """The reference's roofline terms over the H100's data-sheet peaks
    (:mod:`.costs`): compute at the config dtype's peak, memory over
    HBM3, the busier link direction over one direction of NVLink 4."""
    t_c = costs.flops / PEAK_FLOPS.get(str(cfg.dtype).split(".")[-1],
                                       PEAK_FLOPS["bfloat16"])
    t_m = costs.dot_bytes / HBM_BYTES_PER_S
    t_l = costs.link_bytes / LINK_BYTES_PER_S
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_l),
              key=lambda kv: kv[1])
    phase_cm = max(t_c, t_m)
    bsp_bound = phase_cm + t_l
    lci_bound = max(phase_cm, t_l)
    mf = model_flops(cfg, shape, n_dev)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_l,
        "dominant": dom[0], "bound_s": dom[1],
        "bsp_bound_s": bsp_bound, "lci_bound_s": lci_bound,
        "overlap_speedup": bsp_bound / max(lci_bound, 1e-12),
        "model_flops_per_device": mf,
        "useful_flop_ratio": mf / max(costs.flops, 1.0),
        "roofline_fraction": (t_c / lci_bound if lci_bound > 0 else 0.0),
    }


def trace_cell(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` under a counter; returns the costs and the
    memory figures: ``argument_size_in_bytes`` (the distinct storages of
    the arguments), ``output_size_in_bytes`` (of the outputs),
    ``alias_size_in_bytes`` (the argument storages the step wrote in
    place: a train state, a decode cache), ``temp_size_in_bytes`` (the
    peak of the live bytes of every storage created during the step: the
    peak above the arguments) and ``unused_argument_bytes`` (the argument
    storages the step never touched: XLA prunes such arguments from the
    reference's compiled step)."""
    arg_tensors = _tensors(args)
    t0 = time.perf_counter()
    with CostCounter() as counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    return {"costs": counter.costs, "trace_s": trace_s,
            "argument_size_in_bytes": storage_bytes(args),
            "output_size_in_bytes": storage_bytes(out),
            "temp_size_in_bytes": counter.peak_bytes,
            "alias_size_in_bytes": counter.written(arg_tensors),
            "unused_argument_bytes": counter.unused(arg_tensors)}


def cell_tag(arch: str, shape_name: str, mesh_name: str, mode: CommMode, *,
             tp2d=False, fsdp=True, tp_mlp=True, wire_bf16=False,
             pad_heads=False) -> str:
    variant = ("+tp2d" if tp2d else "") + ("" if fsdp else "+nofsdp") \
        + ("" if tp_mlp else "+notpmlp") \
        + ("+wirebf16" if wire_bf16 else "") \
        + ("+padheads" if pad_heads else "")
    return f"{arch}__{shape_name}__{mesh_name}__{mode.value}{variant}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: CommMode,
             *, remat: bool = True, save: bool = True, tp2d: bool = False,
             fsdp: bool = True, tp_mlp: bool = True,
             wire_bf16: bool = False, pad_heads: bool = False,
             mesh: Optional[AbstractMesh] = None,
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Trace one cell and write its artifact (the reference's keys; see
    :data:`NO_COUNTERPART` for the three torch has no value for).
    ``flops_per_device`` and ``analytic`` are the counter's;
    ``bytes_accessed_per_device`` the bytes every non-view op reads and
    writes (each tensor argument and output counted whole, a kernel by
    its formula's bytes); ``mesh`` (default: the production mesh) may be
    any :class:`AbstractMesh`."""
    cfg = cell_config(arch, fsdp=fsdp, tp_mlp=tp_mlp, pad_heads=pad_heads)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    tag = cell_tag(arch, shape_name, mesh_name, mode, tp2d=tp2d, fsdp=fsdp,
                   tp_mlp=tp_mlp, wire_bf16=wire_bf16, pad_heads=pad_heads)
    if not ok:
        art = {"cell": tag, "status": "skipped", "reason": why}
        if save:
            _save(tag, art, out_dir)
        print(f"[dryrun] {tag}: SKIP ({why})")
        return art

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    fn, args = build_cell(arch, shape_name, mesh, mode, remat=remat,
                          tp2d=tp2d, fsdp=fsdp, tp_mlp=tp_mlp,
                          wire_bf16=wire_bf16, pad_heads=pad_heads)
    got = trace_cell(fn, args)
    costs = got["costs"]
    coll = collective_stats(costs)
    art: Dict[str, Any] = {
        "cell": tag, "status": "ok",
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": mode.value, "n_devices": mesh.size,
        "lower_s": None, "compile_s": None,
        "trace_s": round(got["trace_s"], 2),
        "flops_per_device": costs.flops,
        "bytes_accessed_per_device": costs.bytes_accessed,
        "collectives": coll,
        "n_collective_ops": coll["n_ops"],
        # the architecture's counts, as the reference reports them (the
        # padded heads of pad_heads are not the model's params)
        "params": get_config(arch).param_count(),
        "active_params": get_config(arch).active_param_count(),
        "analytic": costs.as_dict(),
        "roofline": roofline(costs, cfg, shape, mesh.size),
        "argument_size_in_bytes": got["argument_size_in_bytes"],
        "output_size_in_bytes": got["output_size_in_bytes"],
        "temp_size_in_bytes": got["temp_size_in_bytes"],
        "generated_code_size_in_bytes": None,
        "alias_size_in_bytes": got["alias_size_in_bytes"],
        "unused_argument_bytes": got["unused_argument_bytes"],
        "no_counterpart": NO_COUNTERPART,
        "device": "meta",
    }
    if save:
        _save(tag, art, out_dir)
    print(f"[dryrun] {tag}: OK  trace={got['trace_s']:.1f}s"
          f" flops/dev={costs.flops:.3g}"
          f" coll_bytes/dev={coll['total_xfer_bytes']:.3g}")
    return art


def _save(tag: str, art: Dict, out_dir: Optional[str] = None) -> None:
    d = out_dir or ART_DIR
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, tag + ".json"), "w") as f:
        json.dump(art, f, indent=1)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _run_one(job) -> Tuple[str, str]:
    """One cell of :func:`run_all` (a worker process' entry): (tag,
    status)."""
    arch, shape_name, mesh_name, mode_value, remat, out_dir = job
    mode = parse_mode(mode_value)
    tag = cell_tag(arch, shape_name, mesh_name, mode)
    try:
        art = run_cell(arch, shape_name, mesh_name == "multi", mode,
                       remat=remat, out_dir=out_dir)
        return tag, art["status"]
    except Exception as e:                       # recorded, the run goes on
        print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
        _save(tag, {"cell": tag, "status": "failed", "error": repr(e)},
              out_dir)
        return tag, "failed"


def run_all(mesh_names: Sequence[str], mode: CommMode, *,
            remat: bool = True, force: bool = False,
            out_dir: Optional[str] = None, jobs: int = 1) -> Dict[str, Any]:
    """Every cell of ``cells()`` on each of the production meshes named in
    ``mesh_names`` (``"single"``, ``"multi"``); ``jobs`` > 1 traces the
    cells in that many worker processes (the port has no device count to
    lock).  An existing ok / skipped artifact is kept unless ``force``.
    Returns ``{mesh name: {"ok", "skipped", "failed": [tags]}}`` and
    ``"seconds"``."""
    t0 = time.perf_counter()
    got: Dict[str, Any] = {m: {"ok": [], "skipped": [], "failed": []}
                           for m in mesh_names}
    d = out_dir or ART_DIR
    todo = []
    for mesh_name in mesh_names:
        for arch, shape_name, _, _ in cells():
            tag = cell_tag(arch, shape_name, mesh_name, mode)
            path = os.path.join(d, tag + ".json")
            if os.path.exists(path) and not force:
                with open(path) as f:
                    st = json.load(f).get("status")
                if st in ("ok", "skipped"):
                    print(f"[dryrun] {tag}: cached ({st})")
                    got[mesh_name][st].append(tag)
                    continue
            todo.append((arch, shape_name, mesh_name, mode.value, remat,
                         out_dir))
    # the long traces first, so the workers finish together
    todo.sort(key=lambda j: (SHAPES[j[1]].kind != "train",
                             SHAPES[j[1]].kind != "prefill"))
    if jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")
                                 ) as pool:
            results = list(pool.map(_run_one, todo))
    else:
        results = [_run_one(j) for j in todo]
    for (_, _, mesh_name, _, _, _), (tag, status) in zip(todo, results):
        got[mesh_name][status].append(tag)
    got["seconds"] = time.perf_counter() - t0
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--mode", default="lci_dedicated")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tp2d", action="store_true",
                    help="2D-TP weight-stationary serving (decode cells)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate weights over data (small models)")
    ap.add_argument("--no-tp-mlp", action="store_true",
                    help="SP-only MLP: replicate d_ff over model")
    ap.add_argument("--wire-bf16", action="store_true",
                    help="bf16 ring accumulators (fp32 local adds)")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad head counts to shard over the model axis")
    ap.add_argument("--all", action="store_true",
                    help="run every cell of the mesh (--mesh both: of both)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: trace in this many worker processes")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells with existing artifacts")
    ap.add_argument("--out", metavar="DIR",
                    help="write artifacts to DIR (default build/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    mode = parse_mode(args.mode)
    if args.all:
        names = ("single", "multi") if args.mesh == "both" else (args.mesh,)
        got = run_all(names, mode, remat=not args.no_remat,
                      force=args.force, out_dir=args.out, jobs=args.jobs)
        failed = []
        for m in names:
            print(f"[dryrun] {m}: {len(got[m]['ok'])} ok, "
                  f"{len(got[m]['skipped'])} skipped, "
                  f"{len(got[m]['failed'])} failed")
            failed += got[m]["failed"]
        print(f"[dryrun] {got['seconds']:.1f} s")
        if failed:
            print(f"[dryrun] FAILURES: {failed}")
            return 1
        print("[dryrun] all cells OK")
        return 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    if args.mesh == "both":
        ap.error("--mesh both goes with --all")
    run_cell(args.arch, args.shape, args.mesh == "multi", mode,
             remat=not args.no_remat, tp2d=args.tp2d, fsdp=not args.no_fsdp,
             tp_mlp=not args.no_tp_mlp, wire_bf16=args.wire_bf16,
             pad_heads=args.pad_heads, out_dir=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
