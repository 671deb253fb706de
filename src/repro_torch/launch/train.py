"""Training launcher (port).

    # one device, a reduced config, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 50 --device cpu

    # a (data 2, model 2) mesh: 4 rank threads on one LocalCluster,
    # LCI-dedicated collectives
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 20 --mesh 2x2 --mode lci_dedicated --device cpu

The mirror of ``repro/launch/train.py`` with the reference's flags, plus
``--device {cuda,cpu}`` (default ``cuda``).  The weights are random,
drawn from seed 0; the schedule is the reference's cosine over
``--steps`` with 10 warmup steps.  ``--mesh DxM`` runs D x M rank threads
(``spmd_map`` on a ``(data D, model M)`` mesh), as the reference's
``shard_map`` step runs: FSDP over ``data`` (``Comm(...,
fsdp=cfg.fsdp_params)``: each weight gathered where it is used, its
gradient reduce-scattered back), tensor, sequence and expert
parallelism over ``model``.  The state lives as the ranks' shards
between steps (:class:`~repro_torch.train.ShardedState`, cut by
:func:`repro_torch.launch.mesh.state_pspecs`: params, master, mu and nu
by their ``ParamSpec``), the batch by
:func:`repro_torch.launch.mesh.batch_pspecs` (tokens and labels
sequence over ``model``, batch over ``data``).  Every collective of a
rank's backward runs on its rank thread
(:mod:`repro_torch.distributed.spmd_autograd`).  A vlm config's batches
carry the stub image embeddings (``max(n_image_tokens, 4)`` rows), an audio
config's the stub frames (``n_audio_frames`` rounded up to 16, at least
16), drawn per step as the reference's launcher draws them.
Checkpoint/restart: pass ``--ckpt-dir``; rerunning resumes from
the last committed step with exact data replay.

:func:`train` is the launcher's loop, callable with any config and
state.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import ARCH_NAMES, get_config, get_smoke
from ..core.attrs import parse_attr_args
from ..core.modes import _FIELD_TO_ATTR, CommConfig, parse_mode
from ..data import SyntheticPipeline, stub_frames, stub_image_embeds
from ..distributed.spmd_map import PER_RANK, Mesh, P, spmd_map
from ..models.common import ModelConfig
from ..models.registry import build_model
from ..optim import AdamWConfig, cosine_schedule
from ..train import (ShardedState, TrainState, make_train_step,
                     train_state_init)
from ..train.loop import LoopConfig, train_loop
from .mesh import batch_pspecs, state_pspecs

#: the metrics a step returns
METRIC_KEYS = ("loss", "ce", "ntok", "aux_lb", "aux_z", "dropped_frac",
               "grad_norm")


def parse_mesh(text: str):
    """``"DxM"`` -> (D, M)."""
    d, m = (int(x) for x in text.split("x"))
    return d, m


def opt_config(lr: float, steps: int) -> AdamWConfig:
    """The launcher's optimizer: AdamW under the cosine schedule with 10
    warmup steps, as the reference's launcher sets it."""
    return AdamWConfig(lr=cosine_schedule(lr, 10, steps))


def batch_extras(cfg: ModelConfig, batch: int, step: int, device
                 ) -> Dict[str, Any]:
    """The frontend stubs of a vlm or audio batch at ``step``, in
    ``cfg.dtype`` on ``device`` (the reference launcher's ``extras``)."""
    out = {}
    if cfg.family == "vlm":
        out["image_embeds"] = stub_image_embeds(
            max(cfg.n_image_tokens, 4), batch, cfg.d_model, step)
    if cfg.is_encdec:
        t = max(((cfg.n_audio_frames + 15) // 16) * 16, 16)
        out["frames"] = stub_frames(t, batch, cfg.d_model, step)
    return {k: torch.from_numpy(v).to(device=device, dtype=cfg.dtype)
            for k, v in out.items()}


def mesh_step(model, specs, opt: AdamWConfig, mesh: Mesh,
              config: CommConfig, *, batch: int, remat: bool = True):
    """The step on every rank of a ``(D, M)`` mesh, the reference's
    ``shard_map`` step: ``step(state, batch)`` takes a
    :class:`ShardedState` (each rank its shard, updated in place) and
    the global batch (cut by :func:`batch_pspecs`; ``batch``, the global
    batch size, > 1 cuts a vlm or audio batch's extras over data too),
    and returns the state and the metrics meaned over the mesh."""
    bspec = batch_pspecs(model.cfg, "train", mesh, batch=batch)

    def rank_step(comm, state, batch):
        comm = dataclasses.replace(comm, fsdp=model.cfg.fsdp_params)
        return make_train_step(model, specs, opt, comm, remat=remat)(
            state, batch)

    run = spmd_map(rank_step, mesh, in_specs=(PER_RANK, bspec),
                   out_specs=(PER_RANK, {k: P() for k in METRIC_KEYS}),
                   config=config)

    def step(state: ShardedState, batch):
        ranks, metrics = run(state.ranks, batch)
        return dataclasses.replace(state, ranks=ranks), metrics

    return step


def shard_state(state: TrainState, specs, mesh: Mesh) -> ShardedState:
    """``state`` cut over ``mesh`` by :func:`state_pspecs` (the caller
    drops the whole state)."""
    return ShardedState.cut(state, state_pspecs(specs), mesh)


def train(cfg: ModelConfig, state, specs, *, steps: int,
          seq: int = 64, batch: int = 8, lr: float = 1e-3,
          mesh: Optional[Mesh] = None, config: Optional[CommConfig] = None,
          loop_cfg: Optional[LoopConfig] = None, remat: bool = True,
          device=None) -> List[Dict[str, Any]]:
    """The launcher's loop on ``state`` (donated): ``steps`` steps of
    ``SyntheticPipeline`` batches (seed 0), one device or every rank of
    ``mesh`` (``state`` then a :class:`ShardedState` on it,
    :func:`shard_state`); returns the history of metric rows."""
    model = build_model(cfg, device=device)
    opt = opt_config(lr, steps)
    if mesh is None:
        step_fn = make_train_step(model, specs, opt, remat=remat)
    else:
        step_fn = mesh_step(model, specs, opt, mesh, config or CommConfig(),
                            remat=remat, batch=batch)
    pipe = SyntheticPipeline(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch)
    loop_cfg = loop_cfg or LoopConfig(total_steps=steps)

    def transform(b, step):
        return {**b, **batch_extras(cfg, batch, step, model.device)}
    _, hist = train_loop(state, step_fn, pipe, loop_cfg,
                         batch_transform=transform)
    return hist


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x1 => (data=2, model=1); empty = local")
    ap.add_argument("--mode", default="lci_dedicated")
    ap.add_argument("--attr", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="attribute override for the comm config "
                         "(repeatable; e.g. --attr n_channels=8)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--metrics-csv", default="")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = config = None
    if args.mesh:
        d, m = parse_mesh(args.mesh)
        attr_over = parse_attr_args(args.attr)
        fields = {f: attr_over[a] for f, a in _FIELD_TO_ATTR.items()
                  if a in attr_over}
        unused = set(attr_over) - set(_FIELD_TO_ATTR.values())
        if unused:
            raise SystemExit(
                f"--attr {sorted(unused)} are host-runtime attributes; "
                f"the trainer's comm config accepts "
                f"{sorted(_FIELD_TO_ATTR.values())}")
        config = CommConfig(**{"mode": parse_mode(args.mode), **fields})
        mesh = Mesh((d, m), ("data", "model"), device=args.device)
    elif args.attr:
        raise SystemExit("--attr tunes the mesh comm config; it needs "
                         "--mesh (single-device runs have no comm)")
    model = build_model(cfg, device=args.device)
    opt = opt_config(args.lr, args.steps)
    state, specs = train_state_init(model, 0, opt)
    if mesh is not None:
        state = shard_state(state, specs, mesh)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_dir=args.ckpt_dir or None,
                          ckpt_every=args.ckpt_every,
                          metrics_csv=args.metrics_csv or None)
    t0 = time.time()
    try:
        hist = train(cfg, state, specs, steps=args.steps, seq=args.seq,
                     batch=args.batch, lr=args.lr, mesh=mesh, config=config,
                     loop_cfg=loop_cfg, device=args.device)
    finally:
        if mesh is not None:
            mesh.close()
    dt = time.time() - t0
    print(f"[train] {cfg.name} on {model.device}: {len(hist)} steps in "
          f"{dt:.1f}s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
