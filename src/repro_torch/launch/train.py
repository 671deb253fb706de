"""Training launcher (port).

    # one device, a reduced config, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 50 --device cpu

    # data parallel: 2 rank threads on one LocalCluster, the batch cut
    # over them, the gradient meaned over the data axis after backward
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 20 --mesh 2x1 --mode lci_dedicated --device cpu

The mirror of ``repro/launch/train.py`` with the reference's flags, plus
``--device {cuda,cpu}`` (default ``cuda``).  The weights are random,
drawn from seed 0; the schedule is the reference's cosine over
``--steps`` with 10 warmup steps.  ``--mesh Dx1`` runs D rank threads
(``spmd_map`` on a ``(D, 1)`` mesh): every rank holds the whole state
(no FSDP gather, so no collective inside forward or backward) and its
batch shard (:func:`repro_torch.launch.mesh.batch_pspecs`), and the
gradient is synced on the rank thread after backward.  ``--mesh DxM``
with M > 1 raises: training at tp > 1 needs autograd through the
model-axis collectives (ROADMAP A6c).  A vlm config's batches carry the
stub image embeddings (``max(n_image_tokens, 4)`` rows), an audio
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
from ..distributed.spmd_map import Mesh, P, spmd_map
from ..models.common import ModelConfig
from ..models.registry import build_model
from ..optim import AdamWConfig, cosine_schedule
from ..train import TrainState, make_train_step, train_state_init
from ..train.loop import LoopConfig, train_loop
from .mesh import batch_pspecs

#: the metrics a step returns
METRIC_KEYS = ("loss", "ce", "ntok", "aux_lb", "aux_z", "dropped_frac",
               "grad_norm")


def parse_mesh(text: str):
    """``"DxM"`` -> (D, M); raises for M > 1 (A6c)."""
    d, m = (int(x) for x in text.split("x"))
    if m > 1:
        raise NotImplementedError(
            f"--mesh {text}: tp > 1 training is not ported (A6c): it needs "
            "autograd through the model-axis collectives")
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
    """The step on every rank of a ``(D, 1)`` mesh: each rank takes its
    whole copy of the state and its batch shard (``batch``, the global
    batch, > 1 cuts a vlm or audio batch's extras over data too);
    returns rank 0's updated state (every rank's is the same) and the
    meaned metrics."""
    bspec = batch_pspecs(model.cfg, "train", mesh, batch=batch)

    def rank_step(comm, state, batch):
        comm = dataclasses.replace(comm, fsdp=False)   # replicated state
        return make_train_step(model, specs, opt, comm, remat=remat)(
            state, batch)

    return spmd_map(rank_step, mesh, in_specs=(P(), bspec),
                    out_specs=(P(), {k: P() for k in METRIC_KEYS}),
                    config=config)


def train(cfg: ModelConfig, state: TrainState, specs, *, steps: int,
          seq: int = 64, batch: int = 8, lr: float = 1e-3,
          mesh: Optional[Mesh] = None, config: Optional[CommConfig] = None,
          loop_cfg: Optional[LoopConfig] = None, remat: bool = True,
          device=None) -> List[Dict[str, Any]]:
    """The launcher's loop on ``state`` (donated): ``steps`` steps of
    ``SyntheticPipeline`` batches (seed 0), one device or every rank of
    ``mesh``; returns the history of metric rows."""
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
