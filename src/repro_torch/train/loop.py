"""Training loop: steps, async checkpoints, straggler stats, metrics log
(the mirror of :mod:`repro.train.loop`).

The loop owns the operational behaviour: resume from the last committed
checkpoint with exact data replay (the manifest's ``next_step`` indexes
the step-indexed pipeline), async checkpointing off the critical path
(the port's :class:`CheckpointStore`, whose files either package
restores), per-step timing with z-score straggler flagging, and a
metrics CSV.  Batches come from ``pipeline.get_batch(step, device=...)``
on the state's device.  A :class:`~repro_torch.train.ShardedState` (the
launcher's mesh path) is put together for a checkpoint and cut again on
resume.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from ..checkpoint import CheckpointStore
from ..core.tree import leaves_with_paths
from ..distributed.straggler import StepTimeMonitor
from .step import ShardedState, TrainState, state_from_tree, state_tree


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    log_every: int = 10
    metrics_csv: Optional[str] = None
    resume: bool = True


def train_loop(state: TrainState, step_fn: Callable, pipeline,
               loop_cfg: LoopConfig, *,
               batch_transform: Optional[Callable] = None,
               on_step: Optional[Callable] = None):
    """Run the loop; returns (final_state, history list of metric dicts).
    ``step_fn`` donates the state it is given (the port's step updates
    it in place)."""
    sharded = isinstance(state, ShardedState)
    device = state.device if sharded else \
        leaves_with_paths(state.params)[0][1].device
    start_step = 0
    store = None
    pending_save = None
    if loop_cfg.ckpt_dir:
        store = CheckpointStore(loop_cfg.ckpt_dir)
        if loop_cfg.resume and store.latest() is not None:
            tree, manifest = store.restore(state_tree(state), device=device)
            state = state.resharded(state_from_tree(tree)) if sharded \
                else state_from_tree(tree)
            start_step = manifest["meta"].get("next_step",
                                              manifest["step"] + 1)
            print(f"[loop] resumed from step {manifest['step']}, "
                  f"continuing at {start_step}")

    monitor = StepTimeMonitor()
    history = []
    writer = None
    csv_file = None
    if loop_cfg.metrics_csv:
        os.makedirs(os.path.dirname(loop_cfg.metrics_csv) or ".",
                    exist_ok=True)
        csv_file = open(loop_cfg.metrics_csv, "a", newline="")
        writer = csv.writer(csv_file)

    for step in range(start_step, loop_cfg.total_steps):
        batch = pipeline.get_batch(step, device=device)
        if batch_transform:
            batch = batch_transform(batch, step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":      # the step's time, not its launch
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0

        flagged = monitor.record(step, dt)
        if flagged is not None:
            print(f"[straggler] step {step}: {dt * 1e3:.1f} ms "
                  f"(z={flagged.zscore:.1f}, mean={flagged.mean * 1e3:.1f})")

        row = {"step": step, "dt": dt,
               **{k: float(v) for k, v in metrics.items()}}
        history.append(row)
        if writer:
            if step == start_step:
                writer.writerow(list(row))
            writer.writerow(list(row.values()))
        if loop_cfg.log_every and step % loop_cfg.log_every == 0:
            print(f"[step {step}] loss={row.get('loss', float('nan')):.4f} "
                  f"dt={dt * 1e3:.1f}ms")
        if on_step:
            on_step(step, state, row)

        if store and loop_cfg.ckpt_every and \
                (step + 1) % loop_cfg.ckpt_every == 0:
            if pending_save is not None:
                pending_save.wait()        # the previous save first
            # save_async snapshots every tensor before it returns, so the
            # next step's in-place update cannot reach the files
            pending_save = store.save(step, state_tree(state),
                                      meta={"next_step": step + 1})

    if store:
        if pending_save is not None:
            pending_save.wait()
        store.save(loop_cfg.total_steps - 1, state_tree(state),
                   meta={"next_step": loop_cfg.total_steps}, blocking=True)
        store.gc()
    if csv_file:
        csv_file.close()
    print(f"[loop] done; straggler summary: {monitor.summary()}")
    return state, history
