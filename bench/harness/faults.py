"""The control and the planted faults that a cell's limits must catch.

- The control: the configuration's reference put in the program's
  place, its linear layers' products on float8 operands (``"fp8"``):
  for a prefill cell it serves the window's calls itself; for a training
  cell its checked steps are compared with the float32 reference's.
- Faults, planted in the program's entry points: ``answer_altered`` (a
  prefill call's served token moved to the next id), ``state_unchanged``
  (a training step that computes its loss and updates nothing) and
  ``half_batch`` (a training step on the first half of the batch's rows,
  its mean over those).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from . import correct, model, runner
from . import traffic as traffic_mod


def control_prefill(ref, cfg, mode: str = "fp8") -> Callable:
    """A prefill entry that the reference module ``ref`` serves, its
    products in ``mode``."""
    m = ref.Model.of({f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})

    def prefill(params, batch):
        ref.no_tf32()
        last, logits = ref.prefill_last(params, m, batch["tokens"], mode)
        return logits.argmax(-1), last
    return prefill


def control(workload: str, seed: int, seconds: float, *, device="cuda",
            smoke: bool = False, mode: str = "fp8") -> Dict[str, float]:
    """The control's numbers on ``seed`` (``mode``: the precision of the
    products of the reference in the program's place)."""
    cell = runner.load(workload, seed, smoke=smoke)
    ref = cell.ref
    if cell.traffic["kind"] == "prefill":
        r = runner.run(workload, seed, seconds, False, device=device,
                       smoke=smoke, every=True, entries={
                           "prefill": lambda cfg: control_prefill(ref, cfg,
                                                                  mode)})
        return {k: v["value"] for k, v in r["checks"].items()}
    dev = torch.device(device)
    cfg = model.program_config(cell.config, smoke)
    m = ref.Model.of(model.model_fields(cell.config, smoke))
    params, _ = model.make_weights(cfg, seed, dev, cell.config.get("init"))
    plan = traffic_mod.plan(cell.traffic, cfg.vocab, seed, dev)
    init = dict(model.leaves(params))
    del params
    batches = [plan.batch(i)
               for i in range(int(cell.traffic.get("checked_steps", 3)))]
    ref.no_tf32()
    opt = cell.traffic["optimizer"]
    r32 = ref.train_steps(init, m, batches, opt, "f32")
    low = ref.train_steps(init, m, batches, opt, mode)
    return correct.train_numbers(low, r32)


def names(workload: str) -> List[str]:
    kind = runner.load(workload, 0).traffic["kind"]
    return ["answer_altered"] if kind == "prefill" else \
        ["state_unchanged", "half_batch"]


def entries(name: str) -> Dict[str, Callable]:
    """The program's entry points with fault ``name`` planted."""
    base = runner.default_entries()
    if name == "answer_altered":
        def make(cfg):
            fn = base["prefill"](cfg)

            def prefill(params, batch):
                tok, last = fn(params, batch)
                return (tok + 1) % cfg.vocab, last
            return prefill
        return {"prefill": make}
    if name == "state_unchanged":
        def make_train(mdl, specs, opt):
            def step(state, batch):
                with torch.no_grad():
                    loss, met = mdl.loss(state.params, batch)
                return state, met
            return step
        return {"train": make_train}
    if name == "half_batch":
        def make_half(mdl, specs, opt):
            fn = base["train"](mdl, specs, opt)

            def step(state, batch):
                half = batch["tokens"].shape[1] // 2
                return fn(state, {k: v[:, :half] for k, v in batch.items()})
            return step
        return {"train": make_half}
    raise KeyError(name)
