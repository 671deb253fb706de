"""The comparison that decides ``correct``: the program's answers against
the plain reference's, each number against its limit.

Prefill (per sequence of the sampled calls):

- ``hidden_rel``: the largest relative distance of the program's last
  hidden state from the reference's, ||h - h_ref|| / ||h_ref||, and
  ``hidden_rel_med`` its median over the sequences;
- ``token_gap``: the widest gap by which the reference's logit of the
  token the program served lies below the reference's best logit.

Training (the first steps, which set-up drives through the window's own
step and feed):

- ``loss_rel``: the largest relative gap of a step's loss, and
  ``loss1_rel`` the first step's;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  first gradient as the optimizer takes it (program: its first moment
  over 1 - b1), against the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: the same of each parameter's change after the checked
  steps, over the leaves whose reference gradient is above a thousandth
  of the median leaf's;
- ``grad_rel``: the distance of the program's first gradient from the
  reference's over its norm, all leaves together, and ``grad_rel_med``
  the median over the leaves of each leaf's.

The limits are data: ``bench/limits/<workload>.json``.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Sequence, Tuple

import torch


def prefill_numbers(served: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    refs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> Dict[str, float]:
    """``served``: (tokens (b,), last hidden (b, d)) of each sampled call;
    ``refs``: the reference's (last hidden (b, d), logits (b, V))."""
    rels, gaps = [], []
    for (tok, last), (r_last, r_logits) in zip(served, refs):
        rel = (last.float() - r_last).norm(dim=-1) / r_last.norm(dim=-1)
        rels += rel.tolist()
        tok = tok.long()
        vocab = r_logits.shape[-1]
        if bool(((tok < 0) | (tok >= vocab)).any()):
            gaps.append(math.inf)
            continue
        got = r_logits.gather(-1, tok[:, None])[:, 0]
        gaps += (r_logits.max(-1).values - got).tolist()
    return {"hidden_rel": max(rels), "hidden_rel_med": statistics.median(rels),
            "token_gap": max(gaps)}


def _gap(prog: Dict[str, float], ref: Dict[str, float],
         keys: Sequence[str]) -> float:
    med = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in keys:
        p = prog.get(k, math.nan)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [..], "grad": {leaf: norm},
    "change": {leaf: norm}, "grad_tensors": {leaf: tensor}} (the program's
    first gradient may be on the host)."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]) or not losses:
        losses = [math.inf]
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    out = {"loss_rel": max(losses), "loss1_rel": losses[0],
           "grad_gap": _gap(prog["grad"], ref["grad"], list(ref["grad"])),
           "change_gap": _gap(prog["change"], ref["change"], moved)}
    if "grad_tensors" in prog and "grad_tensors" in ref:
        diff = base = 0.0
        rel = []
        for k, r in ref["grad_tensors"].items():
            p = prog["grad_tensors"][k].to(r.device, torch.float32)
            d = (p - r).norm().item() ** 2
            b = r.norm().item() ** 2
            diff, base = diff + d, base + b
            rel.append(math.sqrt(d / max(b, 1e-60)))
        out["grad_rel"] = math.sqrt(diff / max(base, 1e-60))
        out["grad_rel_med"] = statistics.median(rel)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Any], *,
          every: bool = False
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, value, limit)]): every number with a limit must
    be finite and at most its limit; a cell without limits is not
    correct.  The rows are the numbers compared (``every``: all the
    numbers read, those not compared with the limit NaN)."""
    checks = limits.get("checks", {})
    ok, rows = bool(checks), []
    for name, c in checks.items():
        value = numbers.get(name, math.nan)
        rows.append((name, value, c["limit"]))
        if not (math.isfinite(value) and value <= c["limit"]):
            ok = False
    if every or not checks:
        rows += [(n, v, math.nan) for n, v in numbers.items()
                 if n not in checks]
    return ok, rows
