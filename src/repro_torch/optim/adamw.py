"""AdamW with float32 master weights and shard-local state (the mirror of
:mod:`repro.optim.adamw`).

State tensors (``mu``, ``nu``, ``master``) mirror the parameter tree:
float32, one a param, on the param's device, so the update never
communicates; ``master`` holds the float32 copy of bf16 params.  The
arithmetic is the reference's, op for op in float32.  Unlike the
reference's functional update, :func:`adamw_update` writes the new
values into the state's and the params' own tensors and returns them:
the step donates its state, as the reference's launcher donates it to
the jitted step (``donate_argnums=(0,)``), so a step of a 1B model holds
one copy of its 14 bytes a param.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..core.tree import leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    use_master: bool = True           # fp32 master copy of bf16 params


@dataclasses.dataclass
class OptState:
    step: torch.Tensor                # () int32
    mu: Dict[str, Any]
    nu: Dict[str, Any]
    master: Optional[Dict[str, Any]]  # fp32 params (None if disabled)


def adamw_init(params: Dict[str, Any], cfg: AdamWConfig) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if cfg.use_master else None)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(leaves_with_paths(params)))[1].device)
    return OptState(step=step, mu=tree_map(zeros, params),
                    nu=tree_map(zeros, params), master=master)


def _decay_mask(path: str) -> bool:
    """No weight decay on norms, biases, scalars (standard practice)."""
    lowered = path.lower()
    return not any(t in lowered for t in
                   ("norm", "bias", "a_log", "d_skip", "gate_attn",
                    "gate_mlp"))


@torch.no_grad()
def adamw_update(grads: Dict[str, Any], state: OptState,
                 params: Dict[str, Any], cfg: AdamWConfig
                 ) -> Tuple[Dict[str, Any], OptState]:
    """One AdamW step: returns (params, state), their tensors updated in
    place (the caller's ``params`` and ``state`` are donated)."""
    step = state.step + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, sf)
    b2c = 1.0 - torch.pow(cfg.b2, sf)
    g_of = dict(leaves_with_paths(grads))
    m_of = dict(leaves_with_paths(state.mu))
    v_of = dict(leaves_with_paths(state.nu))
    w_of = dict(leaves_with_paths(state.master)) \
        if state.master is not None else None
    for path, p in leaves_with_paths(params):
        gf = g_of[path].to(torch.float32)
        m, v = m_of[path], v_of[path]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf * gf)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = (w_of[path] if w_of is not None else p).to(torch.float32)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * pf
        pf = pf - lr * upd
        if w_of is not None:
            w_of[path].copy_(pf)
        p.copy_(pf)                    # cast to the param's dtype
    state.step = step
    return params, state
