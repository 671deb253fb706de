"""Mixture-of-Experts — MoE dispatch as an LCI active-message system (port).

The mirror of :mod:`repro.models.moe` (the mapping is in its docstring):
a token's choice of expert ``e`` is an active message tagged ``e``; the
matching engine is the rank-within-expert slot assignment; each expert
exposes ``capacity`` fixed packet slots and a message that finds them
full is dropped into the backlog ledger (``dropped_frac``) and rides the
residual stream; the all-to-all is the progress engine's flush
(``comm.a2a``, the identity at one rank); the combine is the completion,
joining each token's top-k replies weighted by its router probabilities.

The expert FFN goes through :func:`repro_torch.kernels.moe_gmm.moe_gmm`:
the hand-written Hopper kernel for CUDA tensors, its plain version for
CPU tensors, told each expert's filled slots (``rows``) so that it skips
the empty ones.  The plain version and the kernel's float32 variant keep
``h`` in float32 between the two products, where the reference's einsums
round it to x's dtype, as the kernel's bf16 tensor-core variant does; in
float32 the two are the same function.

No step reads anything back to the host: the capacity is a Python int of
the token count, the dispatch scatter and the combine gather are index
operations on the card.

Telemetry (the process-wide hub, :mod:`repro_torch.core.telemetry`):
spans ``moe.router``, ``moe.slots``, ``moe.dispatch``, ``moe.experts``
and ``moe.combine``; at ``counters`` level the counters
``moe.slots_allotted`` (E·cap), a host int, and ``moe.slots_filled``
(the filled slots, ``moe_gmm``'s rows) and ``moe.dropped`` (the
messages that found their expert full), summed on the device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.telemetry import active
from ..kernels.moe_gmm import moe_gmm
from .common import ModelConfig, ParamFactory


def init_moe(pf: ParamFactory, cfg: ModelConfig, stacked_layers: int = 0
             ) -> Dict[str, torch.Tensor]:
    """The router and the stacked expert weights, drawn in the
    reference's order."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    mult = 2 if cfg.mlp in ("swiglu", "geglu") else 1
    L = (stacked_layers,) if stacked_layers else ()
    st = bool(stacked_layers)
    return {
        "router": pf.dense("router", L + (d, e), tp_axis=None, fsdp_axis=0,
                           stacked=st, scale=0.1),
        # expert weights: EP on the expert dim, FSDP on d_model
        "we_in": pf.dense("we_in", L + (e, d, mult * ff), tp_axis=0,
                          fsdp_axis=1, stacked=st),
        "we_out": pf.dense("we_out", L + (e, ff, d), tp_axis=0,
                           fsdp_axis=2, stacked=st),
    }


def router_topk(logits: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Top-k routing with aux losses.

    logits: (T, E) float32.  Returns (weights (T, k) float32, experts
    (T, k) int64, probs (T, E), aux: dict of scalar losses).  Ties go to
    the lower expert id, as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` leaves the tie order unspecified)."""
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[:, :cfg.top_k]
    experts = top.indices[:, :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)           # renormalize top-k
    # Switch-style load-balance loss over all k assignments
    e = logits.shape[-1]
    ids = torch.arange(e, device=logits.device)
    assign = (experts[..., None] == ids).float().sum(dim=1)   # (T, E)
    f = assign.mean(dim=0) * e / cfg.top_k               # dispatch fraction
    p_mean = probs.mean(dim=0) * e
    aux_lb = (f * p_mean).mean()
    lse = torch.logsumexp(logits, dim=-1)
    aux_z = (lse * lse).mean()
    return weights.float(), experts, probs, {"aux_lb": aux_lb,
                                             "aux_z": aux_z}


def capacity(t: int, cfg: ModelConfig) -> int:
    """Packet slots per expert for ``t`` local tokens: ceil(t·k/E · cf),
    rounded up to a multiple of 8, at least 8 (Python ints, exactly as
    the reference computes them)."""
    cap = int(-(-t * cfg.top_k // cfg.n_experts) * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
              comm) -> Tuple[torch.Tensor, Dict]:
    """x: (s_local, b, d) pre-normed.  Returns (out (s_local, b, d), aux).

    Capacity per (expert, source rank) is :func:`capacity` of the local
    token count: fixed-size packet slots, so the a2a payload has a static
    shape (the paper's fixed-size pre-registered packets)."""
    s_l, b, d = x.shape
    t = s_l * b
    e, k = cfg.n_experts, cfg.top_k
    tp = comm.tp
    assert e % tp == 0, f"experts {e} must divide over model axis {tp}"

    tele = active()
    with tele.span("moe.router"):
        xf = x.reshape(t, d)
        router_w = comm.weight(p["router"], fsdp_axis=0)
        logits = torch.matmul(xf.float(), router_w.float())
        weights, experts, _, aux = router_topk(logits, cfg)
        cap = capacity(t, cfg)

    # -- matching engine: slot assignment (position of each msg in its
    #    expert's packet queue, in token-major order).  The reference
    #    takes a cumsum down the (T·k, E) one-hot; a stable sort by tag
    #    gives the same ranks (each expert's messages keep their order)
    #    without the (T·k, E) scan, a slow outer-dimension scan on the
    #    card (PERF.md) -----------------------------------------------------
    with tele.span("moe.slots"):
        flat_e = experts.reshape(t * k)                  # message tags
        order = torch.argsort(flat_e, stable=True)
        count = torch.zeros(e, dtype=flat_e.dtype, device=x.device)
        count.scatter_add_(0, flat_e, torch.ones_like(flat_e))
        first = torch.cumsum(count, 0) - count           # expert's 1st slot
        pos = torch.empty_like(flat_e)
        pos[order] = (torch.arange(t * k, device=x.device)
                      - first[flat_e[order]])
        keep = pos < cap                                 # packet available?
        filled = count.clamp(max=cap)                    # each expert's rows
        dropped = (~keep).sum()
        aux["dropped_frac"] = dropped.float() / (t * k)  # backlog ledger
        if tele.counters_on:
            tele.add("moe.slots_allotted", e * cap)
            tele.add_device("moe.slots_filled", filled.sum())
            tele.add_device("moe.dropped", dropped)

    # -- stage payloads into packet slots: (E, cap, d).  Kept messages own
    #    distinct slots; dropped ones all write one spare row past the
    #    last slot, which is cut off (the reference adds a zero payload
    #    into slot (0, 0) instead) ------------------------------------------
    with tele.span("moe.dispatch"):
        slot = torch.where(keep, flat_e * cap + pos,
                           torch.full_like(pos, e * cap))
        staged = torch.zeros((e * cap + 1, d), dtype=x.dtype,
                             device=x.device)
        staged[slot] = torch.repeat_interleave(xf, k, dim=0)
        dispatch = staged[:e * cap].view(e, cap, d)
        # -- progress: flush aggregated messages (all-to-all over EP axis)
        recv = comm.a2a(dispatch, split_axis=0, concat_axis=1)

    # -- expert compute: the grouped-matmul kernel over local experts ------
    with tele.span("moe.experts"):
        we_in = comm.weight(p["we_in"], fsdp_axis=1)     # (E_l, d, m·ff)
        we_out = comm.weight(p["we_out"], fsdp_axis=2)   # (E_l, ff, d)
        # each expert's filled slots, so the kernel skips the empty ones;
        # with one rank (comm.a2a the identity) they are this rank's own
        # counts
        rows = filled.int() if tp == 1 else None
        out = moe_gmm(recv.contiguous(), we_in.contiguous(),
                      we_out.contiguous(), act=cfg.mlp, rows=rows)

    # -- completion: return replies, combine with synchronizer weights -----
    with tele.span("moe.combine"):
        back = comm.a2a(out, split_axis=1, concat_axis=0)  # (E, cap, d)
        gathered = back.reshape(e * cap, d)[torch.where(keep, slot, 0)]
        gathered = torch.where(keep[:, None], gathered,
                               gathered.new_zeros(()))
        combined = (gathered.reshape(t, k, d).float()
                    * weights[..., None]).sum(dim=1)
        return combined.reshape(s_l, b, d).to(x.dtype), aux
