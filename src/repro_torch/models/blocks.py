"""Transformer blocks: TP plans, attention ops, MLP weights.

The mirror of :mod:`repro.models.blocks`.  The tensor-parallel plans:

* Plan A (``shard_heads``) — q heads sharded over the model axis; entered
  with ``ag_matmul`` (full sequence x local heads), left with
  ``matmul_rs``.  KV is sharded too when ``n_kv % tp == 0``; otherwise
  every rank projects all kv heads, gathers them over the sequence and
  keeps the kv-head range its global q heads map to.
* Plan B (heads replicated) — q for the local sequence rows only, K/V
  projected locally and all-gathered over the sequence.

With one rank the collectives are identities and both plans compute q,
k and v for the whole sequence over all heads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .attention import flash_attention
from .common import ModelConfig, ParamFactory, shard_decisions
from .layers import apply_rope, rms_norm


@dataclasses.dataclass(frozen=True)
class TPPlan:
    tp: int
    shard_heads: bool
    shard_kv: bool
    shard_ssm_heads: bool

    def q_local(self, cfg: ModelConfig) -> int:
        return cfg.n_heads // self.tp if self.shard_heads else cfg.n_heads

    def kv_local(self, cfg: ModelConfig) -> int:
        return cfg.n_kv_heads // self.tp if self.shard_kv else cfg.n_kv_heads


def tp_plan(cfg: ModelConfig, tp: int) -> TPPlan:
    dec = shard_decisions(cfg)
    if dec["attn"] and tp > 1:
        assert cfg.n_heads % tp == 0, \
            f"{cfg.name}: heads {cfg.n_heads} sharded at init but tp={tp}"
    if dec["ssm"] and tp > 1:
        assert cfg.ssm_heads % tp == 0
    return TPPlan(tp=tp, shard_heads=dec["attn"], shard_kv=dec["kv"],
                  shard_ssm_heads=dec["ssm"])


# ---------------------------------------------------------------------------
# parameter initialization for one attention + MLP block
# ---------------------------------------------------------------------------

def init_attention(pf: ParamFactory, cfg: ModelConfig, prefix: str = "",
                   stacked_layers: int = 0) -> Dict[str, torch.Tensor]:
    """Weights for one attention op (global shapes); ``stacked_layers`` >
    0 prepends an L dim.  K and V are separate params, as in the
    reference."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    L = (stacked_layers,) if stacked_layers else ()
    st = bool(stacked_layers)
    dec = shard_decisions(cfg)
    a_shard, kv_shard = dec["attn"], dec["kv"]
    p = {
        prefix + "wq": pf.dense(prefix + "wq", L + (d, nq * dh),
                                tp_axis=1 if a_shard else None,
                                fsdp_axis=0, stacked=st),
        prefix + "wk": pf.dense(prefix + "wk", L + (d, nkv * dh),
                                tp_axis=1 if kv_shard else None,
                                fsdp_axis=0, stacked=st),
        prefix + "wv": pf.dense(prefix + "wv", L + (d, nkv * dh),
                                tp_axis=1 if kv_shard else None,
                                fsdp_axis=0, stacked=st),
        prefix + "wo": pf.dense(prefix + "wo", L + (nq * dh, d),
                                tp_axis=0 if a_shard else None,
                                fsdp_axis=1, stacked=st),
    }
    if cfg.qk_norm:
        p[prefix + "q_norm"] = pf.ones(prefix + "q_norm", L + (dh,),
                                       stacked=st)
        p[prefix + "k_norm"] = pf.ones(prefix + "k_norm", L + (dh,),
                                       stacked=st)
    return p


def init_mlp(pf: ParamFactory, cfg: ModelConfig, prefix: str = "",
             stacked_layers: int = 0, d_ff: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    L = (stacked_layers,) if stacked_layers else ()
    st = bool(stacked_layers)
    tp1 = 1 if cfg.tp_mlp else None
    tp0 = 0 if cfg.tp_mlp else None
    p = {
        prefix + "w_out": pf.dense(prefix + "w_out", L + (ff, d),
                                   tp_axis=tp0, fsdp_axis=1, stacked=st),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p[prefix + "w_gate"] = pf.dense(prefix + "w_gate", L + (d, ff),
                                        tp_axis=tp1, fsdp_axis=0,
                                        stacked=st)
        p[prefix + "w_up"] = pf.dense(prefix + "w_up", L + (d, ff),
                                      tp_axis=tp1, fsdp_axis=0, stacked=st)
    else:
        p[prefix + "w_in"] = pf.dense(prefix + "w_in", L + (d, ff),
                                      tp_axis=tp1, fsdp_axis=0, stacked=st)
    return p


# ---------------------------------------------------------------------------
# attention op (prefill / forward; decode lives in serving.engine)
# ---------------------------------------------------------------------------

def attention_op(x: torch.Tensor, p: Dict[str, torch.Tensor],
                 cfg: ModelConfig, comm, plan: TPPlan, *, window: int,
                 q_offset: int, memory: Optional[torch.Tensor] = None,
                 causal: bool = True, prefix: str = ""
                 ) -> torch.Tensor:
    """x: (s_local, b, d) pre-normed; returns (s_local, b, d)
    un-residual.  One flash-attention launch on CUDA, on the rank's
    local heads.  K and V are projected by one matmul with the local
    ``[wk | wv]`` shards, as the reference does.

    ``memory``: (t, b, d), the full-length cross-attention source
    (replicated over the model axis).  When given, K and V come from it
    (no sequence gather), RoPE is off and the kernel runs unmasked
    (``causal=False``, ``window=0``).  ``causal=False`` without memory is
    the encoder's bidirectional self-attention, RoPE on, as in the
    reference."""
    dh = cfg.resolved_head_dim
    wq = comm.weight(p[prefix + "wq"], fsdp_axis=0)
    # concat of LOCAL shards: the layout is [K_local | V_local]
    wkv = torch.cat([comm.weight(p[prefix + "wk"], fsdp_axis=0),
                     comm.weight(p[prefix + "wv"], fsdp_axis=0)], dim=1)
    wo = comm.weight(p[prefix + "wo"], fsdp_axis=1)
    is_cross = memory is not None
    kv_src = memory if is_cross else x
    nq_l, nkv_l = plan.q_local(cfg), plan.kv_local(cfg)

    if plan.shard_heads:
        # Plan A: full-sequence q for the local head shard
        q = comm.ag_matmul(x, wq)                       # (s, b, nq_l*dh)
        if plan.shard_kv and not is_cross:
            kv = comm.ag_matmul(x, wkv)                 # (s, b, 2*nkv_l*dh)
            k, v = torch.chunk(kv.reshape(*kv.shape[:-1], 2 * nkv_l, dh),
                               2, dim=-2)
        else:
            # replicated KV projection: every rank computes ALL kv heads
            # (memory needs no gather), then keeps the contiguous kv-head
            # range its GLOBAL q heads map to (GQA grouping is global,
            # not local)
            kv = torch.matmul(kv_src, wkv)
            if not is_cross:
                kv = comm.ag_seq(kv)
            kv = kv.reshape(*kv.shape[:-1], 2, nkv_l, dh)
            g_ratio = cfg.n_heads // cfg.n_kv_heads
            if nq_l >= g_ratio:
                assert nq_l % g_ratio == 0, (nq_l, g_ratio)
                cnt = nq_l // g_ratio
            else:
                assert g_ratio % nq_l == 0, (nq_l, g_ratio)
                cnt = 1
            # the reference's dynamic_slice clamps the start into range:
            # with the kv heads sharded the local shard is already the
            # range (start 0)
            start = min((comm.model_index() * nq_l) // g_ratio, nkv_l - cnt)
            kv = kv[..., start:start + cnt, :]
            k, v = kv[..., 0, :, :], kv[..., 1, :, :]
        q = q.reshape(q.shape[0], *q.shape[1:-1], nq_l, dh)
        q_off_attn = 0                                  # q covers full seq
    else:
        # Plan B: local-sequence q over all heads; KV gathered (memory:
        # already full)
        q = torch.matmul(x, wq)                         # (s_l, b, nq*dh)
        kv = torch.matmul(kv_src, wkv)
        if not is_cross:
            kv = comm.ag_seq(kv)
        q = q.reshape(*q.shape[:-1], nq_l, dh)
        k, v = torch.chunk(kv.reshape(*kv.shape[:-1], 2 * nkv_l, dh), 2,
                           dim=-2)
        q_off_attn = q_offset

    if cfg.qk_norm:
        q = rms_norm(q, p[prefix + "q_norm"])
        k = rms_norm(k, p[prefix + "k_norm"])
    if not is_cross:                                    # RoPE: self-attn
        q_pos = q_off_attn + torch.arange(q.shape[0], dtype=torch.int32,
                                          device=x.device)
        k_pos = torch.arange(k.shape[0], dtype=torch.int32,
                             device=x.device)
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal and not is_cross,
                        window=0 if is_cross else window,
                        q_offset=q_off_attn)
    o = o.reshape(*o.shape[:-2], nq_l * dh)
    if plan.shard_heads:
        return comm.matmul_rs(o, wo)                    # (s_l, b, d)
    return torch.matmul(o, wo)                          # local rows


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """Effective attention window of layer ``layer_idx`` (a host int):
    the global/local pattern as data, with a huge window (``1 << 30``)
    standing for global attention."""
    if cfg.sliding_window == 0:
        return 0
    is_global = bool(cfg.swa_every_nth_global) and \
        (layer_idx + 1) % cfg.swa_every_nth_global == 0
    is_global |= layer_idx in cfg.global_layers
    return (1 << 30) if is_global else cfg.sliding_window


def swa_attention_op(x, p, cfg, comm, plan, *, layer_idx: int, q_offset,
                     prefix: str = "") -> torch.Tensor:
    """Attention with the per-layer global/local pattern."""
    w = layer_window(cfg, layer_idx) if cfg.sliding_window else 0
    return attention_op(x, p, cfg, comm, plan, window=w,
                        q_offset=q_offset, prefix=prefix)
