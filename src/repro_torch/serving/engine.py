"""Serving engine: prefill and single-token decode, dense and moe (port).

The mirror of :mod:`repro.serving.engine` at tp = dp = 1.

Cache layout (the reference's global view)::

    k/v  (L, S, B, n_kv, dh)     cfg.dtype, on the model's device

Differences from the reference, by design:

* The decode step writes the new K/V rows into the cache **in place**
  (the reference returns an updated copy); the returned
  :class:`DecodeCache` shares the tensors and carries ``length + 1``.
* ``DecodeCache.length`` is a host int, so no decode step reads anything
  back from the card until the sampled tokens are wanted.
* ``tp2d``, ``joint_kv`` and every family but dense and moe raise "not
  ported" (ROADMAP.md); so do the cross-attention caches.

Per decode step the RMSNorm kernel runs 4 times a layer (norm1, q_norm,
k_norm, norm2 on gemma3 and olmoe) plus once for the final norm; the
decode attention itself is plain PyTorch, as the reference has no Pallas
kernel for it.  A moe layer routes the step's b tokens through
:func:`~repro_torch.models.moe.moe_block` (one MoE grouped-matmul kernel
launch a layer; capacity from T = b) and adds the shared expert, if any,
through the plain MLP.  Prefill is the full-sequence forward, so it also
runs the flash-attention kernel once a layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.runtime import resolve_device
from ..distributed.comm import Comm, local_comm
from ..models import lm as lm_mod
from ..models.attention import combine_decode_partials, decode_attention
from ..models.blocks import TPPlan, layer_window, tp_plan
from ..models.common import ModelConfig
from ..models.layers import (apply_norm, apply_rope, gated_activation,
                             greedy_sample, lm_head_logits,
                             mlp_activation, rms_norm, vocab_rows)
from ..models.moe import moe_block


# ---------------------------------------------------------------------------
# cache container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    k: Optional[torch.Tensor] = None         # (L, S, b, n_kv, dh)
    v: Optional[torch.Tensor] = None
    length: int = 0                          # valid positions (host int)


def init_cache(cfg: ModelConfig, seq_len: int, batch: int, *,
               device=None) -> DecodeCache:
    """A zeroed cache of ``seq_len`` positions for ``batch`` sequences on
    ``device`` (default ``cuda``)."""
    lm_mod.require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, seq_len, batch, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return DecodeCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       length=0)


# ---------------------------------------------------------------------------
# decode helpers
# ---------------------------------------------------------------------------

def _embed_flat(tokens: torch.Tensor, emb: torch.Tensor, comm: Comm, *,
                scale: bool) -> torch.Tensor:
    """tokens (b,) -> (b, d) in emb's dtype."""
    out = comm.psum_model(vocab_rows(tokens, emb, comm.model_index()))
    if scale:
        out = out * math.sqrt(out.shape[-1])
    return out.to(emb.dtype)


def _decode_attn_layer(x, lp, cfg: ModelConfig, comm: Comm, plan: TPPlan,
                       k_cache, v_cache, pos: int, window: int):
    """One attention layer for a single token.  x (b, d); k/v_cache
    (S, b, n_kv, dh), written in place at ``pos``.  Returns (b, d)."""
    dh = cfg.resolved_head_dim
    nq, nkv = plan.q_local(cfg), plan.kv_local(cfg)
    b = x.shape[0]
    q = torch.matmul(x, comm.weight(lp["wq"], fsdp_axis=0)).reshape(b, nq, dh)
    k_new = torch.matmul(x, comm.weight(lp["wk"], fsdp_axis=0)
                         ).reshape(b, nkv, dh)
    v_new = torch.matmul(x, comm.weight(lp["wv"], fsdp_axis=0)
                         ).reshape(b, nkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k_new = rms_norm(k_new, lp["k_norm"])
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q[None], posv, cfg.rope_theta)[0]
    k_new = apply_rope(k_new[None], posv, cfg.rope_theta)[0]
    if pos < k_cache.shape[0]:        # past the end the reference drops it
        k_cache[pos] = k_new.to(k_cache.dtype)
        v_cache[pos] = v_new.to(v_cache.dtype)
    num, m, l = decode_attention(q, k_cache, v_cache, valid_len=pos + 1,
                                 kv_offset=0, window=window, q_pos=pos)
    attn = combine_decode_partials(num, m, l, comm)
    attn = attn.reshape(b, nq * dh).to(x.dtype)
    return torch.matmul(attn, comm.weight(lp["wo"], fsdp_axis=1))


def _decode_mlp(x, lp, cfg: ModelConfig, comm: Comm, prefix: str = ""
                ) -> torch.Tensor:
    def w(name, fsdp_axis):
        return comm.weight(lp[prefix + name], fsdp_axis=fsdp_axis)

    if cfg.mlp in ("swiglu", "geglu"):
        h = gated_activation(cfg.mlp, torch.matmul(x, w("w_gate", 0)),
                             torch.matmul(x, w("w_up", 0)))
    else:
        h = mlp_activation(cfg.mlp, torch.matmul(x, w("w_in", 0)))
    return torch.matmul(h, w("w_out", 1))


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, comm: Optional[Comm] = None, *,
                    joint_kv: bool = False, tp2d: bool = False):
    """Build ``serve_step(params, cache, tokens) -> (next_tokens, cache')``.

    tokens: (b,) ints (a tensor or numpy) — the tokens decoded at
    position ``cache.length``; returns the greedily sampled next tokens,
    (b,) int32 on the model's device, and the cache with ``length + 1``
    (its K/V tensors updated in place)."""
    lm_mod.require_ported(cfg, "make_serve_step")
    if joint_kv or tp2d:
        raise NotImplementedError("make_serve_step: joint_kv and tp2d "
                                  "serving are not ported (ROADMAP A7)")
    comm = comm or local_comm()
    plan = tp_plan(cfg, comm.tp)
    final_kind = lm_mod.final_norm_kind(cfg)

    @torch.no_grad()
    def serve_step(params, cache: DecodeCache, tokens):
        pos = cache.length
        emb = comm.weight(params["emb"], fsdp_axis=1)
        tokens = torch.as_tensor(tokens, device=emb.device)
        x = _embed_flat(tokens, emb, comm,
                        scale=cfg.name.startswith("gemma"))
        for idx in range(cfg.n_layers):
            lp = lm_mod.layer_params(params, idx)
            h = apply_norm(cfg.norm, x, lp.get("norm1"))
            window = layer_window(cfg, idx) if cfg.sliding_window else 0
            a_out = _decode_attn_layer(h, lp, cfg, comm, plan, cache.k[idx],
                                       cache.v[idx], pos, window)
            if cfg.parallel_block:
                x = x + a_out + _decode_mlp(h, lp, cfg, comm)
            else:
                x = x + a_out
                h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
                if cfg.family == "moe":
                    mo = moe_block(h2[None], lp, cfg, comm)[0][0]
                    if cfg.shared_expert_ff:
                        mo = mo + _decode_mlp(h2, lp, cfg, comm,
                                              prefix="shared_")
                    x = x + mo
                else:
                    x = x + _decode_mlp(h2, lp, cfg, comm)
        x = apply_norm(final_kind, x, params["final_norm"])
        head = comm.weight(params.get("lm_head", params["emb"]),
                           fsdp_axis=1)
        logits = lm_head_logits(x, head, comm, real_vocab=cfg.vocab)
        return greedy_sample(logits, comm), DecodeCache(
            k=cache.k, v=cache.v, length=pos + 1)

    return serve_step


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, comm: Optional[Comm] = None):
    """Build ``prefill(params, batch) -> (next_tokens (b,), last_hidden
    (b, d))``: the full-sequence forward at inference, with the head on
    the last position only."""
    lm_mod.require_ported(cfg, "make_prefill_step")
    comm = comm or local_comm()

    @torch.no_grad()
    def prefill(params, batch):
        x, _ = lm_mod.forward(params, batch, cfg, comm)
        last = x[-1]                                   # (b, d)
        head = comm.weight(params.get("lm_head", params["emb"]),
                           fsdp_axis=1)
        logits = lm_head_logits(last, head, comm, real_vocab=cfg.vocab)
        return greedy_sample(logits, comm), last

    return prefill
