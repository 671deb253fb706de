"""Serving engine: prefill and single-token decode, dense, moe, ssm and
hybrid (port).

The mirror of :mod:`repro.serving.engine` at tp = dp = 1.

Cache layout (the reference's global view)::

    k/v        (L, S, B, n_kv, dh)     cfg.dtype (every family but ssm)
    ssm_state  (L, B, H, N, P)         float32   (ssm, hybrid)
    conv_tail  (L, K-1, B, d_inner)    cfg.dtype (ssm, hybrid)

all on the model's device.  Differences from the reference, by design:

* The decode step writes the new K/V rows, the SSM state and the conv
  tail into the cache **in place** (the reference returns an updated
  copy); the returned :class:`DecodeCache` shares the tensors and carries
  ``length + 1``.
* ``DecodeCache.length`` is a host int, so no decode step reads anything
  back from the card until the sampled tokens are wanted.
* ``tp2d``, ``joint_kv`` and the vlm and audio families raise "not
  ported" (ROADMAP.md); so do the cross-attention caches.

Per decode step the RMSNorm kernel runs 4 times a layer (norm1, q_norm,
k_norm, norm2 on gemma3 and olmoe) plus once for the final norm; the
decode attention itself is plain PyTorch, as the reference has no Pallas
kernel for it.  A moe layer routes the step's b tokens through
:func:`~repro_torch.models.moe.moe_block` (one MoE grouped-matmul kernel
launch a layer; capacity from T = b) and adds the shared expert, if any,
through the plain MLP.  An ssm layer runs the mixer's one-token update
(:func:`_decode_ssm`: the conv window rolled over the cached tail, the
plain :func:`~repro_torch.models.ssm.ssd_decode_step`, as the reference
has no kernel for it) and its gated norm (one RMSNorm launch), so an
ssm decode step launches RMSNorm twice a layer plus the final norm and
never the SSD-scan kernel; a hybrid layer adds attention, the two mix
norms and norm2 (five a layer).  Prefill is the full-sequence forward,
so it also runs the flash-attention kernel once an attention layer and
the SSD-scan kernel once an ssm or hybrid layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

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
from ..models.ssm import (gate_norm_out, softplus_dt, ssd_decode_step,
                          ssm_in_proj)


# ---------------------------------------------------------------------------
# cache container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    k: Optional[torch.Tensor] = None         # (L, S, b, n_kv, dh)
    v: Optional[torch.Tensor] = None
    ssm_state: Optional[torch.Tensor] = None  # (L, b, H, N, P) float32
    conv_tail: Optional[torch.Tensor] = None  # (L, K-1, b, d_inner)
    length: int = 0                          # valid positions (host int)


def init_cache(cfg: ModelConfig, seq_len: int, batch: int, *,
               device=None) -> DecodeCache:
    """A zeroed cache of ``seq_len`` positions for ``batch`` sequences on
    ``device`` (default ``cuda``): K/V for every family with attention,
    the SSM state and conv tail for ssm and hybrid."""
    lm_mod.require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    c = DecodeCache(length=0)
    if cfg.family != "ssm":
        shape = (cfg.n_layers, seq_len, batch, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        c.k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        c.v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        c.ssm_state = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
             cfg.ssm_headdim), dtype=torch.float32, device=dev)
        c.conv_tail = torch.zeros(
            (cfg.n_layers, cfg.ssm_conv_kernel - 1, batch, cfg.ssm_d_inner),
            dtype=cfg.dtype, device=dev)
    return c


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


def _decode_ssm(x, lp, cfg: ModelConfig, comm: Comm, state, conv_tail,
                prefix: str = "ssm_") -> torch.Tensor:
    """The SSM mixer for a single token.  x (b, d); state (b, H, N, P)
    and conv_tail (K-1, b, d_inner), both updated in place.  Returns
    (b, d)."""
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xs, dt_raw, b_t, c_t = ssm_in_proj(x, lp, comm, prefix)
    # causal conv: roll the tail window
    window = torch.cat([conv_tail, xs[None]], dim=0)        # (K, b, di)
    xs_c = torch.einsum("kbc,kc->bc", window.float(),
                        lp[prefix + "conv_w"].float()).to(x.dtype)
    conv_tail.copy_(window[1:])
    xs_c = F.silu(xs_c.float()).to(x.dtype)
    dt = softplus_dt(dt_raw, lp[prefix + "dt_bias"])
    h_new, y = ssd_decode_step(
        state, xs_c.reshape(-1, cfg.ssm_heads, cfg.ssm_headdim), dt,
        lp[prefix + "a_log"], b_t.reshape(-1, g, n), c_t.reshape(-1, g, n),
        lp[prefix + "d_skip"])
    state.copy_(h_new)
    return gate_norm_out(y.reshape(-1, cfg.ssm_d_inner), z, lp, comm,
                         prefix)


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, comm: Optional[Comm] = None, *,
                    joint_kv: bool = False, tp2d: bool = False):
    """Build ``serve_step(params, cache, tokens) -> (next_tokens, cache')``.

    tokens: (b,) ints (a tensor or numpy) — the tokens decoded at
    position ``cache.length``; returns the greedily sampled next tokens,
    (b,) int32 on the model's device, and the cache with ``length + 1``
    (its K/V, SSM-state and conv-tail tensors updated in place)."""
    lm_mod.require_ported(cfg, "make_serve_step")
    if joint_kv or tp2d:
        raise NotImplementedError("make_serve_step: joint_kv and tp2d "
                                  "serving are not ported (ROADMAP A4)")
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
            if cfg.family == "ssm":
                x = x + _decode_ssm(h, lp, cfg, comm, cache.ssm_state[idx],
                                    cache.conv_tail[idx])
                continue
            window = layer_window(cfg, idx) if cfg.sliding_window else 0
            a_out = _decode_attn_layer(h, lp, cfg, comm, plan, cache.k[idx],
                                       cache.v[idx], pos, window)
            if cfg.family == "hybrid":
                s_out = _decode_ssm(h, lp, cfg, comm, cache.ssm_state[idx],
                                    cache.conv_tail[idx])
                x = x + 0.5 * (rms_norm(a_out, lp["mix_norm_a"])
                               + rms_norm(s_out, lp["mix_norm_s"]))
                h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
                x = x + _decode_mlp(h2, lp, cfg, comm)
            elif cfg.parallel_block:
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
        return greedy_sample(logits, comm), dataclasses.replace(
            cache, length=pos + 1)

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
