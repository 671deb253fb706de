"""Serving engine: prefill and single-token decode for every family
(port).

The mirror of :mod:`repro.serving.engine`.

Cache layout (the reference's global view; a rank holds its shard, cut by
:func:`cache_pspecs`)::

    k/v        (L, S, B, n_kv, dh)     cfg.dtype (every family but ssm);
                                       seq over ``model`` (and over
                                       ``data`` too when B == 1:
                                       ``joint_kv``), batch over ``data``
    ssm_state  (L, B, H, N, P)         float32   (ssm, hybrid); heads
                                       over ``model``, batch over ``data``
    conv_tail  (L, K-1, B, d_inner)    cfg.dtype (ssm, hybrid); channels
                                       with the heads
    cross_k/v  (L_x, T, B, n_kv, dh)   cfg.dtype (vlm, audio): the memory's
                                       K/V of every cross-attention layer,
                                       from :func:`precompute_cross_kv`;
                                       batch over ``data``

all on the model's device.  The decode step is the reference's, run by
each rank on its shards: local head shards, tiny gathers to full heads,
the cache write on the owning sequence shard, flash-decode partials
combined over the KV-sharding axes, the row-parallel exit; with one rank
every collective is an identity.
``tp2d=True`` is the reference's 2D-TP serving: weights stay in their
(data x model) shards and the activation is sliced along the contraction
dim per data rank instead (:func:`_wmul`).  Differences from the
reference, by design:

* The decode step writes the new K/V rows, the SSM state and the conv
  tail into the cache **in place** (the reference returns an updated
  copy); the returned :class:`DecodeCache` shares the tensors and carries
  ``length + 1``.
* ``DecodeCache.length`` is a host int, so no decode step reads anything
  back from the card until the sampled tokens are wanted.
* A vlm or audio decode step needs the cross-KV cache: a cache without
  ``cross_k`` raises (the reference would fail inside its scan).

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
norms and norm2 (five a layer).  A vlm superblock adds a cross-attention
layer against the cached image K/V (normx, normm: two launches), an
audio decoder layer a cross-attention sub-block (normx: one launch, an
RMSNorm whatever the config's norm, as in the reference); the memory's
K/V are projected once, by :func:`precompute_cross_kv`.  Prefill is
the full-sequence forward, so it also runs the flash-attention kernel once an attention layer (a
cross-attention layer unmasked against the memory; whisper's encoder
bidirectional) and the SSD-scan kernel once an ssm or hybrid layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.runtime import resolve_device
from ..core.telemetry import active
from ..distributed.comm import Comm, _axes, local_comm
from ..distributed.spmd_map import PartitionSpec as P
from ..models import lm as lm_mod
from ..models.attention import decode_attention
from ..models.blocks import TPPlan, layer_window, tp_plan
from ..models.common import ModelConfig, shard_decisions
from ..models.layers import (NEG_INF, apply_norm, apply_rope,
                             gated_activation, greedy_sample,
                             lm_head_logits, mlp_activation, rms_norm,
                             vocab_rows)
from ..models.moe import moe_block
from ..models.ssm import softplus_dt, ssd_decode_step


# ---------------------------------------------------------------------------
# cache container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    k: Optional[torch.Tensor] = None         # (L, S, b, n_kv, dh)
    v: Optional[torch.Tensor] = None
    ssm_state: Optional[torch.Tensor] = None  # (L, b, H, N, P) float32
    conv_tail: Optional[torch.Tensor] = None  # (L, K-1, b, d_inner)
    cross_k: Optional[torch.Tensor] = None   # (L_x, T, b, n_kv, dh)
    cross_v: Optional[torch.Tensor] = None
    length: int = 0                          # valid positions (host int)


def init_cache(cfg: ModelConfig, seq_len: int, batch: int, *,
               n_memory: int = 0, device=None) -> DecodeCache:
    """A zeroed cache of ``seq_len`` positions for ``batch`` sequences on
    ``device`` (default ``cuda``): K/V for every family with attention
    (a vlm config's self-attention layers only), the SSM state and conv
    tail for ssm and hybrid, and with ``n_memory`` the cross-KV of each
    cross-attention layer over ``n_memory`` memory rows (``"meta"``: the
    shapes alone, for the dry run)."""
    lm_mod.require_ported(cfg, "init_cache")
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    c = DecodeCache(length=0)
    if cfg.family != "ssm":
        n_self = cfg.n_layers - (cfg.n_cross_layers if cfg.family == "vlm"
                                 else 0)
        shape = (n_self, seq_len, batch, cfg.n_kv_heads,
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
    if cfg.n_cross_layers and n_memory:
        xshape = (cfg.n_cross_layers, n_memory, batch, cfg.n_kv_heads,
                  cfg.resolved_head_dim)
        c.cross_k = torch.zeros(xshape, dtype=cfg.dtype, device=dev)
        c.cross_v = torch.zeros(xshape, dtype=cfg.dtype, device=dev)
    return c


def cache_pspecs(cfg: ModelConfig, *, batch: int, model_axis="model",
                 data_axis="data", tp2d: bool = False) -> DecodeCache:
    """PartitionSpecs for the cache (``spmd_map`` cuts it by them): seq
    over model (+ data when B == 1, where the batch is replicated over
    data and the data axis becomes extra sequence parallelism for the
    KV), batch over data otherwise; the SSM state's heads and the conv
    tail's channels over model when the SSM heads are sharded; the
    cross-KV whole on every model rank, batch over data.
    ``tp2d`` keeps the reference's signature (the layout is the same)."""
    daxes = (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)
    joint = batch == 1
    seq_axes = ((model_axis,) + daxes) if joint else (model_axis,)
    batch_spec = None if joint else daxes
    ssm_head = model_axis if shard_decisions(cfg)["ssm"] else None
    attn = cfg.family != "ssm"
    ssm = cfg.family in ("ssm", "hybrid")
    cross = (P(None, None, batch_spec, None, None) if cfg.n_cross_layers
             else None)
    return DecodeCache(
        k=P(None, seq_axes, batch_spec, None, None) if attn else None,
        v=P(None, seq_axes, batch_spec, None, None) if attn else None,
        ssm_state=P(None, batch_spec, ssm_head, None, None) if ssm else None,
        conv_tail=P(None, None, batch_spec, ssm_head) if ssm else None,
        cross_k=cross, cross_v=cross, length=None)


# ---------------------------------------------------------------------------
# decode helpers
# ---------------------------------------------------------------------------

def _wmul(x, w, *, fsdp_axis: int, comm: Comm, tp2d: bool) -> torch.Tensor:
    """``x @ w`` with w's FSDP dim either gathered (classic) or stationary.

    tp2d and fsdp_axis == 0 (the contraction dim data-sharded): slice the
    activation's last dim to this data rank's rows, partial product, psum
    over data.  tp2d and fsdp_axis == 1 (the output dim data-sharded):
    local product, then all-gather the (tiny) output columns over data."""
    if not tp2d or not comm.fsdp:
        return torch.matmul(x, comm.weight(w, fsdp_axis=fsdp_axis))
    if fsdp_axis == 0:
        k_l = w.shape[0]
        start = comm.data_index() * k_l
        return comm.psum_data(torch.matmul(x[..., start:start + k_l], w))
    y = torch.matmul(x, w)
    return comm.ag_data(y, axis=y.ndim - 1)


def _row_parallel_out(x_loc, w, *, comm: Comm, tp2d: bool,
                      shard_model: bool) -> torch.Tensor:
    """Row-parallel exit (wo / w_out): model psum and (tp2d) the data
    column gather, the narrow shard reduced first."""
    if not tp2d or not comm.fsdp:
        y = torch.matmul(x_loc, comm.weight(w, fsdp_axis=1))
        return comm.psum_model(y) if shard_model else y
    part = torch.matmul(x_loc, w)                 # (..., d/dp)
    if shard_model:
        part = comm.psum_model(part)
    return comm.ag_data(part, axis=part.ndim - 1)


def _kv_axes(comm: Comm, *, joint: bool) -> tuple:
    """The axes the KV sequence dim is sharded over (model [+ data for
    B == 1]), outermost first; none with one rank."""
    axes = _axes(comm.model_axis)
    if joint:
        axes = _axes(comm.data_axis) + axes
    return axes


def _axes_index(axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * a.size + a.index
    return idx


def _psum_axes(x, axes):
    for a in axes:
        x = a.psum(x)
    return x


def _pmax_axes(x, axes):
    for a in axes:
        x = a.pmax(x)
    return x


def _batch_rows(comm: Comm, b_full: int):
    """This data rank's batch rows (start, count) when the batch is
    sliced over data (tp2d), else None."""
    dp = comm.dp
    if dp > 1 and b_full % dp == 0:
        b_l = b_full // dp
        return comm.data_index() * b_l, b_l
    return None


def _rows(t, rows):
    return t if rows is None else t[rows[0]:rows[0] + rows[1]]


def _decode_attn_layer(x, lp, cfg: ModelConfig, comm: Comm, plan: TPPlan,
                       k_cache, v_cache, pos: int, window: int, *,
                       joint_kv: bool, tp2d: bool, defer_out: bool = False,
                       prefix: str = "", memory_kv=None):
    """One attention layer for a single token.  x (b, d) replicated over
    model; k/v_cache (S_loc, b_loc, nkv, dh), the local sequence shard,
    written in place at ``pos`` by its owner.  With ``memory_kv`` (the
    layer's cross K/V, (T, b_loc, nkv, dh), whole on every model rank)
    the token attends over the whole memory instead: no cache write, no
    RoPE, nothing to combine.  Returns (b, d)."""
    dh = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    is_cross = memory_kv is not None
    # local projections, then tiny gathers to full heads
    q = _wmul(x, lp[prefix + "wq"], fsdp_axis=0, comm=comm, tp2d=tp2d)
    if plan.shard_heads:
        q = comm.ag_seq(q.T, axis=0).T             # (b, nq*dh)
    q = q.reshape(-1, nq, dh)
    if not is_cross:
        k_new = _wmul(x, lp[prefix + "wk"], fsdp_axis=0, comm=comm,
                      tp2d=tp2d)
        v_new = _wmul(x, lp[prefix + "wv"], fsdp_axis=0, comm=comm,
                      tp2d=tp2d)
        if plan.shard_kv:
            k_new = comm.ag_seq(k_new.T, axis=0).T
            v_new = comm.ag_seq(v_new.T, axis=0).T
        k_new = k_new.reshape(-1, nkv, dh)
        v_new = v_new.reshape(-1, nkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp[prefix + "q_norm"])
        if not is_cross:
            k_new = rms_norm(k_new, lp[prefix + "k_norm"])
    # tp2d: x and q are batch-replicated over data (the weight-stationary
    # layout), but the attention runs batch-SHARDED against the classic
    # (seq/model, batch/data) cache and the rows rejoin before the
    # out-projection
    rows = _batch_rows(comm, x.shape[0]) if tp2d and not joint_kv else None
    q = _rows(q, rows)
    if is_cross:
        mk, mv = memory_kv
        num, m, l = decode_attention(q, mk, mv, valid_len=None)
        attn = num / torch.clamp(l, min=1e-37)[..., None]
    else:
        k_new, v_new = _rows(k_new, rows), _rows(v_new, rows)
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q[None], posv, cfg.rope_theta)[0]
        k_new = apply_rope(k_new[None], posv, cfg.rope_theta)[0]
        # the cache write on the owning sequence shard (past the end of
        # the cache the reference drops it)
        axes = _kv_axes(comm, joint=joint_kv and rows is None)
        shard_len = k_cache.shape[0]
        my_start = _axes_index(axes) * shard_len
        rel = pos - my_start
        if 0 <= rel < shard_len:
            k_cache[rel] = k_new.to(k_cache.dtype)
            v_cache[rel] = v_new.to(v_cache.dtype)
        num, m, l = decode_attention(q, k_cache, v_cache,
                                     valid_len=pos + 1, kv_offset=my_start,
                                     window=window, q_pos=pos)
        # flash-decode partials combined over the KV-sharding axes
        m_g = _pmax_axes(m, axes)
        corr = torch.exp(m - m_g)
        l_g = _psum_axes(l * corr, axes)
        num_g = _psum_axes(num * corr[..., None], axes)
        attn = num_g / torch.clamp(l_g, min=1e-37)[..., None]
    attn = attn.reshape(-1, nq * dh).to(x.dtype)
    if rows is not None:
        attn = comm.ag_data(attn, axis=0)          # (b, nq*dh)
    if plan.shard_heads:
        nq_l = plan.q_local(cfg)
        start = comm.model_index() * (nq_l * dh)
        attn = attn[:, start:start + nq_l * dh]
    if defer_out:
        return torch.matmul(attn, lp[prefix + "wo"])
    return _row_parallel_out(attn, lp[prefix + "wo"], comm=comm, tp2d=tp2d,
                             shard_model=plan.shard_heads)


def _decode_mlp(x, lp, cfg: ModelConfig, comm: Comm, prefix: str = "",
                tp2d: bool = False, defer_out: bool = False) -> torch.Tensor:
    def wmul(name):
        return _wmul(x, lp[prefix + name], fsdp_axis=0, comm=comm,
                     tp2d=tp2d)

    if cfg.mlp in ("swiglu", "geglu"):
        h = gated_activation(cfg.mlp, wmul("w_gate"), wmul("w_up"))
    else:
        h = mlp_activation(cfg.mlp, wmul("w_in"))
    if defer_out:
        return torch.matmul(h, lp[prefix + "w_out"])
    return _row_parallel_out(h, lp[prefix + "w_out"], comm=comm, tp2d=tp2d,
                             shard_model=True)


def _decode_ssm(x, lp, cfg: ModelConfig, comm: Comm, plan: TPPlan, state,
                conv_tail, prefix: str = "ssm_", tp2d: bool = False):
    """The SSM mixer for one token.  x (b, d); state (b_loc, H_loc, N, P)
    and conv_tail (K-1, b_loc, di_loc), the local shards, updated in
    place.  Returns (b, d)."""
    def w(name):
        return lp[prefix + name]

    def wmul(name):
        return _wmul(x, w(name), fsdp_axis=0, comm=comm, tp2d=tp2d)

    tp = comm.tp if plan.shard_ssm_heads else 1
    h_l = cfg.ssm_heads // tp
    g, n = cfg.ssm_groups, cfg.ssm_state
    # tp2d: the recurrent state and conv caches are batch-sharded over
    # data: this rank's batch rows for the recurrence, rejoined after
    rows = _batch_rows(comm, x.shape[0]) if tp2d else None
    z, xs, dt_raw, bc = (_rows(wmul(k), rows)
                         for k in ("w_z", "w_x", "w_dt", "w_bc"))
    b_t, c_t = torch.chunk(bc, 2, dim=-1)
    # causal conv: roll the tail window
    window = torch.cat([conv_tail, xs[None]], dim=0)    # (K, b, di_l)
    xs_c = torch.einsum("kbc,kc->bc", window.float(),
                        w("conv_w").float()).to(x.dtype)
    conv_tail.copy_(window[1:])
    xs_c = F.silu(xs_c.float()).to(x.dtype)
    dt = softplus_dt(dt_raw, w("dt_bias"))
    h_new, y = ssd_decode_step(
        state, xs_c.reshape(-1, h_l, cfg.ssm_headdim), dt, w("a_log"),
        b_t.reshape(-1, g, n), c_t.reshape(-1, g, n), w("d_skip"))
    state.copy_(h_new)
    y = y.reshape(-1, cfg.ssm_d_inner // tp)
    y = y * F.silu(z.float()).to(y.dtype)
    if tp == 1:
        y = rms_norm(y, w("norm_w"))             # the RMSNorm kernel
    else:
        # the gated norm over the WHOLE d_inner: the sum of squares is
        # psum'd over the model axis
        yf = y.float()
        ssq = comm.psum_model((yf * yf).sum(dim=-1, keepdim=True))
        yf = yf * torch.rsqrt(ssq / cfg.ssm_d_inner + 1e-6)
        y = (yf * w("norm_w").float()).to(x.dtype)
    if rows is not None:
        y = comm.ag_data(y, axis=0)              # rejoin rows pre-out-proj
    return _row_parallel_out(y, w("w_out"), comm=comm, tp2d=tp2d,
                             shard_model=plan.shard_ssm_heads)


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, comm: Optional[Comm] = None, *,
                    joint_kv: bool = False, tp2d: bool = False):
    """Build ``serve_step(params, cache, tokens) -> (next_tokens, cache')``.

    Each rank runs it on its shards (``spmd_map``; with one rank, on the
    whole model).  tokens: (b,) ints (a tensor or numpy) — the tokens
    decoded at position ``cache.length``, as the reference's specs hand
    them to the rank (batch over data in the classic layout, replicated
    under tp2d and for B == 1); returns the greedily sampled next tokens,
    (b,) int32 on the model's device, and the cache with ``length + 1``
    (its local K/V, SSM-state and conv-tail tensors updated in place).
    A vlm or audio step reads the cross-KV of ``cache`` (filled by
    :func:`precompute_cross_kv`).
    ``joint_kv``: the KV sequence dim is sharded over data AND model (B
    == 1 long-context shapes); ``tp2d``: 2D-TP serving."""
    lm_mod.require_ported(cfg, "make_serve_step")
    comm = comm or local_comm()
    plan = tp_plan(cfg, comm.tp)
    final_kind = lm_mod.final_norm_kind(cfg)
    scale = cfg.name.startswith("gemma")
    n_cross = cfg.n_cross_layers

    @torch.no_grad()
    def serve_step(params, cache: DecodeCache, tokens):
        pos = cache.length
        emb = (params["emb"] if tp2d
               else comm.weight(params["emb"], fsdp_axis=1))
        tokens = torch.as_tensor(tokens, device=emb.device)
        rows = comm.psum_model(vocab_rows(tokens, emb, comm.model_index()))
        if tp2d:
            rows = comm.ag_data(rows, axis=1)
        if scale:
            rows = rows * math.sqrt(rows.shape[-1])
        x = rows.to(emb.dtype)
        if n_cross and cache.cross_k is None:
            raise ValueError(f"{cfg.name}: a {cfg.family} decode step "
                             "needs the cross-KV cache (init_cache(..., "
                             "n_memory=) filled by precompute_cross_kv)")

        def layer(x, lp, idx, xkv=None):
            """Self layer ``idx`` (its cache row); ``xkv``: the enc-dec
            cross K/V of this layer."""
            h = apply_norm(cfg.norm, x, lp.get("norm1"))
            if cfg.family == "ssm":
                return x + _decode_ssm(h, lp, cfg, comm, plan,
                                       cache.ssm_state[idx],
                                       cache.conv_tail[idx], tp2d=tp2d)
            window = layer_window(cfg, idx) if cfg.sliding_window else 0
            parallel_2d = tp2d and cfg.parallel_block
            a_out = _decode_attn_layer(h, lp, cfg, comm, plan, cache.k[idx],
                                       cache.v[idx], pos, window,
                                       joint_kv=joint_kv, tp2d=tp2d,
                                       defer_out=parallel_2d)
            if cfg.family == "hybrid":
                s_out = _decode_ssm(h, lp, cfg, comm, plan,
                                    cache.ssm_state[idx],
                                    cache.conv_tail[idx], tp2d=tp2d)
                x = x + 0.5 * (rms_norm(a_out, lp["mix_norm_a"])
                               + rms_norm(s_out, lp["mix_norm_s"]))
                h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
                return x + _decode_mlp(h2, lp, cfg, comm, tp2d=tp2d)
            if parallel_2d:
                # attention and MLP write the same residual: one psum over
                # model and one column gather for both partials
                pm = _decode_mlp(h, lp, cfg, comm, tp2d=True, defer_out=True)
                combined = comm.psum_model(a_out + pm)
                return x + comm.ag_data(combined, axis=combined.ndim - 1)
            if cfg.parallel_block:
                return x + a_out + _decode_mlp(h, lp, cfg, comm)
            x = x + a_out
            if xkv is not None:                  # enc-dec cross-attention
                x = x + _decode_attn_layer(
                    rms_norm(x, lp["normx"]), lp, cfg, comm, plan, None,
                    None, pos, 0, joint_kv=joint_kv, tp2d=tp2d,
                    prefix="x_", memory_kv=xkv)
            h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
            if cfg.family == "moe":
                # the experts keep the gather path (dispatch owns the
                # a2a); the shared MLP rides tp2d
                mo = moe_block(h2[None], lp, cfg, comm)[0][0]
                if cfg.shared_expert_ff:
                    mo = mo + _decode_mlp(h2, lp, cfg, comm,
                                          prefix="shared_", tp2d=tp2d)
                return x + mo
            return x + _decode_mlp(h2, lp, cfg, comm, tp2d=tp2d)

        if cfg.family == "vlm":
            per = cfg.cross_attn_every - 1
            for i in range(n_cross):
                for j in range(per):
                    idx = i * per + j
                    x = layer(x, lm_mod.layer_params(params, idx), idx)
                clp = lm_mod.layer_params(params, i, "cross_layers")
                x_out = _decode_attn_layer(
                    rms_norm(x, clp["normx"]), clp, cfg, comm, plan, None,
                    None, pos, 0, joint_kv=joint_kv, tp2d=tp2d,
                    prefix="x_", memory_kv=(cache.cross_k[i],
                                            cache.cross_v[i]))
                x = x + torch.tanh(clp["gate_attn"]).to(x.dtype) * x_out
                ff = _decode_mlp(rms_norm(x, clp["normm"]), clp, cfg, comm,
                                 prefix="xm_", tp2d=tp2d)
                x = x + torch.tanh(clp["gate_mlp"]).to(x.dtype) * ff
        else:
            for idx in range(cfg.n_layers):
                xkv = ((cache.cross_k[idx], cache.cross_v[idx])
                       if cfg.is_encdec else None)
                x = layer(x, lm_mod.layer_params(params, idx), idx, xkv)
        x = apply_norm(final_kind, x, params["final_norm"])
        head = params.get("lm_head", params["emb"])
        if tp2d:
            # the head's d columns stay data-sharded: slice x, partial
            # logits, psum over data
            d_l = head.shape[1]
            start = comm.data_index() * d_l
            logits = comm.psum_data(torch.matmul(
                x[:, start:start + d_l].float(), head.float().T))
            v_local = head.shape[0]
            gid = comm.model_index() * v_local + torch.arange(
                v_local, device=x.device)
            logits = logits.masked_fill(gid >= cfg.vocab, NEG_INF)
        else:
            logits = lm_head_logits(x, comm.weight(head, fsdp_axis=1),
                                    comm, real_vocab=cfg.vocab)
        return greedy_sample(logits, comm), dataclasses.replace(
            cache, length=pos + 1)

    return serve_step


def precompute_cross_kv(params, memory: torch.Tensor, cfg: ModelConfig,
                        comm: Optional[Comm] = None):
    """Project the encoder or image memory through every cross-attention
    layer's K/V: memory (T, b, d), full length -> (cross_k, cross_v),
    each (L_x, T, b, n_kv, dh); computed once at admission, reused by
    every decode step."""
    comm = comm or local_comm()
    dh = cfg.resolved_head_dim
    stack = params["cross_layers" if cfg.family == "vlm" else "layers"]

    def project(name):
        return torch.stack([
            torch.matmul(memory, comm.weight(w, fsdp_axis=0)).unflatten(
                -1, (-1, dh)) for w in stack[name]])
    with torch.no_grad():
        return project("x_wk"), project("x_wv")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, comm: Optional[Comm] = None):
    """Build ``prefill(params, batch) -> (next_tokens (b,), last_hidden
    (b, d))``: the full-sequence forward at inference, with the head on
    the last position only (a vlm batch carries ``image_embeds``, an
    audio batch ``frames``).  Telemetry spans ``prefill`` (the call) and
    ``head`` (:mod:`repro_torch.core.telemetry`)."""
    lm_mod.require_ported(cfg, "make_prefill_step")
    comm = comm or local_comm()

    @torch.no_grad()
    def prefill(params, batch):
        tele = active()
        with tele.span("prefill"):
            x, _ = lm_mod.forward(params, batch, cfg, comm)
            with tele.span("head"):
                last = x[-1]                           # (b, d)
                head = comm.weight(params.get("lm_head", params["emb"]),
                                   fsdp_axis=1)
                logits = lm_head_logits(last, head, comm,
                                        real_vocab=cfg.vocab)
                return greedy_sample(logits, comm), last

    return prefill
