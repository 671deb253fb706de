"""Language models: init, forward and loss for every family (PyTorch
port).

The mirror of :mod:`repro.models.lm` for the dense family (GQA,
sliding-window, qk-norm and parallel-block transformers), the moe family
(a :mod:`.moe` block in place of the MLP, plus an optional shared
expert), the ssm family (a Mamba2 :mod:`.ssm` mixer a layer, no MLP),
the hybrid family (attention and the SSM mixer side by side on the same
normed input, their outputs RMS-normed and averaged, then an MLP), the
vlm family (llama-3.2-vision: superblocks of ``cross_attn_every - 1``
self-attention layers and one gated cross-attention layer over the
image embeddings) and the audio family (whisper: an encoder over the
frame embeddings, then decoder layers that cross-attend to its output).
The layer stack is a Python loop over the stacked ``(L, ...)``
parameters (the reference's ``lax.scan``); with ``remat`` and grad mode
on, each layer, superblock or encoder layer is checkpointed (the
reference's per-layer ``jax.checkpoint``), so backward recomputes it from
its input: by ``torch.utils.checkpoint`` on one device, by the rank
thread's tape (:mod:`repro_torch.distributed.spmd_autograd`) while one
records, so that the recompute's collectives run on the rank thread.
:func:`loss_and_metrics` is the training loss: the vocab-parallel
cross-entropy over ``loss_chunk``-row chunks, each checkpointed so that
one chunk's float32 logits are live at a time, plus the router terms.
The telemetry spans (:mod:`repro_torch.core.telemetry`) here are
``embed``, ``norm`` (each pre-norm and the final norm), ``attn`` and
``loss.head``; the MoE block and the SSM mixer open their own.
At tp > 1 every block runs the reference's tensor-parallel schedule
through the :class:`Comm` (sequence-sharded activations, the ring
collectives at the TP boundaries), in serving and in training.

Batch convention (seq-major local view):
    tokens  (s_local, b)   int
    labels  (s_local, b)   int   (-100 = ignore)
    [frames (t_local, b, d)]        audio stub (whisper)
    [image_embeds (ti, b, d)]       vision stub (llama-3.2-vision)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.telemetry import active
from ..distributed.comm import Comm
from ..distributed.spmd_autograd import checkpoint
from .blocks import (TPPlan, attention_op, init_attention, init_mlp,
                     swa_attention_op, tp_plan)
from .common import ModelConfig, ParamFactory
from .layers import (apply_norm, embed_tokens, gated_activation,
                     lm_head_loss, mlp_activation, mlp_block, rms_norm,
                     sinusoidal_positions)
from .moe import init_moe, moe_block
from .ssm import init_ssm, ssm_op

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_AUX_KEYS = ("aux_lb", "aux_z", "dropped_frac")


def require_ported(cfg: ModelConfig, what: str) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family ({cfg.name}) is not ported "
            f"to PyTorch yet; ported: {PORTED_FAMILIES} (ROADMAP.md)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_norm(pf: ParamFactory, cfg: ModelConfig, name: str, L: int):
    if cfg.norm == "layernorm_np":
        return {}                          # OLMo: non-parametric, no weight
    return {name: pf.ones(name, (L, cfg.d_model), stacked=True)}


def _init_layer_stack(pf: ParamFactory, cfg: ModelConfig, L: int
                      ) -> Dict[str, torch.Tensor]:
    """One homogeneous stack of L layers of a ported family, in the
    reference's init order."""
    p: Dict[str, torch.Tensor] = {}
    p.update(_init_norm(pf, cfg, "norm1", L))
    if cfg.family != "ssm":
        p.update(init_attention(pf, cfg, stacked_layers=L))
    if cfg.family in ("ssm", "hybrid"):
        p.update(init_ssm(pf, cfg, stacked_layers=L))
    if cfg.family == "hybrid":
        p["mix_norm_a"] = pf.ones("mix_norm_a", (L, cfg.d_model))
        p["mix_norm_s"] = pf.ones("mix_norm_s", (L, cfg.d_model))
    if cfg.family == "moe":
        p.update(_init_norm(pf, cfg, "norm2", L))
        p.update(init_moe(pf, cfg, stacked_layers=L))
        if cfg.shared_expert_ff:
            p.update(init_mlp(pf, cfg, prefix="shared_", stacked_layers=L,
                              d_ff=cfg.shared_expert_ff))
    elif cfg.family != "ssm" and cfg.d_ff and not cfg.parallel_block:
        p.update(_init_norm(pf, cfg, "norm2", L))
        p.update(init_mlp(pf, cfg, stacked_layers=L))
    elif cfg.parallel_block and cfg.d_ff:
        p.update(init_mlp(pf, cfg, stacked_layers=L))   # shares norm1
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (params, specs), parallel dicts with the reference's keys
    and stacked shapes, drawn from ``gen`` on ``gen.device`` in the
    reference's order (on ``device`` when given: ``"meta"`` allocates
    nothing).  A vlm config adds ``cross_layers`` (its gates zero, as in
    the reference), an enc-dec config ``encoder`` and
    ``enc_final_norm``."""
    require_ported(cfg, "init_params")
    pf = ParamFactory(gen, cfg.dtype, fsdp=cfg.fsdp_params, device=device)
    d = cfg.d_model
    params: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}

    def grab(sub: Dict[str, torch.Tensor], dest_key: str):
        params[dest_key] = sub
        specs[dest_key] = {k: pf.specs[k] for k in sub}
        pf.specs.clear()

    def grab_one(name: str, value: torch.Tensor):
        params[name] = value
        specs[name] = pf.specs.pop(name)

    grab_one("emb", pf.dense("emb", (cfg.padded_vocab, d), tp_axis=0,
                             fsdp_axis=1, stacked=False, scale=1.0))
    if not cfg.tie_embeddings:
        grab_one("lm_head", pf.dense("lm_head", (cfg.padded_vocab, d),
                                     tp_axis=0, fsdp_axis=1, stacked=False))
    grab_one("final_norm", pf.ones("final_norm", (d,), stacked=False))

    if cfg.family == "vlm":
        n_cross = cfg.n_cross_layers
        grab(_init_layer_stack(pf, cfg, cfg.n_layers - n_cross), "layers")
        cp: Dict[str, torch.Tensor] = {
            "normx": pf.ones("normx", (n_cross, d))}
        cp.update(init_attention(pf, cfg, prefix="x_",
                                 stacked_layers=n_cross))
        cp["gate_attn"] = pf.zeros("gate_attn", (n_cross,),
                                   dtype=torch.float32)
        cp["normm"] = pf.ones("normm", (n_cross, d))
        cp.update(init_mlp(pf, cfg, prefix="xm_", stacked_layers=n_cross))
        cp["gate_mlp"] = pf.zeros("gate_mlp", (n_cross,),
                                  dtype=torch.float32)
        grab(cp, "cross_layers")
    elif cfg.is_encdec:
        grab(_init_layer_stack(pf, cfg, cfg.encoder_layers), "encoder")
        grab_one("enc_final_norm", pf.ones("enc_final_norm", (d,),
                                           stacked=False))
        L = cfg.n_layers
        dp: Dict[str, torch.Tensor] = {}
        dp.update(_init_norm(pf, cfg, "norm1", L))
        dp.update(init_attention(pf, cfg, stacked_layers=L))
        dp["normx"] = pf.ones("normx", (L, d))
        dp.update(init_attention(pf, cfg, prefix="x_", stacked_layers=L))
        dp.update(_init_norm(pf, cfg, "norm2", L))
        dp.update(init_mlp(pf, cfg, stacked_layers=L))
        grab(dp, "layers")
    else:
        grab(_init_layer_stack(pf, cfg, cfg.n_layers), "layers")
    return params, specs


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlp_op(x, lp, cfg, comm, prefix: str = "") -> torch.Tensor:
    """The MLP.  With one rank, or with the MLP replicated over the model
    axis (``tp_mlp`` off), local matmuls with gate and up separate (the
    reference concatenates ``[w_gate | w_up]`` and splits the product);
    at tp > 1 the concatenated local shards enter through ``ag_matmul``
    and leave through ``matmul_rs``, as in the reference."""
    w_out = comm.weight(lp[prefix + "w_out"], fsdp_axis=1)
    if comm.tp > 1 and cfg.tp_mlp:
        if cfg.mlp in ("swiglu", "geglu"):
            w_in = torch.cat([comm.weight(lp[prefix + "w_gate"],
                                          fsdp_axis=0),
                              comm.weight(lp[prefix + "w_up"],
                                          fsdp_axis=0)], dim=1)
        else:
            w_in = comm.weight(lp[prefix + "w_in"], fsdp_axis=0)
        return mlp_block(x, w_in, w_out, cfg.mlp, comm)
    if cfg.mlp in ("swiglu", "geglu"):
        gate = torch.matmul(x, comm.weight(lp[prefix + "w_gate"],
                                           fsdp_axis=0))
        up = torch.matmul(x, comm.weight(lp[prefix + "w_up"], fsdp_axis=0))
        h = gated_activation(cfg.mlp, gate, up)
        return torch.matmul(h, w_out)
    if comm.tp > 1:                     # replicated MLP: no collective
        h = mlp_activation(cfg.mlp, torch.matmul(
            x, comm.weight(lp[prefix + "w_in"], fsdp_axis=0)))
        return torch.matmul(h, w_out)
    return mlp_block(x, comm.weight(lp[prefix + "w_in"], fsdp_axis=0),
                     w_out, cfg.mlp, comm)


def _decoder_block(x, lp, idx: int, cfg: ModelConfig, comm: Comm,
                   plan: TPPlan, q_offset: int, memory=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """One decoder layer of any family; returns (x', aux).  With
    ``memory`` and the layer's ``x_`` weights (enc-dec), a
    cross-attention sub-block follows the self-attention."""
    tele = active()
    with tele.span("norm"):
        h = apply_norm(cfg.norm, x, lp.get("norm1"))
    if cfg.family == "ssm":
        return x + ssm_op(h, lp, cfg, comm, plan), {}
    with tele.span("attn"):
        attn = swa_attention_op(h, lp, cfg, comm, plan, layer_idx=idx,
                                q_offset=q_offset)
    if cfg.family == "hybrid":
        s_out = ssm_op(h, lp, cfg, comm, plan)
        x = x + 0.5 * (rms_norm(attn, lp["mix_norm_a"])
                       + rms_norm(s_out, lp["mix_norm_s"]))
        h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
        return x + _mlp_op(h2, lp, cfg, comm), {}
    if cfg.parallel_block:                       # Cohere: attn ∥ mlp
        return x + attn + _mlp_op(h, lp, cfg, comm), {}
    x = x + attn
    if memory is not None and "x_wq" in lp:      # enc-dec cross-attention
        # rms_norm whatever cfg.norm is, as the reference does
        hx = rms_norm(x, lp["normx"])
        x = x + attention_op(hx, lp, cfg, comm, plan, window=0,
                             q_offset=q_offset, memory=memory, prefix="x_")
    with tele.span("norm"):
        h2 = apply_norm(cfg.norm, x, lp.get("norm2"))
    if cfg.family == "moe":
        moe_out, aux = moe_block(h2, lp, cfg, comm)
        if cfg.shared_expert_ff:
            moe_out = moe_out + _mlp_op(h2, lp, cfg, comm, prefix="shared_")
        return x + moe_out, aux
    return x + _mlp_op(h2, lp, cfg, comm), {}


def _cross_block(x, lp, cfg: ModelConfig, comm: Comm, plan: TPPlan,
                 q_offset: int, memory) -> torch.Tensor:
    """Gated cross-attention layer (llama-3.2-vision style)."""
    hx = rms_norm(x, lp["normx"])
    attn = attention_op(hx, lp, cfg, comm, plan, window=0,
                        q_offset=q_offset, memory=memory, prefix="x_")
    x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * attn
    hm = rms_norm(x, lp["normm"])
    ff = _mlp_op(hm, lp, cfg, comm, prefix="xm_")
    return x + torch.tanh(lp["gate_mlp"]).to(x.dtype) * ff


def layer_params(params: Dict[str, Any], idx: int,
                 key: str = "layers") -> Dict[str, Any]:
    """Layer ``idx``'s slice of the stacked ``(L, ...)`` params (views)."""
    return {k: v[idx] for k, v in params[key].items()}


def _unbind(stack) -> list:
    """Each layer's params as views from one unbind of each stacked
    param, so the backward stacks the layers' gradients once (indexing
    layer idx would build a zero-filled stacked gradient a layer and add
    them up: L adds of the whole stack).  A list is already one dict a
    layer (the tape's per-layer leaves, ``spmd_autograd.param_leaves``)."""
    if isinstance(stack, list):
        return stack
    parts = {k: torch.unbind(v) for k, v in stack.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _run(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed when ``remat``."""
    if remat:
        return checkpoint(fn, *args)
    return fn(*args)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def final_norm_kind(cfg: ModelConfig) -> str:
    return "rmsnorm" if cfg.norm == "rmsnorm" else "layernorm"


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, comm: Comm, *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x_full (s, b, d) post-final-norm full-sequence, aux).
    ``remat`` checkpoints each layer (a vlm config: each superblock; an
    enc-dec config: each encoder and decoder layer) when grad mode is on
    (under ``torch.no_grad()`` it changes nothing)."""
    require_ported(cfg, "forward")
    plan = tp_plan(cfg, comm.tp)
    tokens = batch["tokens"]
    s_l = tokens.shape[0]
    q_offset = comm.model_index() * s_l
    tele = active()
    with tele.span("embed"):
        emb = comm.weight(params["emb"], fsdp_axis=1)
        x = embed_tokens(tokens, emb, comm,
                         scale_by_sqrt_dim=cfg.name.startswith("gemma"))
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in _AUX_KEYS}
    remat = remat and torch.is_grad_enabled()

    memory = None
    if cfg.family == "vlm":
        memory = batch["image_embeds"]              # (ti, b, d) replicated
    if cfg.is_encdec:
        memory = _encode(params, batch, cfg, comm, plan, remat=remat)

    layers = _unbind(params["layers"])
    if cfg.family == "vlm":
        per = cfg.cross_attn_every - 1              # self layers a block
        cross = _unbind(params["cross_layers"])

        def superblock(xc, mem, i):
            for j in range(per):
                xc, _ = _decoder_block(xc, layers[i * per + j], i * per + j,
                                       cfg, comm, plan, q_offset)
            return _cross_block(xc, cross[i], cfg, comm, plan, q_offset,
                                mem)

        for i in range(cfg.n_cross_layers):
            x = _run(superblock, remat, x, memory, i)
    else:
        def layer(xc, mem, idx):
            return _decoder_block(xc, layers[idx], idx, cfg, comm, plan,
                                  q_offset, memory=mem)

        for idx in range(cfg.n_layers):
            x, layer_aux = _run(layer, remat, x, memory, idx)
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v
    with tele.span("norm"):
        x = apply_norm(final_norm_kind(cfg), x, params["final_norm"])
    x = comm.ag_seq(x)
    # per-layer means; the router terms come from local tokens, so the
    # reference psums them over the model axis (the identity at one rank)
    n_layers = max(cfg.n_layers, 1)
    aux = {k: comm.psum_model_ge(v / n_layers) / comm.tp
           for k, v in aux.items()}
    return x, aux


def _encode(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, comm: Comm, plan: TPPlan, *,
            remat: bool) -> torch.Tensor:
    """Whisper-style encoder over the stub frame embeddings (t_local, b,
    d) -> the full memory (t, b, d): sinusoidal positions, then
    bidirectional self-attention layers (RoPE on, each query at its
    global position), the final layernorm and a sequence gather."""
    frames = batch["frames"]                        # (t_local, b, d)
    t_l, _, d = frames.shape
    pos = sinusoidal_positions(t_l, d, offset=comm.model_index() * t_l,
                               device=frames.device).to(frames.dtype)
    x = frames + pos[:, None, :]

    def layer(xc, lp):
        h = apply_norm(cfg.norm, xc, lp.get("norm1"))
        # the rank's frames start at t_l * index: with the heads
        # replicated (Plan B) its queries are those rows (the reference
        # passes 0 here, giving every rank's queries positions 0..t_l-1)
        xc = xc + attention_op(h, lp, cfg, comm, plan, window=0,
                               q_offset=comm.model_index() * t_l,
                               causal=False)
        h2 = apply_norm(cfg.norm, xc, lp.get("norm2"))
        return xc + _mlp_op(h2, lp, cfg, comm)

    for lp in _unbind(params["encoder"]):
        x = _run(layer, remat, x, lp)
    x = apply_norm(final_norm_kind(cfg), x, params["enc_final_norm"])
    return comm.ag_seq(x)                           # memory: (t, b, d)


def loss_and_metrics(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                     cfg: ModelConfig, comm: Comm, *, remat: bool = True,
                     loss_chunk: int = 1024
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE (+ router aux) over this data shard; the caller pmean's
    (``repro/models/lm.py:317``).  The head runs over chunks of
    ``loss_chunk`` sequence rows (the largest divisor of s not above it,
    as the reference picks); with grad mode on each chunk is
    checkpointed, so backward recomputes its float32 logits and only one
    chunk's are live at a time, but keeps its collectives' outputs (the
    reference, which does not remat the chunk, keeps them as
    residuals)."""
    x, aux = forward(params, batch, cfg, comm, remat=remat)
    labels = comm.ag_seq(batch["labels"])              # (s, b)
    head = comm.weight(params.get("lm_head", params["emb"]), fsdp_axis=1)
    s = x.shape[0]
    ck = min(loss_chunk, s)
    while s % ck:
        ck -= 1

    def chunk_loss(xb, lb):
        with active().span("loss.head"):
            return lm_head_loss(xb, head, lb, comm, real_vocab=cfg.vocab)

    sums, ns = [], []
    for i in range(0, s, ck):
        xb, lb = x[i:i + ck], labels[i:i + ck]
        if torch.is_grad_enabled():
            total, n = checkpoint(chunk_loss, xb, lb, keep=True)
        else:
            total, n = chunk_loss(xb, lb)
        sums.append(total)
        ns.append(n)
    total, n = torch.stack(sums).sum(), torch.stack(ns).sum()
    ce = total / torch.clamp(n, min=1)
    loss = (ce + cfg.router_aux_coef * aux["aux_lb"]
            + cfg.router_z_coef * aux["aux_z"])
    return loss, {"loss": loss, "ce": ce, "ntok": n, **aux}
