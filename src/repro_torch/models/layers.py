"""Shared layers: norms, RoPE, MLPs, embedding and the decode head.

The mirror of :mod:`repro.models.layers` on PyTorch, in the reference's
seq-major local view ``(s_local, b, d)`` with a :class:`Comm`.  Norm math
is float32 whatever the payload dtype.  :func:`rms_norm` goes through the
RMSNorm kernel (:mod:`repro_torch.kernels.rmsnorm`): for a CUDA tensor it
launches the hand-written Hopper kernel, for a CPU tensor it runs the
plain version.  :func:`lm_head_loss` is the training loss, the
vocab-parallel cross-entropy.

Numerics kept from the reference: ``jax.nn.gelu`` defaults to the tanh
approximation, so both ``"gelu"`` and ``"geglu"`` use
``approximate="tanh"`` (torch's default is erf); swiglu/geglu split
gate|up with the gate first; padded-vocab logits are -1e30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: Optional[torch.Tensor], eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) [* w]`` over the last dim, float32
    statistics, x's dtype out.  One RMSNorm-kernel launch on CUDA."""
    return rmsnorm(x.contiguous(), w, eps=eps)


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor],
               b: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, w: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, w)
    if kind == "layernorm":
        return layer_norm(x, w)
    if kind == "layernorm_np":          # OLMo: non-parametric LN
        return layer_norm(x, None)
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    # a Python-float base: no host-to-device copy (which would sync the
    # host with the card on every call)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (s, b, h, dh); positions: (s,) global positions."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)              # (dh/2,)
    angles = positions.to(torch.float32)[:, None] * freqs      # (s, dh/2)
    cos = torch.cos(angles)[:, None, None, :]
    sin = torch.sin(angles)[:, None, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(s: int, d: int, offset: int = 0, device=None
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings of positions ``offset ..
    offset + s - 1``: (s, d) float32, ``[sin | cos]``."""
    pos = torch.arange(s, dtype=torch.float32, device=device) + offset
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gated_activation(kind: str, gate: torch.Tensor, up: torch.Tensor
                     ) -> torch.Tensor:
    """``act(gate) * up`` for the gated kinds (swiglu, geglu), the
    activation in float32 and cast back, as the reference does."""
    if kind == "swiglu":
        return F.silu(gate.float()).to(gate.dtype) * up
    if kind == "geglu":                  # gemma: gated tanh-GELU
        return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
    raise ValueError(f"{kind!r} is not a gated mlp")


def mlp_activation(kind: str, h: torch.Tensor) -> torch.Tensor:
    """Apply the nonlinearity; swiglu/geglu expect fused gate|up (gate
    first) on the last dim."""
    if kind in ("swiglu", "geglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        return gated_activation(kind, gate, up)
    if kind == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)
    if kind == "relu2":                  # Nemotron/Minitron squared ReLU
        r = F.relu(h)
        return r * r
    raise ValueError(f"unknown mlp {kind!r}")


def mlp_block(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
              kind: str, comm) -> torch.Tensor:
    """x: (s_local, b, d) -> (s_local, b, d): ag_matmul in, matmul_rs out."""
    h = comm.ag_matmul(x, w_in)
    h = mlp_activation(kind, h)
    return comm.matmul_rs(h, w_out)


# ---------------------------------------------------------------------------
# embedding + decode head
# ---------------------------------------------------------------------------

def vocab_rows(tokens: torch.Tensor, emb: torch.Tensor, rank: int
               ) -> torch.Tensor:
    """Rows of the local vocab shard for global ids (0 outside it), f32."""
    v_local = emb.shape[0]
    local = tokens.long() - rank * v_local
    valid = (local >= 0) & (local < v_local)
    rows = emb[local.clamp(0, v_local - 1)].float()
    return rows * valid[..., None]


def embed_tokens(tokens: torch.Tensor, emb: torch.Tensor, comm, *,
                 scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    """tokens: (s_local, b) int; emb: (V_local, d).  Returns the
    seq-local embeddings (s_local, b, d) in emb's dtype."""
    d = emb.shape[1]
    rows = vocab_rows(comm.ag_seq(tokens), emb, comm.model_index())
    out = comm.rs_seq(rows, axis=0)
    if scale_by_sqrt_dim:
        out = out * math.sqrt(d)
    return out.to(emb.dtype)


def lm_head_loss(x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 comm, *, real_vocab: int, z_coef: float = 0.0,
                 ignore_label: int = -100):
    """Vocab-parallel cross-entropy (``repro/models/layers.py:149``).

    x: (s, b, d) full-sequence activations; emb: (V_local, d) head
    shard; labels: (s, b) global ids.  Returns (sum of the per-token
    losses float32, number of kept tokens): only (s, b, V_local) logits
    ever exist on a rank.  Padded vocab rows score -1e30; the max is a
    constant of the gradient (taken detached, then pmax'd), and the
    exp-sum and target logit are summed over the model axis with
    :meth:`Comm.psum_model_ge`, whose backward is the identity."""
    v_local = emb.shape[0]
    rank = comm.model_index()
    logits = torch.matmul(x.float(), emb.float().T)
    gid = rank * v_local + torch.arange(v_local, device=x.device)
    logits = logits.masked_fill(gid >= real_vocab, NEG_INF)
    m = comm.pmax_model(logits.detach().amax(dim=-1))
    se = comm.psum_model_ge(torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(se)                                     # (s, b)
    local = labels.long() - rank * v_local
    valid = (local >= 0) & (local < v_local)
    tl_local = torch.gather(logits, -1,
                            local.clamp(0, v_local - 1)[..., None])[..., 0]
    target = comm.psum_model_ge(torch.where(valid, tl_local,
                                            tl_local.new_zeros(())))
    keep = labels != ignore_label
    per_tok = (lse - target) * keep
    if z_coef:
        per_tok = per_tok + z_coef * (lse * keep) ** 2
    return per_tok.sum(), keep.sum()


def lm_head_logits(x: torch.Tensor, emb: torch.Tensor, comm, *,
                   real_vocab: int) -> torch.Tensor:
    """Decode-path logits: x (..., d) -> (..., V_local) float32, padded
    vocab slots -1e30."""
    v_local = emb.shape[0]
    logits = torch.matmul(x.float(), emb.float().T)
    gid = comm.model_index() * v_local + torch.arange(v_local,
                                                      device=x.device)
    return logits.masked_fill(gid >= real_vocab, NEG_INF)


def greedy_sample(logits_local: torch.Tensor, comm) -> torch.Tensor:
    """Vocab-parallel argmax: (..., V_local) -> (...,) int32 global ids;
    ties go to the lowest id (``torch.argmax`` returns the first
    maximum; across ranks the lowest rank holding the maximum wins)."""
    v_local = logits_local.shape[-1]
    best = torch.argmax(logits_local, dim=-1)
    gid = (comm.model_index() * v_local + best).to(torch.int32)
    if comm.tp == 1:
        return gid
    local_val = torch.gather(logits_local, -1, best[..., None])[..., 0]
    mine = local_val >= comm.pmax_model(local_val)
    cand = torch.where(mine, gid, torch.full_like(gid, 2 ** 31 - 1))
    return -comm.pmax_model(-cand)                   # the global minimum
