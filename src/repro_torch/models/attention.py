"""Attention: flash attention (prefill), flash-decode partials, GQA, SWA.

The mirror of :mod:`repro.models.attention`.  Layout everywhere is the
reference's **seq-major local view** ``(s_local, batch, ...)``.

* :func:`flash_attention` goes through the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`): the hand-written Hopper
  kernel for CUDA tensors, its plain version for CPU tensors.  The
  reference computes the same online-softmax recurrence with a
  ``lax.scan``; the kernel is its port.
* :func:`decode_attention` is plain PyTorch, as the reference has no
  Pallas kernel for it: one query token against the cache, returning the
  partial flash-decode triple ``(num, m, l)``.
* :func:`attention_reference` materializes the score matrix (tests).

Masked scores are -1e30, never -inf: a row that sees no key averages all
keys uniformly, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention as _flash_kernel
from ..kernels.flash_attention.ref import attention_mask

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (sq, b, hq, dh); k/v: (skv, b, hkv, dh), hq % hkv == 0 (GQA).
    ``q_offset`` is the global position of q row 0; ``window`` > 0 keeps
    key j for query i iff ``i - window < j``; ``causal`` keeps ``j <= i``.
    Returns (sq, b, hq, dh) in q.dtype; softmax in float32."""
    return _flash_kernel(q, k, v, causal=causal, window=int(window or 0),
                         q_offset=int(q_offset))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, valid_len: Optional[int] = None,
                     kv_offset: int = 0, window: int = 0,
                     q_pos: Optional[int] = None) -> tuple:
    """One-token attention against a KV slice.

    q: (b, hq, dh); k_cache/v_cache: (skv, b, hkv, dh).  Returns the
    partial triple ``(num (b, hq, dh), m (b, hq), l (b, hq))``: the
    unnormalized output, the max score and the exp-sum.  ``kv_offset`` is
    the global position of cache row 0, ``valid_len`` the number of valid
    positions, ``q_pos`` the query's position (for the window)."""
    skv, b, hkv, dh = k_cache.shape
    hq = q.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(b, hkv, g, dh).float() * scale
    s = torch.einsum("bhgd,kbhd->bhgk", qf, k_cache.float())
    pos = kv_offset + torch.arange(skv, device=q.device)
    valid = torch.ones(skv, dtype=torch.bool, device=q.device)
    if valid_len is not None:
        valid &= pos < valid_len
    if window and q_pos is not None:
        valid &= pos > q_pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bhgk,kbhd->bhgd", p, v_cache.float())
    return num.reshape(b, hq, dh), m.reshape(b, hq), l.reshape(b, hq)


def combine_decode_partials(num, m, l, comm) -> torch.Tensor:
    """Combine flash-decode partials across the model axis: the global
    max, rescaled exp-sums and numerators, then ``num / l``."""
    m_glob = comm.pmax_model(m)
    corr = torch.exp(m - m_glob)
    l_glob = comm.psum_model(l * corr)
    num_glob = comm.psum_model(num * corr[..., None])
    return num_glob / torch.clamp(l_glob, min=1e-37)[..., None]


def attention_reference(q, k, v, *, causal=True, window=0, q_offset=0):
    """O(s²)-memory oracle (materializes the score matrix)."""
    sq, b, hq, dh = q.shape
    skv, _, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(sq, b, hkv, g, dh).float()
    s = torch.einsum("qbhgd,kbhd->bhgqk", qf, k.float()) * scale
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,kbhd->qbhgd", p, v.float())
    return out.reshape(sq, b, hq, dh).to(q.dtype)
