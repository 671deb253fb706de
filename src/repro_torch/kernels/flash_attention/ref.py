"""Plain PyTorch version of the flash-attention kernel (O(s²) memory).

The mirror of ``repro/kernels/flash_attention/ref.py``: q (b, hq, sq,
dh), k/v (b, hkv, skv, dh), GQA by ``h // (hq // hkv)``, causal and
sliding-window masks from global positions (``q_offset`` is the
position of q row 0), masked scores -1e30 so a row that sees no key
averages all keys uniformly, softmax in float32, output in q.dtype.

``p_dtype`` (default None: the reference's arithmetic) rounds the softmax
weights to that dtype before the product with v, the exp-sum still taken
from the float32 weights: with ``torch.bfloat16`` it is the plain version
of what the kernel's tensor-core variant computes, which feeds P to the
tensor cores in bf16.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(sq, skv) bool: key j visible to query row i."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        p_dtype=None):
    """q (b, hq, sq, dh); k/v (b, hkv, skv, dh) -> (b, hq, sq, dh)."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    qf = q.reshape(b, hkv, g, sq, dh).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    s = s / math.sqrt(dh)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    else:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", e.to(p_dtype).float(),
                         v.float()) / torch.clamp(l, min=1e-37)
    return o.reshape(b, hq, sq, dh).to(q.dtype)
