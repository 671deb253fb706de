"""Plain PyTorch version of the SSD-scan kernel (the oracle).

The mirror of ``repro/kernels/ssd_scan/ref.py``: the per-step recurrence

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · (B_t ⊗ x_t)
    y_t = C_t · h_t + D · x_t

with ``A = -exp(a_log)``, on the kernel's layout x (bs, h, s, p), dt
(bs, h, s), b/c (bs, g, s, n) (head ``hi`` reads group ``hi // (h/g)``).
All arithmetic is float32 and y is cast to x's dtype.  Unlike the
reference it takes an initial state ``h0`` (bs, h, n, p) and also returns
the final state, as the model's ``ssd_scan`` does.  It takes s sequential
steps: a yardstick of correctness, not of speed.

:func:`ssd_scan_tc_ref` is the plain version of the kernel's tensor-core
variant: the chunked algorithm with exactly its roundings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (bs, h, s, p); dt (bs, h, s); b/c (bs, g, s, n); a_log/d_skip
    (h,); h0 (bs, h, n, p) or None -> (y (bs, h, s, p) in x.dtype,
    h_final (bs, h, n, p) float32)."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    r = h // g
    a = -torch.exp(a_log.float())
    bf = b.float().repeat_interleave(r, dim=1)              # (bs, h, s, n)
    cf = c.float().repeat_interleave(r, dim=1)
    xf = x.float()
    dtf = dt.float()
    hs = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    ys = []
    for t in range(s):
        at = torch.exp(dtf[:, :, t] * a)                    # (bs, h)
        upd = bf[:, :, t, :, None] * (xf[:, :, t] *
                                      dtf[:, :, t, None])[:, :, None, :]
        hs = at[..., None, None] * hs + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, :, t], hs))
    y = (torch.stack(ys, dim=2) if ys else torch.zeros_like(xf))
    y = y + d_skip.float()[None, :, None, None] * xf
    return y.to(x.dtype), hs


def ssd_scan_tc_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, *, chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the tensor-core variant computes, in plain PyTorch: the
    chunked scan at chunk length ``chunk`` (the kernel's is 128; a ragged
    last chunk zero-filled), float32 but for three roundings to bf16:

    * ``w_j x_j`` (``w_j = e^{cum_last - cum_j} dt_j``), which feeds the
      chunk states and so the final state, as the pair hi + lo, ``hi =
      bf16(w x)``, ``lo = bf16(w x - hi)``;
    * the incoming state ``H_in`` for ``C · H_in`` (it feeds y alone);
    * ``M = mask(C·Bᵀ) e^{cum_l - cum_j} dt_j`` for ``M · x``.

    Arguments and returns as :func:`ssd_scan_ref`."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    r = h // g
    L = chunk
    nc = -(-s // L)
    pad = nc * L - s
    bf16 = torch.bfloat16
    hstate = (torch.zeros((bs, g, r, n, p), dtype=torch.float32,
                          device=x.device) if h0 is None
              else h0.float().reshape(bs, g, r, n, p))
    if nc == 0:
        return torch.zeros_like(x), hstate.reshape(bs, h, n, p)
    a = -torch.exp(a_log.float()).reshape(g, r)
    xc = F.pad(x.float(), (0, 0, 0, pad)).reshape(bs, g, r, nc, L, p)
    dtc = F.pad(dt.float(), (0, pad)).reshape(bs, g, r, nc, L)
    bc = F.pad(b.float(), (0, 0, 0, pad)).reshape(bs, g, nc, L, n)
    cc = F.pad(c.float(), (0, 0, 0, pad)).reshape(bs, g, nc, L, n)
    cum = torch.cumsum(dtc * a[None, :, :, None, None], dim=-1)

    # 1. chunk states from w x as a bf16 pair
    w = torch.exp(cum[..., -1:] - cum) * dtc
    wx = w[..., None] * xc
    hi = wx.to(bf16).float()
    wx2 = hi + (wx - hi).to(bf16).float()
    states = torch.einsum("bgcjn,bgrcjp->bgrcnp", bc, wx2)

    # 2. the carry over the chunks, in float32
    h_in = []
    for ci in range(nc):
        h_in.append(hstate)
        hstate = torch.exp(cum[:, :, :, ci, -1])[..., None, None] * \
            hstate + states[:, :, :, ci]
    h_in = torch.stack(h_in, dim=3).to(bf16).float()

    # 3. outputs: M masked on the exponent before the exp, then in bf16
    cb = torch.einsum("bgcln,bgcjn->bgclj", cc, bc)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tri, float("-inf")))
    m = (cb[:, :, None] * decay * dtc[..., None, :]).to(bf16).float()
    y = torch.einsum("bgcln,bgrcnp->bgrclp", cc, h_in) * \
        torch.exp(cum)[..., None]
    y = y + torch.einsum("bgrclj,bgrcjp->bgrclp", m, xc)
    y = y.reshape(bs, h, nc * L, p)[:, :, :s]
    y = y + d_skip.float()[None, :, None, None] * x.float()
    return y.to(x.dtype), hstate.reshape(bs, h, n, p)
