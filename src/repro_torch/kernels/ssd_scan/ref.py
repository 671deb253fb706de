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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
