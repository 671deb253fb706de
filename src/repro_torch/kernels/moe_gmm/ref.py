"""Plain PyTorch version of the MoE grouped-matmul kernel (the oracle).

The mirror of ``repro/kernels/moe_gmm/ref.py``: ``out[e] = act(x[e] @
w1[e]) @ w2[e]`` with both products and the activation in float32 and the
result cast to x.dtype.  swiglu and geglu split w1's output dim as
[gate | up]; JAX's ``gelu(approximate=True)`` is torch's
``gelu(approximate="tanh")``.  The kernel's optional ``rows`` (each
expert's filled rows) zeroes the rows past each fill.  ``h_dtype``
(default None: h stays float32) rounds ``h`` to that dtype once, after
the float32 activation: with ``torch.bfloat16`` it is the plain version
of the kernel's tensor-core variant.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTS = ("swiglu", "geglu", "gelu", "relu2")


def activation_f32(act: str, h: torch.Tensor) -> torch.Tensor:
    """The expert nonlinearity on a float32 ``h`` (gated kinds take the
    fused [gate | up] on the last dim)."""
    if act == "swiglu":
        g, u = torch.chunk(h, 2, dim=-1)
        return F.silu(g) * u
    if act == "geglu":
        g, u = torch.chunk(h, 2, dim=-1)
        return F.gelu(g, approximate="tanh") * u
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(f"moe_gmm: unknown activation {act!r}")


def moe_gmm_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                act: str = "swiglu", rows: Optional[torch.Tensor] = None,
                h_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (E, C, d); w1 (E, d, m·f); w2 (E, f, d) -> (E, C, d) in x.dtype;
    with ``rows`` ((E,) integers), expert e's rows at or past ``rows[e]``
    are zero."""
    h = torch.einsum("ecd,edf->ecf", x.float(), w1.float())
    h = activation_f32(act, h)
    if h_dtype is not None:
        h = h.to(h_dtype).float()
    o = torch.einsum("ecf,efd->ecd", h, w2.float())
    if rows is not None:
        slot = torch.arange(o.shape[1], device=o.device)
        keep = slot[None, :] < rows.to(device=o.device)[:, None]  # (E, C)
        o = torch.where(keep[..., None], o, o.new_zeros(()))
    return o.to(x.dtype)
