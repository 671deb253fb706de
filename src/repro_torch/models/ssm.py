"""Mamba2 SSD (state-space duality, arXiv:2405.21060) on the port.

The mirror of :mod:`repro.models.ssm`.  Per head the layer
computes the linear recurrence

    h_t = a_t · h_{t-1} + dt_t · (B_t ⊗ x_t),      y_t = C_t · h_t + D · x_t

with ``a_t = exp(dt_t · A)`` (A negative).  :func:`ssd_scan` runs it for
CUDA tensors through the SSD-scan kernel (:mod:`repro_torch.kernels.
ssd_scan`, which picks its own chunk length) and for CPU tensors through
:func:`ssd_chunked`, the plain mirror of the reference's chunked
algorithm (intra-chunk scores, chunk states, the scan over chunk
summaries, state to output) with the reference's chunk rule.
:func:`ssd_reference` is the per-step recurrence, :func:`ssd_decode_step`
one token of it for serving (plain, as the reference has no kernel for
it).  Layout is the reference's seq-major view: x (s, b, heads,
headdim); B/C (s, b, groups, state).

:func:`ssm_op` is the full mixer: in-projections (the fused
[w_z | w_x | w_dt] product, split, and B|C), the causal depthwise conv
with SiLU and the dt softplus (one launch of the conv-stage kernel,
:mod:`repro_torch.kernels.ssm_conv`, on the product's column views; on the
CPU its plain version, the reference's shifted sum: not ``F.conv1d``,
which runs float32 through cuDNN in TF32), the scan, the SiLU gate, the
gated RMSNorm over the whole d_inner (where one rank holds it, exactly
``layers.rms_norm``, so the RMSNorm kernel) and the out-projection, its
parts under the telemetry spans ``ssm.proj``, ``ssm.conv``, ``ssm.scan``,
``ssm.gate`` and ``ssm.out``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.telemetry import active
from ..kernels.ssd_scan import ssd_scan as ssd_scan_kernel
from ..kernels.ssd_scan.ref import ssd_scan_ref
from ..kernels.ssm_conv import ssm_conv
# the stage's plain parts, where the tests and the decode step take them
from ..kernels.ssm_conv.ref import causal_conv as _causal_conv  # noqa: F401
from ..kernels.ssm_conv.ref import softplus_dt  # noqa: F401
from .common import ModelConfig, ParamFactory, shard_decisions
from .layers import rms_norm


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
                chunk: int = 64, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in plain PyTorch (``repro/models/ssm.py:33-97``).

    x (s, bs, h, p); dt (s, bs, h) (already softplus'd); a_log (h,);
    b, c (s, bs, g, n); d_skip (h,); h0 (bs, h, n, p).  Returns (y (s, bs,
    h, p) in x.dtype, h_final (bs, h, n, p) float32); float32 inside."""
    s, bs, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    r = h // g                                  # heads per group
    L = min(chunk, s)
    while s % L:
        L -= 1
    nc = s // L

    xf = x.float()
    dtf = dt.float()
    a = -torch.exp(a_log.float())
    la = dtf * a                                # (s, bs, h)
    xbar = xf * dtf[..., None]

    cum = torch.cumsum(la.reshape(nc, L, bs, g, r), dim=1)
    xb_c = xbar.reshape(nc, L, bs, g, r, p)
    b_c = b.float().reshape(nc, L, bs, g, n)
    c_c = c.float().reshape(nc, L, bs, g, n)

    # 1. intra-chunk: the causal mask goes on the exponent, so the masked
    #    pairs (positive exponents) never reach exp
    scores = torch.einsum("clbgn,cjbgn->cljbg", c_c, b_c)
    diff = cum[:, :, None] - cum[:, None, :]            # (nc,L,L,bs,g,r)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~tri[None, :, :, None, None, None],
                                       float("-inf")))
    y_diag = torch.einsum("cljbgr,cjbgrp->clbgrp", scores[..., None] * decay,
                          xb_c)

    # 2. chunk states
    dstate = torch.exp(cum[:, -1:] - cum)               # (nc,L,bs,g,r)
    states = torch.einsum("cjbgn,cjbgrp->cbgrnp", b_c,
                          xb_c * dstate[..., None])

    # 3. the recurrence over chunk summaries
    a_tot = torch.exp(cum[:, -1])                       # (nc,bs,g,r)
    hstate = (torch.zeros((bs, g, r, n, p), dtype=torch.float32,
                          device=x.device) if h0 is None
              else h0.float().reshape(bs, g, r, n, p))
    h_in = []
    for ci in range(nc):
        h_in.append(hstate)
        hstate = a_tot[ci][..., None, None] * hstate + states[ci]
    h_in = torch.stack(h_in)

    # 4. incoming state -> output
    y_off = torch.einsum("clbgn,cbgrnp->clbgrp", c_c, h_in) * \
        torch.exp(cum)[..., None]

    y = (y_diag + y_off).reshape(s, bs, h, p)
    y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), hstate.reshape(bs, h, n, p)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 64, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, the reference's signature and returns.  One SSD-scan
    kernel launch for CUDA tensors; :func:`ssd_chunked` for CPU ones."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a_log, b, c, d_skip, chunk=chunk, h0=h0)
    return ssd_scan_kernel(x, dt.float(), a_log.float(), b, c,
                           d_skip.float(), chunk=chunk, h0=h0)


def ssd_reference(x, dt, a_log, b, c, d_skip, h0=None):
    """The per-step recurrence (same signature and returns as
    :func:`ssd_scan`), through the kernel's plain version."""
    y, h_final = ssd_scan_ref(x.permute(1, 2, 0, 3), dt.permute(1, 2, 0),
                              a_log, b.permute(1, 2, 0, 3),
                              c.permute(1, 2, 0, 3), d_skip, h0=h0)
    return y.permute(2, 0, 1, 3).contiguous(), h_final


def ssd_decode_step(h_state, x_tok, dt_tok, a_log, b_tok, c_tok, d_skip):
    """One-token SSD update for serving.

    h_state (bs, h, n, p); x_tok (bs, h, p); dt_tok (bs, h); b/c_tok (bs,
    g, n).  Returns (h_state' float32, y (bs, h, p) in x_tok's dtype)."""
    h = h_state.shape[1]
    g = b_tok.shape[1]
    r = h // g
    a = -torch.exp(a_log.float())
    bf = b_tok.float().repeat_interleave(r, dim=1)
    cf = c_tok.float().repeat_interleave(r, dim=1)
    dtf = dt_tok.float()
    xf = x_tok.float()
    at = torch.exp(dtf * a)
    upd = bf[..., :, None] * (xf * dtf[..., None])[..., None, :]
    h_new = at[..., None, None] * h_state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", cf, h_new)
    y = y + d_skip.float()[None, :, None] * xf
    return h_new, y.to(x_tok.dtype)


# ---------------------------------------------------------------------------
# the full Mamba2 mixer (in-proj, conv, SSD, gated norm, out-proj)
# ---------------------------------------------------------------------------

def init_ssm(pf: ParamFactory, cfg: ModelConfig, stacked_layers: int = 0,
             prefix: str = "ssm_") -> Dict[str, torch.Tensor]:
    """The mixer's weights: the reference's keys, shapes, specs and draw
    order."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    K = cfg.ssm_conv_kernel
    L = (stacked_layers,) if stacked_layers else ()
    st = bool(stacked_layers)
    shard = shard_decisions(cfg)["ssm"]
    tp1 = 1 if shard else None
    tp0 = 0 if shard else None
    f32 = torch.float32

    def nm(s):
        return prefix + s

    return {
        nm("w_z"): pf.dense(nm("w_z"), L + (d, di), tp_axis=tp1,
                            fsdp_axis=0, stacked=st),
        nm("w_x"): pf.dense(nm("w_x"), L + (d, di), tp_axis=tp1,
                            fsdp_axis=0, stacked=st),
        nm("w_dt"): pf.dense(nm("w_dt"), L + (d, h), tp_axis=tp1,
                             fsdp_axis=0, stacked=st),
        nm("w_bc"): pf.dense(nm("w_bc"), L + (d, 2 * g * n), tp_axis=None,
                             fsdp_axis=0, stacked=st),
        nm("conv_w"): pf.dense(nm("conv_w"), L + (K, di), tp_axis=tp1,
                               fsdp_axis=None, stacked=st, scale=0.5),
        nm("a_log"): pf.zeros(nm("a_log"), L + (h,), tp_axis=tp0,
                              stacked=st, dtype=f32),
        nm("d_skip"): pf.ones(nm("d_skip"), L + (h,), tp_axis=tp0,
                              stacked=st, dtype=f32),
        nm("dt_bias"): pf.zeros(nm("dt_bias"), L + (h,), tp_axis=tp0,
                                stacked=st, dtype=f32),
        nm("norm_w"): pf.ones(nm("norm_w"), L + (di,), tp_axis=tp0,
                              stacked=st),
        nm("w_out"): pf.dense(nm("w_out"), L + (di, d), tp_axis=tp0,
                              fsdp_axis=1, stacked=st),
    }


def ssm_op(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
           comm, plan, *, prefix: str = "ssm_") -> torch.Tensor:
    """x: (s_local, bs, d) pre-normed -> (s_local, bs, d).  Sharded heads:
    the fused ``[z|x|dt]`` projection enters through ``ag_matmul``, B/C
    are projected locally and gathered over the sequence, the scan runs
    on the local heads over the whole sequence (one SSD-scan launch on
    CUDA), the gated RMSNorm's sum of squares is psum'd over the model
    axis (the statistic spans the whole d_inner), and the out-projection
    leaves through ``matmul_rs``.  Replicated heads (hymba's 50):
    everything is gathered, the scan runs on every rank, and only the
    local rows are projected out.  Where a rank holds the whole d_inner
    (one rank, or replicated heads) the gated norm is the RMSNorm kernel.
    With one rank the collectives are identities."""
    def w(name, fsdp_axis=0):
        return comm.weight(p[prefix + name], fsdp_axis=fsdp_axis)

    s_l, bs, _ = x.shape
    di, h = cfg.ssm_d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    tp = comm.tp if plan.shard_ssm_heads else 1
    h_l, di_l = h // tp, di // tp
    tele = active()
    with tele.span("ssm.proj"):
        # the fused [z | x | dt] projection, its columns padded to a
        # multiple of 64 so that the product's rows stay 16-byte aligned
        # for the GEMM and the passes over its views (hymba's 2 * 3200 +
        # 50 = 6450)
        ws = [w("w_z"), w("w_x"), w("w_dt")]
        pad = -(2 * di_l + h_l) % 64
        if pad:
            ws.append(ws[0].new_zeros(ws[0].shape[0], pad))
        fused = torch.cat(ws, dim=1)
        if plan.shard_ssm_heads:
            zxdt = comm.ag_matmul(x, fused)              # (s, bs, ...)
        else:
            zxdt = comm.ag_seq(torch.matmul(x, fused))
        bc = comm.ag_seq(torch.matmul(x, w("w_bc")))
        z, xs, dt_raw = (zxdt[..., :di_l], zxdt[..., di_l:2 * di_l],
                         zxdt[..., 2 * di_l:2 * di_l + h_l])
        b, c = torch.chunk(bc, 2, dim=-1)
        s = zxdt.shape[0]

    with tele.span("ssm.conv"):
        xs, dt = ssm_conv(xs, dt_raw, p[prefix + "conv_w"],
                          p[prefix + "dt_bias"])
    with tele.span("ssm.scan"):
        y, _ = ssd_scan(xs.reshape(s, bs, h_l, cfg.ssm_headdim), dt,
                        p[prefix + "a_log"], b.reshape(s, bs, g, n),
                        c.reshape(s, bs, g, n), p[prefix + "d_skip"],
                        chunk=cfg.ssm_chunk)
    with tele.span("ssm.gate"):
        y = y.reshape(s, bs, di_l)
        y = y * F.silu(z.float()).to(y.dtype)
        if tp == 1:
            y = rms_norm(y, p[prefix + "norm_w"])
        else:
            # the gated RMSNorm over the WHOLE d_inner: the sum of squares
            # is psum'd over the model axis
            yf = y.float()
            ssq = comm.psum_model((yf * yf).sum(dim=-1, keepdim=True))
            yf = yf * torch.rsqrt(ssq / di + 1e-6)
            y = (yf * p[prefix + "norm_w"].float()).to(y.dtype)
    with tele.span("ssm.out"):
        if plan.shard_ssm_heads:
            return comm.matmul_rs(y, w("w_out", 1))
        start = comm.model_index() * s_l
        return torch.matmul(y[start:start + s_l], w("w_out", 1))
