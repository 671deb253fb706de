"""The plain reference: the benchmark's models in float32 PyTorch.

Written from the models' equations, for the benchmark alone: it imports
nothing of the program and takes nothing the program made.  It reads
the weights the harness drew (the program's layout: ``emb``,
``lm_head``, ``final_norm`` and the stacked ``layers`` leaves) and works
out again all that the program derives from them and the tokens: the
router's choices and the capacity slots, the attention, the scan and
its state, the loss, the gradients and the AdamW updates.

Families: ``moe`` (pre-norm attention with RoPE and per-head q/k
RMSNorm, then a top-k MoE of SwiGLU experts with fixed capacity a call)
and ``ssm`` (Mamba2: the fused [z | x | dt] projection, a causal
depthwise conv over x, the chunked SSD scan, the gated RMSNorm, the
out-projection).  Layout is seq-major: tokens (s, b).

``mode`` picks the precision of the linear layers' products: ``"f32"``
(the reference; TF32 off), ``"fp8"`` (the control: both operands
rounded to float8 e4m3 with a scale per tensor, as an fp8 GEMM takes
them, and the gradient that reaches the product in e5m2) or ``"bf16"``
(operands and that gradient rounded to bfloat16, as a bf16 GEMM takes
them); the products accumulate in float32, and attention's own
products, the router, the scan and the head stay float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class Model:
    family: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    tie_embeddings: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_kernel: int = 4
    ssm_groups: int = 1

    @classmethod
    def of(cls, fields: Dict[str, Any]) -> "Model":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to a float8 type under a scale per tensor (its
    largest magnitude at the type's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


def _round16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


#: mode -> (rounding of the operands, of the gradient into the product)
ROUNDING = {"fp8": (_round8, lambda g: _round8(g, torch.float8_e5m2)),
            "bf16": (_round16, _round16)}


class _RoundedLinear(torch.autograd.Function):
    """x @ w as a GEMM of a lower precision runs it: the operands, and in
    the backward the incoming gradient, rounded by ``ROUNDING[mode]``."""

    @staticmethod
    def forward(ctx, x, w, mode):
        rnd, ctx.rnd_grad = ROUNDING[mode]
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.rnd_grad(g)
        gx = gq @ wq.transpose(-1, -2)
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw, None


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x @ w in float32, or as a GEMM in ``mode`` (``ROUNDING``)."""
    w = w.float()
    if mode in ROUNDING:
        return _RoundedLinear.apply(x, w, mode)
    return x @ w


def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS)
    return y if w is None else y * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (s, b, h, dh): rotate the halves [x1, x2] by position."""
    s, dh = x.shape[0], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                  device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ---------------------------------------------------------------------------
# moe family
# ---------------------------------------------------------------------------

def attention(h, lp, m: Model, mode: str) -> torch.Tensor:
    s, b, _ = h.shape
    dh = m.dh
    q = linear(h, lp["wq"], mode).view(s, b, m.n_heads, dh)
    k = linear(h, lp["wk"], mode).view(s, b, m.n_kv_heads, dh)
    v = linear(h, lp["wv"], mode).view(s, b, m.n_kv_heads, dh)
    if m.qk_norm:
        q, k = rmsnorm(q, lp["q_norm"]), rmsnorm(k, lp["k_norm"])
    q, k = rope(q, m.rope_theta), rope(k, m.rope_theta)
    g = m.n_heads // m.n_kv_heads
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = torch.empty_like(q)
    rows = max(1, (1 << 27) // (m.n_heads * s * s))    # bound the scores
    for i in range(0, b, rows):
        qi = q[:, i:i + rows].permute(1, 2, 0, 3)        # (b, h, s, dh)
        ki = k[:, i:i + rows].permute(1, 2, 0, 3)
        vi = v[:, i:i + rows].permute(1, 2, 0, 3)
        sc = (qi @ ki.transpose(-1, -2)) / math.sqrt(dh)
        sc = sc.masked_fill(~causal, NEG)
        out[:, i:i + rows] = (torch.softmax(sc, -1) @ vi).permute(2, 0, 1, 3)
    return linear(out.reshape(s, b, m.n_heads * dh), lp["wo"], mode)


def capacity(tokens: int, m: Model) -> int:
    """Slots an expert holds for a call of ``tokens`` tokens:
    ceil(T k / E) * cf, rounded up to a multiple of 8, at least 8."""
    cap = int(-(-tokens * m.top_k // m.n_experts) * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe(h, lp, m: Model, mode: str) -> torch.Tensor:
    """Top-k routing (weights renormalized over the k), each expert's
    slots filled in token order (token t = row-major over (s, b)), the
    assignments past capacity dropped, SwiGLU experts."""
    s, b, d = h.shape
    t = s * b
    x = h.reshape(t, d)
    probs = torch.softmax(x @ lp["router"].float(), -1)
    w, e = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    flat = e.reshape(-1)                                 # (t k,)
    onehot = F.one_hot(flat, m.n_experts)
    slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = slot < capacity(t, m)
    out = torch.zeros(t, d, dtype=torch.float32, device=h.device)
    tok = torch.arange(t, device=h.device).repeat_interleave(m.top_k)
    wf = w.reshape(-1)
    f = m.d_ff
    for ex in range(m.n_experts):
        sel = torch.nonzero(keep & (flat == ex)).squeeze(1)
        if sel.numel() == 0:
            continue
        xi = x[tok[sel]]
        gu = linear(xi, lp["we_in"][ex], mode)
        hid = F.silu(gu[:, :f]) * gu[:, f:]
        y = linear(hid, lp["we_out"][ex], mode)
        out.index_add_(0, tok[sel], y * wf[sel, None])
    return out.view(s, b, d)


def moe_layer(x, lp, m: Model, mode: str) -> torch.Tensor:
    x = x + attention(rmsnorm(x, lp["norm1"]), lp, m, mode)
    return x + moe(rmsnorm(x, lp["norm2"]), lp, m, mode)


# ---------------------------------------------------------------------------
# ssm family
# ---------------------------------------------------------------------------

def ssd(x, dt, a, bm, cm, dskip, chunk: int) -> torch.Tensor:
    """The SSD scan h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t
    h_t + D x_t, computed chunk by chunk (exact for any chunk).

    x (s, b, h, p); dt (s, b, h); a (h,) negative; bm, cm (s, b, g, n);
    dskip (h,).  Returns y (s, b, h, p)."""
    s, b, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    L = min(chunk, s)
    while s % L:
        L -= 1
    nc = s // L
    r = h // g
    # to (b, h, nc, L, ...)
    X = x.permute(1, 2, 0, 3).reshape(b, h, nc, L, p)
    DT = dt.permute(1, 2, 0).reshape(b, h, nc, L)
    B = bm.permute(1, 2, 0, 3).reshape(b, g, nc, L, n)
    C = cm.permute(1, 2, 0, 3).reshape(b, g, nc, L, n)
    B = B.repeat_interleave(r, dim=1)
    C = C.repeat_interleave(r, dim=1)
    la = DT * a[None, :, None, None]
    cum = torch.cumsum(la, -1)                            # (b, h, nc, L)
    XD = X * DT[..., None]
    seg = cum[..., :, None] - cum[..., None, :]          # (.., L_i, L_j)
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    cb = C @ B.transpose(-1, -2)                          # (.., L_i, L_j)
    y = (cb * decay) @ XD                                 # intra-chunk
    last = cum[..., -1:]                                  # (b, h, nc, 1)
    states = (B * torch.exp(last - cum)[..., None]).transpose(-1, -2) @ XD
    hs = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hs)
        decay = torch.exp(last[:, :, c, 0])[..., None, None]
        hs = decay * hs + states[:, :, c]
    h_in = torch.stack(h_in, 2)                           # (b, h, nc, n, p)
    y = y + (C @ h_in) * torch.exp(cum)[..., None]
    y = y + dskip[None, :, None, None, None] * X
    return y.reshape(b, h, s, p).permute(2, 0, 1, 3)


def ssm_layer(x, lp, m: Model, mode: str) -> torch.Tensor:
    s, b, d = x.shape
    di = m.ssm_expand * d
    nh = di // m.ssm_headdim
    g, n = m.ssm_groups, m.ssm_state
    h = rmsnorm(x, lp["norm1"])
    z = linear(h, lp["ssm_w_z"], mode)
    xs = linear(h, lp["ssm_w_x"], mode)
    dt_raw = linear(h, lp["ssm_w_dt"], mode)
    bc = linear(h, lp["ssm_w_bc"], mode)
    bm, cm = bc[..., :g * n], bc[..., g * n:]
    w = lp["ssm_conv_w"].float()                          # (K, di)
    K = w.shape[0]
    conv = xs * w[K - 1]
    for k in range(1, K):
        conv = conv + F.pad(xs, (0, 0, 0, 0, k, 0))[:s] * w[K - 1 - k]
    xs = F.silu(conv)
    dt = F.softplus(dt_raw + lp["ssm_dt_bias"].float())
    a = -torch.exp(lp["ssm_a_log"].float())
    y = ssd(xs.view(s, b, nh, m.ssm_headdim), dt, a,
            bm.reshape(s, b, g, n), cm.reshape(s, b, g, n),
            lp["ssm_d_skip"].float(), m.ssm_chunk).reshape(s, b, di)
    y = rmsnorm(y * F.silu(z), lp["ssm_norm_w"])
    return x + linear(y, lp["ssm_w_out"], mode)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

#: the layer of each family; a reference module of another family adds
#: its own entry here
LAYERS = {"moe": moe_layer, "ssm": ssm_layer}


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def head_weight(params: Dict[str, Any]) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["emb"]


def hidden(params, m: Model, tokens: torch.Tensor, mode: str = "f32", *,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (s, b, d), float32."""
    x = params["emb"].float()[tokens]
    layer = LAYERS[m.family]
    for i in range(m.n_layers):
        lp = layer_params(params, i)
        if remat:
            x = checkpoint(layer, x, lp, m, mode, use_reentrant=False)
        else:
            x = layer(x, lp, m, mode)
    return rmsnorm(x, params["final_norm"])


def logits(x: torch.Tensor, params, m: Model) -> torch.Tensor:
    """Logits over the real vocabulary, float32."""
    return x @ head_weight(params).float()[:m.vocab].T


@torch.no_grad()
def prefill_last(params, m: Model, tokens: torch.Tensor,
                 mode: str = "f32"):
    """(last hidden (b, d), next-token logits (b, V)) of a prefill call."""
    x = hidden(params, m, tokens, mode)[-1]
    return x, logits(x, params, m)


# ---------------------------------------------------------------------------
# training: the loss, its gradient, AdamW
# ---------------------------------------------------------------------------

def leaf_items(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaf_items(v, path)
        else:
            yield path, v


def _nested(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def loss_and_grad(flat: Dict[str, torch.Tensor], m: Model,
                  tokens: torch.Tensor, labels: torch.Tensor, mode: str,
                  rows: int) -> tuple:
    """(mean cross-entropy, its gradient by leaf) over the batch, taken
    ``rows`` sequences at a time, each layer recomputed in the
    backward."""
    total = tokens.numel()
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    loss = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for i in range(0, tokens.shape[1], rows):
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        params = _nested(leaves)
        x = hidden(params, m, tokens[:, i:i + rows], mode, remat=True)
        lg = logits(x, params, m)
        ce = F.cross_entropy(lg.reshape(-1, m.vocab),
                             labels[:, i:i + rows].reshape(-1),
                             reduction="sum") / total
        got = torch.autograd.grad(ce, list(leaves.values()),
                                  allow_unused=True)
        for k, gk in zip(leaves, got):
            if gk is not None:
                grads[k] += gk
        loss += ce.detach().double()
    return loss.item(), grads


def decays(path: str) -> bool:
    """Weight decay on every leaf but norms, biases, A and D."""
    low = path.lower()
    return not any(t in low for t in ("norm", "bias", "a_log", "d_skip"))


def train_steps(params0: Dict[str, Any], m: Model,
                batches: Sequence[Dict[str, torch.Tensor]],
                opt: Dict[str, float], mode: str = "f32", rows: int = 2
                ) -> Dict[str, Any]:
    """AdamW steps from ``params0`` on ``batches``: the loss of each step,
    the first step's gradient as the optimizer takes it (after clipping
    to the global norm: each leaf's norm, and the leaves), and the norm by
    leaf of each parameter's change after the last step."""
    lr, b1, b2 = opt["lr"], opt["b1"], opt["b2"]
    eps, wd, clip = opt["eps"], opt["weight_decay"], opt["max_grad_norm"]
    p = {k: v.detach().float().clone() for k, v in leaf_items(params0)}
    start = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    first_g: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches, start=1):
        loss, g = loss_and_grad(p, m, batch["tokens"], batch["labels"],
                                mode, rows)
        losses.append(loss)
        gn = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
        scale = min(1.0, clip / max(gn.item(), 1e-9))
        with torch.no_grad():
            if step == 1:
                first_g = {k: v * scale for k, v in g.items()}
                first = {k: v.norm().item() for k, v in first_g.items()}
            b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
            for k in p:
                gk = g[k] * scale
                mu[k].mul_(b1).add_(gk, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                upd = (mu[k] / b1c) / (torch.sqrt(nu[k] / b2c) + eps)
                if wd and decays(k):
                    upd = upd + wd * p[k]
                p[k] -= lr * upd
        del g
    change = {k: (p[k] - start[k]).norm().item() for k in p}
    return {"loss": losses, "grad": first, "change": change,
            "grad_tensors": first_g}
