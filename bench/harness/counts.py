"""The yardstick's operation and byte counts, frozen here.

Model FLOPs (``model_flops``): PaLM's convention, 2 FLOPs a weight and
token forward (6 for a training step: the backward twice the forward;
remat's recompute not counted) plus attention's 4 h dh c a token and
layer forward (c the context, no causal halving).  Repairs over the
copy it started from: a MoE layer counts the experts a token is routed
to (top k of E), not all of them; the SSD scan's chunked products are
counted from the configuration's own chunk, state and head sizes; a
prefill call computes the head on its last position only.

Kernel costs (``*_cost``): the work one call of a hand-written kernel
needs on the inputs it was given, as (flops, bytes): every input byte
read once and every output byte written once.  ``moe_gmm`` counts the
capacity rows the router filled (the kernel skips the empty ones),
``flash_attention`` the causal pairs, ``ssd_scan`` the chunk products at
the kernel's own chunk length with the causal half of the square ones.
"""
from __future__ import annotations

from typing import Any, Dict

#: the chunk length of the SSD-scan kernel's tensor-core variant (its
#: work is counted at the chunk it runs)
SSD_KERNEL_CHUNK = 128


def _ssd_layer_flops(m: Dict[str, Any], tokens: int, seq: int) -> float:
    """Forward FLOPs of one layer's chunked SSD (chunk Q, state N, head
    dim P, H heads, G groups) over ``tokens`` tokens in rows of ``seq``:
    a chunk's C Bᵀ (2 Q² N a group), the intra-chunk product (2 Q² P a
    head), the chunk state and the state's output (2 Q N P a head each),
    as full Q x Q products (the model's count, no causal halving)."""
    q = min(int(m["ssm_chunk"]), seq)
    n, p = int(m["ssm_state"]), int(m["ssm_headdim"])
    h = int(m["ssm_expand"]) * int(m["d_model"]) // p
    g = int(m.get("ssm_groups", 1))
    per_token = 2 * q * n * g + 2 * q * p * h + 4 * n * p * h
    return float(per_token * tokens)


def layer_weights(m: Dict[str, Any]) -> int:
    """Weights a token multiplies by in one layer (top-k experts only)."""
    d = int(m["d_model"])
    w = 0
    if m["family"] != "ssm":
        nq, nkv = int(m["n_heads"]), int(m["n_kv_heads"])
        dh = int(m.get("head_dim") or d // nq)
        w += d * nq * dh + 2 * d * nkv * dh + nq * dh * d
    if m["family"] in ("ssm", "hybrid"):
        di = int(m["ssm_expand"]) * d
        n, p = int(m["ssm_state"]), int(m["ssm_headdim"])
        g = int(m.get("ssm_groups", 1))
        w += d * (2 * di + 2 * g * n + di // p) + di * d
    mult = 3 if m.get("mlp", "swiglu") in ("swiglu", "geglu") else 2
    if int(m.get("n_experts", 0)):
        w += int(m["top_k"]) * mult * d * int(m["d_ff"])
        w += d * int(m["n_experts"])                      # router
    elif int(m.get("d_ff", 0)):
        w += mult * d * int(m["d_ff"])
    return w


def model_flops(m: Dict[str, Any], batch: int, seq: int, *,
                train: bool) -> float:
    """Model FLOPs of one prefill call (``train`` False: the head on the
    last position of each row) or one training step on batch x seq."""
    t = batch * seq
    layers = int(m["n_layers"])
    fwd = 2.0 * layers * layer_weights(m) * t
    if m["family"] != "ssm":
        nq = int(m["n_heads"])
        dh = int(m.get("head_dim") or int(m["d_model"]) // nq)
        fwd += 4.0 * layers * nq * dh * seq * t
    if m["family"] in ("ssm", "hybrid"):
        fwd += layers * _ssd_layer_flops(m, t, seq)
    head = 2.0 * int(m["d_model"]) * int(m["vocab"])
    if train:
        return 3.0 * (fwd + head * t)
    return fwd + head * batch


# ---------------------------------------------------------------------------
# kernel costs: (flops, bytes) of one call
# ---------------------------------------------------------------------------

def rmsnorm_cost(rows: int, d: int, x_elem: int, w_elem: int) -> tuple:
    """Read x and w, write y: no products."""
    return 0.0, float(2 * rows * d * x_elem + d * w_elem)


def flash_attention_cost(b: int, hq: int, hkv: int, sq: int, skv: int,
                         dh: int, elem: int, *, causal: bool,
                         q_offset: int = 0) -> tuple:
    """Two products of 2 dh a visible (query, key) pair; q, k, v read and
    o written once.  Causal: query i sees keys j <= q_offset + i."""
    if causal:
        c = max(0, min(sq, skv - q_offset))     # rows that see no cut
        pairs = c * q_offset + c * (c + 1) // 2 + (sq - c) * skv
    else:
        pairs = sq * skv
    flops = 4.0 * b * hq * dh * pairs
    moved = elem * dh * b * (2 * hq * sq + 2 * hkv * skv)
    return flops, float(moved)


def moe_gmm_cost(filled_rows: int, busy_experts: int, d: int, f: int,
                 elem: int, gated: bool = True) -> tuple:
    """The expert FFN over the filled capacity rows: 2 d f a product and
    row, three products gated (gate, up, down); the filled rows of x read
    and of the output written, the weights of each busy expert read
    once."""
    mult = 3 if gated else 2
    flops = 2.0 * filled_rows * d * f * mult
    w_per_expert = (d * f * (2 if gated else 1) + f * d) * elem
    moved = 2 * filled_rows * d * elem + busy_experts * w_per_expert
    return flops, float(moved)


def ssd_scan_cost(bs: int, h: int, s: int, p: int, g: int, n: int,
                  x_elem: int, bc_elem: int, chunk: int = SSD_KERNEL_CHUNK
                  ) -> tuple:
    """The chunked scan at the kernel's chunk L: a chunk's C Bᵀ (L(L+1) n
    a group: its causal half), each head's intra-chunk product (L(L+1)
    p), chunk state and state output (2 L n p each).  Bytes: x, dt, B, C
    read once (dt float32), y written once, the final state (float32)
    written once; A and D are a few bytes."""
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1)
    flops = bs * nc * (g * tri * n + h * (tri * p + 4 * chunk * n * p))
    moved = (2 * bs * s * h * p * x_elem + bs * s * h * 4
             + 2 * bs * s * g * n * bc_elem + bs * h * n * p * 4)
    return float(flops), float(moved)
