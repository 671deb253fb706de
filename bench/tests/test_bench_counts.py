"""The frozen counts against hand counts at the cells' shapes."""
import json
from pathlib import Path

import pytest
import torch

from bench.harness import calls, counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_olmoe_layer_counts_routed_experts_only():
    m = model("olmoe-1b-7b")
    attn = 4 * 2048 * 2048                 # q, k, v, o at 16 x 128
    experts = 8 * 3 * 2048 * 1024          # top-8 of 64, SwiGLU
    router = 2048 * 64
    assert counts.layer_weights(m) == attn + experts + router == 67_239_936


def test_olmoe_prefill_flops_by_hand():
    m = model("olmoe-1b-7b")
    b, s = 16, 512
    t = b * s
    want = (2 * 16 * 67_239_936 * t            # weights, 16 layers
            + 4 * 16 * 16 * 128 * s * t        # attention, no halving
            + 2 * 2048 * 50304 * b)            # head on the last position
    assert counts.model_flops(m, b, s, train=False) == pytest.approx(want)


def test_mamba2_ssd_chunk_products_by_hand():
    m = model("mamba2-370m")
    # chunk 256, state 128, head dim 64, 32 heads, 1 group, a token:
    # C B^T 2*256*128, intra 2*256*64*32, state and output 4*128*64*32
    per_token = 65_536 + 1_048_576 + 1_048_576
    assert counts._ssd_layer_flops(m, 1, 2048) == per_token
    proj = 1024 * (2 * 2048 + 2 * 128 + 32) + 2048 * 1024
    assert counts.layer_weights(m) == proj == 6_586_368
    b, s = 32, 2048
    t = b * s
    fwd = 48 * (2 * proj + per_token) * t
    head = 2 * 1024 * 50280 * t
    assert counts.model_flops(m, b, s, train=True) == pytest.approx(
        3 * (fwd + head))


def test_moe_gmm_counts_filled_rows():
    # 3 experts, capacity 8; rows filled 5, 0, 2: 7 rows, 2 busy experts
    d, f = 16, 8
    flops, nbytes = counts.moe_gmm_cost(7, 2, d, f, 2)
    assert flops == 2 * 7 * d * f * 3
    assert nbytes == 2 * 7 * d * 2 + 2 * (d * 2 * f + f * d) * 2
    x = torch.zeros(3, 8, d, dtype=torch.bfloat16)
    w1 = torch.zeros(3, d, 2 * f, dtype=torch.bfloat16)
    w2 = torch.zeros(3, f, d, dtype=torch.bfloat16)
    rec = calls._moe(x, w1, w2, "swiglu", torch.tensor([5, 0, 2]))
    assert (int(rec[1]), int(rec[2])) == (7, 2)


def test_flash_causal_pairs():
    flops, nbytes = counts.flash_attention_cost(1, 1, 1, 4, 4, 8, 2,
                                                causal=True)
    assert flops == 4 * 8 * 10                 # 1 + 2 + 3 + 4 pairs
    assert nbytes == 2 * 8 * 4 * 4
    full, _ = counts.flash_attention_cost(2, 16, 16, 4096, 4096, 128, 2,
                                          causal=False)
    half, _ = counts.flash_attention_cost(2, 16, 16, 4096, 4096, 128, 2,
                                          causal=True)
    assert half == pytest.approx(full * 4097 / 8192)


def test_ssd_kernel_cost_by_hand():
    flops, nbytes = counts.ssd_scan_cost(4, 32, 2048, 64, 1, 128, 2, 2)
    L, nc = 128, 16
    want = 4 * nc * (L * (L + 1) * 128
                     + 32 * (L * (L + 1) * 64 + 4 * L * 128 * 64))
    assert flops == want
    assert nbytes == (2 * 4 * 2048 * 32 * 64 * 2 + 4 * 2048 * 32 * 4
                      + 2 * 4 * 2048 * 128 * 2 + 4 * 32 * 128 * 64 * 4)
