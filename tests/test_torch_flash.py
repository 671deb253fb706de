"""B2's tensor-core variant, on the CPU: what decides it and what it
computes.

* ``variant()``'s choice over dtype x head dim: bf16 whose head dim pads
  to 64, 128 or 256 takes ``"tc"``, everything else ``"simt"``, whatever
  the layout (a dispatch, not a fallback: both raise on failure);
* the plain version of what ``"tc"`` computes,
  ``flash_attention_ref(..., p_dtype=torch.bfloat16)`` (P rounded to bf16
  for the product with v, the exp-sum from the float32 P), against the
  reference's Pallas kernel in interpret mode at the tc head dims, GQA 1,
  4 and 5, causal, window and no-key rows, within bf16's 2e-2: the same
  numpy inputs through both;
* ``tma_geometry()``, the tensor maps' dims and byte strides, for the
  kernel layout and the seq-major views the model path hands over.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_tpu

from repro_torch.kernels.flash_attention import (TC_HEAD_DIMS,
                                                 flash_attention_ref,
                                                 tma_geometry, variant)


def _qkv(dtype, dh, hq=4, hkv=2, s=8, offset=0):
    """(b, h, s, dh) q, k, v; q starts ``offset`` elements into its
    storage."""
    q = torch.zeros(2 * hq * s * dh + offset, dtype=dtype)[offset:]
    q = q[:2 * hq * s * dh].view(2, hq, s, dh)
    k = torch.zeros(2, hkv, s, dh, dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [16, 24, 64, 96, 128, 256])
def test_variant_choice(dtype, dh):
    """bf16 at a padded head dim of 64, 128 or 256 (dh 96 pads to 128)
    takes the tensor cores; float32 and the padded head dims 16 and 32
    (dh 24 pads to 32) the CUDA cores."""
    want = "tc" if dtype == torch.bfloat16 and dh in (64, 96, 128, 256) \
        else "simt"
    assert variant(*_qkv(dtype, dh)) == want


def test_variant_choice_by_layout():
    """Layout plays no part in the choice: a view off a 16-byte boundary,
    one whose head dim is not contiguous (both copied before the launch),
    the seq-major views of the model path and a padded head dim all take
    "tc" in bf16, and "simt" in float32."""
    bf16 = torch.bfloat16
    assert variant(*_qkv(bf16, 64, offset=1)) == "tc"
    assert variant(*_qkv(bf16, 64, offset=8)) == "tc"
    assert variant(*_qkv(torch.float32, 64, offset=1)) == "simt"
    _, k, v = _qkv(bf16, 128)
    q = torch.zeros(2, 4, 128, 8, dtype=bf16).transpose(2, 3)
    assert variant(q, k, v) == "tc"
    assert variant(*_qkv(bf16, 96, offset=1)) == "tc"
    s, b, h, dh = 16, 2, 4, 256
    seq = [torch.zeros(s, b, hh, dh, dtype=bf16).permute(1, 2, 0, 3)
           for hh in (h, 1, 1)]
    assert variant(*seq) == "tc"


def test_tma_geometry():
    """dims (dh, s, h, b) innermost first, then the byte strides of s, h
    and b: the kernel layout, a seq-major view, a head dim of size 1."""
    t = torch.zeros(2, 4, 10, 64, dtype=torch.bfloat16)
    assert tma_geometry(t) == (64, 10, 4, 2, 128, 10 * 128, 4 * 10 * 128)
    seq = torch.zeros(10, 2, 4, 128, dtype=torch.bfloat16)
    assert tma_geometry(seq.permute(1, 2, 0, 3)) == \
        (128, 10, 4, 2, 2 * 4 * 256, 256, 4 * 256)
    one = torch.zeros(10, 2, 1, 256, dtype=torch.bfloat16)
    assert tma_geometry(one.permute(1, 2, 0, 3)) == \
        (256, 10, 1, 2, 2 * 512, 512, 512)
    with pytest.raises(ValueError, match="contiguous"):
        tma_geometry(t.transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte"):
        tma_geometry(torch.zeros(1 + 2 * 4 * 10 * 64, dtype=torch.bfloat16)
                     [1:].view(2, 4, 10, 64))
    with pytest.raises(ValueError, match="16-byte"):
        tma_geometry(torch.zeros(2, 4, 10, 68,
                                 dtype=torch.bfloat16)[..., :64])


#: (sq, skv, causal, window, q_offset): the causal triangle, a window
#: band, and rows past the keys' window (positions >= 31 see no key)
MASKS = {"causal": (64, 64, True, 0, 0), "window": (64, 64, True, 16, 0),
         "no_key_rows": (40, 24, True, 8, 20)}


@pytest.mark.parametrize("dh", TC_HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 5])
@pytest.mark.parametrize("mask", list(MASKS))
def test_bf16_p_plain_matches_pallas(dh, group, mask):
    """P rounded to bf16 (the tensor-core variant's arithmetic) stays
    within bf16's 2e-2 of the reference, which keeps P in float32."""
    sq, skv, causal, window, q_offset = MASKS[mask]
    hkv = 1 if group > 1 else 2
    rng = np.random.default_rng(dh + group)
    arrays = [rng.standard_normal(shape, np.float32)
              for shape in ((1, group * hkv, sq, dh), (1, hkv, skv, dh),
                            (1, hkv, skv, dh))]
    want = flash_attention_tpu(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in arrays),
                               causal=causal, window=window,
                               q_offset=q_offset, block_q=32, block_k=32,
                               interpret=True)
    got = flash_attention_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in arrays),
                              causal=causal, window=window,
                              q_offset=q_offset, p_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    if mask == "no_key_rows":          # the uniform average over all keys
        v = torch.from_numpy(arrays[2]).to(torch.bfloat16).float()
        uniform = v[0].mean(dim=1)                    # (hkv, dh)
        rows = got.float()[0, :, 11:].reshape(hkv, group, sq - 11, dh)
        torch.testing.assert_close(rows, uniform[:, None, None].expand_as(
            rows), atol=2e-2, rtol=2e-2)
