"""The port's model stack held against the JAX package on the CPU.

The same numpy-seeded inputs (and, for whole models, the reference's own
params carried across with ``params_from_numpy``) go through both
packages:

* the plain versions of the flash-attention and RMSNorm kernels, through
  the port's ``ops`` wrappers on CPU tensors, against the reference's
  Pallas kernels in interpret mode over the sweeps of
  ``tests/test_kernels.py`` at that file's tolerance (5e-5 f32, 2e-2
  bf16);
* the seq-major ``flash_attention`` and ``decode_attention`` of
  ``models/attention.py`` against the reference's;
* the layers (norms, RoPE with a q offset, the four MLP activations,
  embedding, the decode head, greedy sampling with a tie);
* ``forward`` for the dense, parallel and swa-qk configs of
  ``tests/test_decode.py``, the gemma3-1b and olmo-1b smoke configs and
  the olmoe-1b-7b and moonshot-v1-16b-a3b (moe) smoke configs: float32
  at atol = rtol = 1e-4 (the same sums in another order), bfloat16 at
  2e-2; the aux terms (router losses, dropped fraction) at 1e-5.  A moe
  model in bfloat16 runs its expert FFN with ``h`` rounded to bfloat16
  between the products, as the reference's einsums round it
  (:func:`rounding_h_gmm`, as the kernel's bf16 tensor-core variant does
  on the card); the port's plain version keeps ``h`` in float32, and
  ``tests/test_torch_moe.py`` measures what that changes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as r_attn
import repro.models.layers as r_layers
from repro.configs import ARCH_NAMES
from repro.configs import cells as r_cells
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.distributed.comm import local_comm as r_local_comm
from repro.kernels.flash_attention.kernel import flash_attention_tpu
from repro.kernels.rmsnorm.kernel import rmsnorm_tpu
from repro.models.common import ModelConfig as RConfig
from repro.models.registry import build_model as r_build_model

import repro_torch.configs as p_configs
import repro_torch.models.attention as p_attn
import repro_torch.models.layers as p_layers
import repro_torch.models.moe as p_moe
from repro_torch.distributed import local_comm
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.common import ModelConfig as PConfig
from repro_torch.models.registry import build_model, params_from_numpy

RCOMM, PCOMM = r_local_comm(), local_comm()
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 5e-5


def _pair(x: np.ndarray, dtype="float32"):
    """The same numpy values as a JAX array and a CPU tensor of one
    dtype (both round float32 -> bfloat16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def port_config(cfg: RConfig, dtype=torch.float32) -> PConfig:
    """The reference config's fields, with a torch dtype."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(RConfig) if f.name != "dtype"}
    return PConfig(**fields, dtype=dtype)


# ---------------------------------------------------------------------------
# configs: the same data in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_match_reference(arch):
    for ref, port in ((r_get_config(arch), p_configs.get_config(arch)),
                      (r_get_smoke(arch), p_configs.get_smoke(arch))):
        assert port == port_config(ref, torch.bfloat16)
        assert ref.dtype == jnp.bfloat16
        assert port.param_count() == ref.param_count()
    assert p_configs.cells([arch]) == r_cells([arch])


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,q_offset", [
    (2, 4, 2, 64, 64, 16, True, 0, 0),
    (1, 4, 1, 128, 128, 32, True, 32, 0),
    (2, 2, 2, 64, 128, 16, True, 0, 64),      # SP: local q, longer kv
    (1, 6, 3, 96, 96, 16, False, 0, 0),       # encoder (bidirectional)
    (1, 8, 8, 32, 32, 64, True, 8, 0),        # MHA + window
])
def test_flash_attention_plain_matches_pallas(b, hq, hkv, sq, skv, dh,
                                              causal, window, q_offset,
                                              dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((b, hq, sq, dh), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((b, hkv, skv, dh), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((b, hkv, skv, dh), np.float32), dtype)
    want = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                               q_offset=q_offset, block_q=32, block_k=32,
                               interpret=True)
    got = flash_attention_bhsd(tq, tk, tv, causal=causal, window=window,
                               q_offset=q_offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,block", [(8, 64, 4), (64, 128, 16),
                                          (100, 96, 32), (1, 256, 8),
                                          # the served paths' widths
                                          (8, 256, 4), (6, 1152, 2),
                                          (5, 1600, 5), (4, 2048, 2),
                                          (3, 3200, 3)])
def test_rmsnorm_plain_matches_pallas(rows, d, block, dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((rows, d), np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((d,), np.float32), dtype)
    want = rmsnorm_tpu(jx, jw, block_rows=block, interpret=True)
    got = rmsnorm(tx, tw)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_flash_attention_sees_no_key_averages_uniformly():
    """Rows past the keys' window see no key: both packages average every
    key uniformly (masked scores are -1e30, never -inf)."""
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng.standard_normal((1, 2, 16, 16), np.float32))
    jk, tk = _pair(rng.standard_normal((1, 1, 8, 16), np.float32))
    jv, tv = _pair(rng.standard_normal((1, 1, 8, 16), np.float32))
    want = flash_attention_tpu(jq, jk, jv, causal=True, window=4,
                               q_offset=6, block_q=8, block_k=8,
                               interpret=True)
    got = flash_attention_bhsd(tq, tk, tv, causal=True, window=4, q_offset=6)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=5e-5)
    # q rows 6.. (positions 12..21) see no key: the mean of all of v
    uniform = tv[0, 0].mean(dim=0).numpy()
    np.testing.assert_allclose(_np(got)[0, :, 6:], np.broadcast_to(
        uniform, (2, 10, 16)), atol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (True, 6, 0),
                                                    (False, 0, 0),
                                                    (True, 0, 16)])
def test_seq_major_flash_attention_matches_reference(causal, window,
                                                     q_offset):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((24, 2, 4, 16), np.float32))
    jk, tk = _pair(rng.standard_normal((40, 2, 2, 16), np.float32))
    jv, tv = _pair(rng.standard_normal((40, 2, 2, 16), np.float32))
    want = r_attn.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  q_offset=q_offset, block_q=8, block_k=8)
    got = p_attn.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=5e-5)
    ref = p_attn.attention_reference(tq, tk, tv, causal=causal,
                                     window=window, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("valid_len,window,q_pos", [(None, 0, None),
                                                    (20, 0, 19),
                                                    (20, 6, 19)])
def test_decode_attention_matches_reference(valid_len, window, q_pos):
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng.standard_normal((2, 4, 32), np.float32))
    jk, tk = _pair(rng.standard_normal((24, 2, 2, 32), np.float32))
    jv, tv = _pair(rng.standard_normal((24, 2, 2, 32), np.float32))
    want = r_attn.decode_attention(jq, jk, jv, valid_len=valid_len,
                                   window=window, q_pos=q_pos, block_k=8)
    got = p_attn.decode_attention(tq, tk, tv, valid_len=valid_len,
                                  window=window, q_pos=q_pos)
    # m is the same max; num and l are scaled by it, so compare the
    # normalized output and the max
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=1e-5)
    out_w = r_attn.combine_decode_partials(*want, RCOMM)
    out_g = p_attn.combine_decode_partials(*got, PCOMM)
    np.testing.assert_allclose(_np(out_g), _np(out_w), atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norms_match_reference(kind, dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((6, 3, 40), np.float32) * 3, dtype)
    jw, tw = _pair(rng.standard_normal((40,), np.float32), dtype)
    tol = _tol(dtype) if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(p_layers.apply_norm(kind, tx, tw)),
                               _np(r_layers.apply_norm(kind, jx, jw)),
                               atol=tol, rtol=tol)
    if kind == "rmsnorm":                 # the w=None case
        np.testing.assert_allclose(_np(p_layers.rms_norm(tx, None)),
                                   _np(r_layers.rms_norm(jx, None)),
                                   atol=tol, rtol=tol)


def test_apply_rope_with_q_offset():
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.standard_normal((12, 2, 3, 32), np.float32))
    pos = np.arange(12, dtype=np.int32) + 40
    want = r_layers.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    got = p_layers.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_activation_matches_reference(kind):
    """tanh-GELU for gelu and geglu (jax's default), gate first."""
    rng = np.random.default_rng(7)
    jh, th = _pair(rng.standard_normal((5, 2, 24), np.float32) * 2)
    np.testing.assert_allclose(_np(p_layers.mlp_activation(kind, th)),
                               _np(r_layers.mlp_activation(kind, jh)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_tokens_matches_reference(scale):
    rng = np.random.default_rng(8)
    jemb, temb = _pair(rng.standard_normal((64, 16), np.float32))
    tok = rng.integers(0, 64, size=(7, 3)).astype(np.int32)
    want = r_layers.embed_tokens(jnp.asarray(tok), jemb, RCOMM,
                                 scale_by_sqrt_dim=scale)
    got = p_layers.embed_tokens(torch.from_numpy(tok), temb, PCOMM,
                                scale_by_sqrt_dim=scale)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def test_lm_head_logits_masks_padded_vocab():
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng.standard_normal((3, 16), np.float32))
    jemb, temb = _pair(rng.standard_normal((128, 16), np.float32))
    want = r_layers.lm_head_logits(jx, jemb, RCOMM, real_vocab=100)
    got = p_layers.lm_head_logits(tx, temb, PCOMM, real_vocab=100)
    assert got.dtype == torch.float32
    assert (got[:, 100:] == -1e30).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_greedy_sample_ties_go_to_the_lowest_id():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 5.0                   # a tie
    logits[1, 9] = 1.0
    logits[2, [0, 1]] = -1.0                  # max 0 at ids 2..9
    want = np.asarray(r_layers.greedy_sample(jnp.asarray(logits), RCOMM))
    got = p_layers.greedy_sample(torch.from_numpy(logits), PCOMM)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist() == [2, 9, 2]


# ---------------------------------------------------------------------------
# whole models, with the reference's params carried across
# ---------------------------------------------------------------------------

F = jnp.float32
MODEL_CASES = {
    "dense": RConfig(name="dense", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                     tp_target=4, dtype=F),
    "parallel": RConfig(name="parallel", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab=128, tp_target=4, dtype=F, norm="layernorm",
                        parallel_block=True, tie_embeddings=True),
    "swa-qk": RConfig(name="swa-qk", family="dense", n_layers=3, d_model=64,
                      n_heads=2, n_kv_heads=1, d_ff=128, vocab=128,
                      tp_target=4, dtype=F, head_dim=32, sliding_window=6,
                      swa_every_nth_global=3, qk_norm=True),
    "gemma3-1b-smoke": r_get_smoke("gemma3-1b"),
    "olmo-1b-smoke": r_get_smoke("olmo-1b"),
    "olmoe-1b-7b-smoke": r_get_smoke("olmoe-1b-7b"),
    "moonshot-v1-16b-a3b-smoke": r_get_smoke("moonshot-v1-16b-a3b"),
    "minitron-8b-smoke": r_get_smoke("minitron-8b"),
    "command-r-plus-104b-smoke": r_get_smoke("command-r-plus-104b"),
}


def reference_compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's excess precision
    off.  By default XLA may keep a fused chain of bfloat16 ops in float32
    and round once at its end; the reference's code (and the port) round
    at every op, and with the option off the two agree to a bfloat16 ulp
    or two instead of drifting apart through the layers."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def rounding_h_gmm(x, w1, w2, *, act="swiglu", rows=None):
    """The reference moe_block's expert FFN (``models/moe.py:123-127``):
    ``h`` rounded to x.dtype after the first product and through the
    activation, where the port's plain version keeps it in float32.
    Takes the kernel's ``rows`` (each expert's filled slots) and zeroes
    the rows past each fill, as the kernel does."""
    h = torch.einsum("ecd,edf->ecf", x.float(), w1.float()).to(x.dtype)
    h = p_layers.mlp_activation(act, h)
    o = torch.einsum("ecf,efd->ecd", h.float(), w2.float())
    if rows is not None:
        o = o * (torch.arange(o.shape[1]) < rows[:, None])[..., None]
    return o.to(x.dtype)


def carried_model(cfg: RConfig, dtype: str, seed: int = 0):
    """(reference cfg, params) and (port cfg, carried params) in dtype."""
    jd, td = DTYPES[dtype]
    rcfg = dataclasses.replace(cfg, dtype=jd)
    params, _ = r_build_model(rcfg).init(jax.random.PRNGKey(seed))
    pcfg = port_config(rcfg, td)
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                             params),
                                device="cpu")
    return rcfg, params, pcfg, pparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_forward_matches_reference(name, dtype, monkeypatch):
    rcfg, params, pcfg, pparams = carried_model(MODEL_CASES[name], dtype)
    if rcfg.family == "moe" and dtype == "bfloat16":
        monkeypatch.setattr(p_moe, "moe_gmm", rounding_h_gmm)
    tok = np.random.default_rng(10).integers(0, rcfg.vocab, size=(12, 2))
    args = (params, jnp.asarray(tok, jnp.int32))
    want, waux = reference_compiled(lambda p, t: r_build_model(rcfg).forward(
        p, {"tokens": t}, remat=False), *args)(*args)
    got, aux = build_model(pcfg, device="cpu").forward(
        pparams, {"tokens": torch.from_numpy(tok.astype(np.int32))})
    assert got.shape == want.shape and got.dtype == DTYPES[dtype][1]
    assert set(aux) == set(waux) == {"aux_lb", "aux_z", "dropped_frac"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-7)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_params_carry_bfloat16_by_bits():
    """bf16 arrives as ml_dtypes.bfloat16; the carrier keeps its bits."""
    rcfg, params, pcfg, pparams = carried_model(MODEL_CASES["swa-qk"],
                                                "bfloat16")
    wq = np.asarray(params["layers"]["wq"])
    assert wq.dtype.name == "bfloat16"
    got = pparams["layers"]["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == wq.shape
    assert np.array_equal(got.view(torch.int16).numpy(), wq.view(np.int16))
    assert sorted(pparams["layers"]) == sorted(params["layers"])


def test_port_init_shapes_and_scale():
    """The port's own init: the reference's keys and shapes, and the
    truncated normal's scale (σ = 1/sqrt(shape[0]), cut at ±2σ)."""
    cfg = MODEL_CASES["swa-qk"]
    want = jax.eval_shape(lambda k: r_build_model(cfg).init(k)[0],
                          jax.random.PRNGKey(0))
    pcfg = port_config(cfg)
    got, specs = build_model(pcfg, device="cpu").init(0)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    emb = got["emb"]
    sigma = 1.0 / np.sqrt(emb.shape[0])
    assert float(emb.abs().max()) <= 2 * sigma + 1e-6
    assert abs(float(emb.std()) / sigma - 0.88) < 0.05   # ±2σ truncation
    assert specs["layers"]["wq"].fsdp_axis == 0
    assert torch.equal(got["layers"]["q_norm"], torch.ones(3, 32))
