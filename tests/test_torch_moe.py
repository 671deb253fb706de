"""The port's MoE path held against the JAX package on the CPU.

The same numpy-seeded inputs go through both packages:

* the plain version of the MoE grouped-matmul kernel, through the port's
  ``moe_gmm`` wrapper on CPU tensors, against the reference's Pallas
  ``moe_gmm_tpu`` in interpret mode and its ``moe_gmm_ref``, over the
  sweep of ``tests/test_kernels.py::test_moe_gmm_sweep`` at that test's
  tolerances (1e-4 float32, 3e-2 bfloat16), plus a ragged capacity and an
  all-zero expert;
* ``router_topk`` and ``moe_block`` on the olmoe-1b-7b and
  moonshot-v1-16b-a3b smoke configs: the expert choices are asserted
  equal first, then the outputs and the aux terms, float32 at 1e-5 (the
  same sums in another order) and bfloat16 at 2e-2.  In bfloat16 the
  port's expert FFN on the CPU (the kernel's plain version) keeps ``h`` in
  float32 where the reference rounds it to bfloat16, so the two differ
  by a few ulps (``BF16_H_ROUNDING`` records the largest difference
  seen); a case with a low capacity factor drops assignments
  (``dropped_frac > 0``); ``moe_block``'s ``rows`` (each expert's filled
  slots, so the kernel skips the empty ones) leave its outputs the same
  bit for bit;
* the plain version with ``rows`` (rows past each fill exactly zero) and
  the kernel's variant choice (bf16 with d, f multiples of 8: the tensor
  cores);
* moonshot's decoder layer with its shared expert, on the reference's
  params carried across;
* the whole bfloat16 forward of both smoke models with the float32 ``h``
  of the port's FFN: at least 95% of the outputs within 2e-2 of the
  reference's (measured: 4.0% and 4.3% beyond it, the largest a token
  whose second-layer routing flips at a near tie; with ``h`` rounded as
  the reference rounds it, ``test_torch_models.py`` holds all of them);
* the port's own init (shapes, the router's 0.1 scale) and the carried
  moe params (keys, shapes, bfloat16 by its bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as r_lm
import repro.models.moe as r_moe
from repro.configs import get_smoke as r_get_smoke
from repro.distributed.comm import local_comm as r_local_comm
from repro.kernels.moe_gmm.kernel import moe_gmm_tpu
from repro.kernels.moe_gmm.ref import moe_gmm_ref as r_moe_gmm_ref
from repro.models.blocks import tp_plan as r_tp_plan
from repro.models.registry import build_model as r_build_model

import repro_torch.models.lm as p_lm
import repro_torch.models.moe as p_moe
from repro_torch.distributed import local_comm
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref, variant
from repro_torch.models.blocks import tp_plan
from repro_torch.models.registry import build_model
from test_torch_models import (DTYPES, _np, _pair, carried_model, port_config,
                               reference_compiled)

RCOMM, PCOMM = r_local_comm(), local_comm()
MOE_ARCHS = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
#: bfloat16: the largest |port - reference| of a moe_block output, and the
#: share of a forward's outputs beyond 2e-2, by case (the reference rounds
#: h to bfloat16 between the products; the port's kernel keeps it in
#: float32)
BF16_H_ROUNDING = {}


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

def _gmm_inputs(e, cap, d, f, act, seed=0):
    mult = 2 if act in ("swiglu", "geglu") else 1
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, cap, d), np.float32),
            (rng.standard_normal((e, d, mult * f)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("e,cap,d,f,block", [(4, 32, 48, 24, 8),
                                             (2, 64, 32, 64, 32)])
def test_moe_gmm_plain_matches_reference(e, cap, d, f, block, act, dtype):
    arrays = [_pair(a, dtype) for a in _gmm_inputs(e, cap, d, f, act)]
    (jx, tx), (jw1, tw1), (jw2, tw2) = arrays
    before = moe_gmm.launches
    got = moe_gmm(tx, tw1, tw2, act=act, block_c=block)
    assert moe_gmm.launches == before          # CPU: the plain version
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (e, cap, d)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    for want in (moe_gmm_tpu(jx, jw1, jw2, act=act, block_c=block,
                             interpret=True),
                 r_moe_gmm_ref(jx, jw1, jw2, act=act)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_moe_gmm_plain_ragged_capacity_and_empty_expert(act):
    """C = 20 (no tile divides it) and expert 1 all zeros: the empty
    expert's rows are exactly 0 (act(0) = 0), the rest match the
    reference's ref."""
    x, w1, w2 = _gmm_inputs(3, 20, 40, 16, act, seed=1)
    x[1] = 0.0
    (jx, tx), (jw1, tw1), (jw2, tw2) = (_pair(a) for a in (x, w1, w2))
    got = moe_gmm_ref(tx, tw1, tw2, act=act)
    assert torch.count_nonzero(got[1]) == 0
    np.testing.assert_allclose(_np(got), _np(r_moe_gmm_ref(jx, jw1, jw2,
                                                           act=act)),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_gmm_plain_rows_zero_past_each_fill(act, dtype):
    """The plain version through the wrapper with ``rows`` (partial fills,
    an expert at 0 rows, one full, one past C): rows past each fill are
    exactly 0 whatever x holds there, the rest equal the call without
    ``rows`` bit for bit and match the reference's ref on x zeroed past
    each fill."""
    cap = 12
    x, w1, w2 = _gmm_inputs(5, cap, 40, 16, act, seed=2)
    fill = [5, 0, cap, 1, cap + 4]
    zeroed = x.copy()
    for e, n in enumerate(fill):
        zeroed[e, n:] = 0.0
    (jz, _), (jw1, tw1), (jw2, tw2) = (_pair(a, dtype)
                                       for a in (zeroed, w1, w2))
    _, tx = _pair(x, dtype)
    rows = torch.tensor(fill, dtype=torch.int32)
    got = moe_gmm(tx, tw1, tw2, act=act, rows=rows)
    full = moe_gmm(tx, tw1, tw2, act=act)
    for e, n in enumerate(fill):
        assert torch.count_nonzero(got[e, n:]) == 0
        assert torch.equal(got[e, :n], full[e, :n])
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(r_moe_gmm_ref(jz, jw1, jw2,
                                                           act=act)),
                               atol=tol, rtol=tol)


def test_moe_gmm_variant_choice():
    """bf16 with d and f multiples of 8 takes the tensor-core variant;
    float32, an unaligned d, or a tensor off a 16-byte boundary the
    CUDA-core one."""
    def pick(dtype, d, f, offset=0):
        x = torch.zeros(2 * 4 * d + offset, dtype=dtype)[offset:]
        x = x[:2 * 4 * d].view(2, 4, d)
        return variant(x, torch.zeros(2, d, 2 * f, dtype=dtype),
                       torch.zeros(2, f, d, dtype=dtype))
    assert pick(torch.bfloat16, 64, 32) == "tc"
    assert pick(torch.bfloat16, 2048, 1024) == "tc"
    assert pick(torch.bfloat16, 40, 24) == "tc"
    assert pick(torch.float32, 64, 32) == "simt"
    assert pick(torch.bfloat16, 100, 8) == "simt"
    assert pick(torch.bfloat16, 64, 32, offset=1) == "simt"


def test_moe_gmm_refuses_what_it_does_not_take():
    """Off the CPU the wrapper launches the kernel, takes the meta
    device's dispatch (the dry run's: the kernel's output, after the
    launch's checks) or raises: a tensor on the meta device never reaches
    the plain version nor a CUDA launch, and an unknown activation
    raises."""
    import repro_torch.kernels.moe_gmm.ops as moe_ops
    x = torch.empty(2, 8, 16, device="meta")
    w1 = torch.empty(2, 16, 32, device="meta")
    w2 = torch.empty(2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        moe_ops._launch(x, w1, w2, "swiglu", None)
    out = moe_gmm(x, w1, w2)
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype
    with pytest.raises(ValueError, match="act"):
        moe_gmm(x, w1, w2, act="tanh")
    with pytest.raises(ValueError, match="unknown activation"):
        moe_gmm_ref(torch.zeros(1, 1, 2), torch.zeros(1, 2, 2),
                    torch.zeros(1, 2, 2), act="tanh")


# ---------------------------------------------------------------------------
# routing and the moe block
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype="float32", **over):
    rcfg = dataclasses.replace(r_get_smoke(arch), dtype=DTYPES[dtype][0],
                               **over)
    return rcfg, port_config(rcfg, DTYPES[dtype][1])


def _moe_params(rcfg, seed):
    """Router, we_in, we_out drawn with numpy, float32: the router wide
    enough that the top-k choices have clear margins."""
    d, e, f = rcfg.d_model, rcfg.n_experts, rcfg.d_ff
    mult = 2 if rcfg.mlp in ("swiglu", "geglu") else 1
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.3,
            "we_in": (rng.standard_normal((e, d, mult * f))
                      / np.sqrt(d)).astype(np.float32),
            "we_out": (rng.standard_normal((e, f, d))
                       / np.sqrt(f)).astype(np.float32)}


def _assert_same_choices(jx, tx, jrouter, trouter, rcfg, pcfg):
    """Both packages' routers pick the same experts in the same order
    (checked before any output is compared)."""
    d = jx.shape[-1]
    jl = jnp.tensordot(jx.reshape(-1, d).astype(jnp.float32),
                       jrouter.astype(jnp.float32), axes=1)
    tl = torch.matmul(tx.reshape(-1, d).float(), trouter.float())
    _, r_exp, _, _ = r_moe.router_topk(jl, rcfg)
    _, p_exp, _, _ = p_moe.router_topk(tl, pcfg)
    assert p_exp.numpy().tolist() == np.asarray(r_exp).tolist()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_topk_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, rcfg.n_experts)).astype(np.float32)
    logits[3, :] = 0.5                         # all tied: lowest ids first
    logits[7, [1, 5]] = 9.0                    # a tie at the top
    want = r_moe.router_topk(jnp.asarray(logits), rcfg)
    got = p_moe.router_topk(torch.from_numpy(logits), pcfg)
    assert got[1].numpy().tolist() == np.asarray(want[1]).tolist()
    assert got[1][3].tolist() == list(range(rcfg.top_k))
    assert got[1][7].tolist()[:2] == [1, 5]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6, rtol=1e-6)
    for k in ("aux_lb", "aux_z"):
        np.testing.assert_allclose(float(got[3][k]), float(want[3][k]),
                                   rtol=1e-5)


def test_capacity_matches_the_reference_formula():
    cfg = p_moe.capacity
    olmoe = _cfgs("olmoe-1b-7b")[1]
    full = dataclasses.replace(olmoe, n_experts=64, top_k=8,
                               capacity_factor=1.25)
    assert cfg(4 * 1024, full) == 640          # olmoe prefill, 4 x 1024
    assert cfg(8, full) == 8                   # a decode step of 8 slots
    assert cfg(64, full) == 16
    assert cfg(12, olmoe) == 8                 # the floor of 8
    assert cfg(100, olmoe) == 56               # ceil(200/8)=25 * 2 -> 56


MOE_BLOCK_CASES = {
    "olmoe": ("olmoe-1b-7b", {}, (6, 2)),
    "moonshot": ("moonshot-v1-16b-a3b", {}, (5, 3)),
    # 64 tokens x top-2 over 8 experts at cf 0.5: 8 slots for ~16 wanted
    "dropping": ("olmoe-1b-7b", {"capacity_factor": 0.5}, (32, 2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_BLOCK_CASES))
def test_moe_block_matches_reference(case, dtype):
    arch, over, (s, b) = MOE_BLOCK_CASES[case]
    rcfg, pcfg = _cfgs(arch, dtype, **over)
    params = _moe_params(rcfg, seed=3)
    jp, tp_ = {}, {}
    for k, v in params.items():
        jp[k], tp_[k] = _pair(v, dtype)
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((s, b, rcfg.d_model), np.float32),
                   dtype)
    _assert_same_choices(jx, tx, jp["router"], tp_["router"], rcfg, pcfg)
    want, waux = reference_compiled(
        lambda x, p: r_moe.moe_block(x, p, rcfg, RCOMM), jx, jp)(jx, jp)
    got, gaux = p_moe.moe_block(tx, tp_, pcfg, PCOMM)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    assert set(gaux) == set(waux) == {"aux_lb", "aux_z", "dropped_frac"}
    for k in gaux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-7)
    if case == "dropping":
        assert float(gaux["dropped_frac"]) > 0.1
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if dtype == "bfloat16":
        BF16_H_ROUNDING[case] = float(np.abs(_np(got) - _np(want)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_BLOCK_CASES))
def test_moe_block_rows_leave_outputs_identical(case, dtype, monkeypatch):
    """moe_block hands the kernel each expert's filled slots (``rows``,
    int32, clamped to the capacity); the block's outputs are the same,
    bit for bit, as with ``rows`` dropped."""
    arch, over, (s, b) = MOE_BLOCK_CASES[case]
    _, pcfg = _cfgs(arch, dtype, **over)
    params = {k: _pair(v, dtype)[1]
              for k, v in _moe_params(_cfgs(arch, **over)[0], 3).items()}
    x = _pair(np.random.default_rng(4).standard_normal(
        (s, b, pcfg.d_model), np.float32), dtype)[1]
    seen = []

    def spy(*args, rows=None, **kw):
        seen.append(rows)
        return moe_gmm(*args, rows=rows, **kw)

    def dropped(*args, rows=None, **kw):
        return moe_gmm(*args, **kw)

    monkeypatch.setattr(p_moe, "moe_gmm", spy)
    got, aux = p_moe.moe_block(x, params, pcfg, PCOMM)
    monkeypatch.setattr(p_moe, "moe_gmm", dropped)
    want, _ = p_moe.moe_block(x, params, pcfg, PCOMM)
    (rows,) = seen
    cap = p_moe.capacity(s * b, pcfg)
    assert rows.dtype == torch.int32 and rows.shape == (pcfg.n_experts,)
    assert int(rows.max()) <= cap and int(rows.sum()) == round(
        s * b * pcfg.top_k * (1 - float(aux["dropped_frac"])))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_expert_layer_matches_reference(dtype):
    """moonshot's decoder layer (attention, moe block, shared expert) on
    the reference's layer-0 params: float32 at 1e-4, as the whole-model
    forward, bfloat16 at 2e-2, both relative to the layer's largest
    output (the reference's init draws σ = 1/sqrt(L) for stacked weights,
    so un-normed outputs reach a few hundred)."""
    rcfg, params, pcfg, pparams = carried_model(
        r_get_smoke("moonshot-v1-16b-a3b"), dtype)
    assert "shared_w_gate" in pparams["layers"]
    jlp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    tlp = p_lm.layer_params(pparams, 0)
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((8, 2, rcfg.d_model), np.float32),
                   dtype)
    plan = r_tp_plan(rcfg, RCOMM.tp)
    want, waux = reference_compiled(
        lambda x, lp: r_lm._decoder_block(x, lp, 0, rcfg, RCOMM, plan, 0),
        jx, jlp)(jx, jlp)
    got, gaux = p_lm._decoder_block(tx, tlp, 0, pcfg, PCOMM,
                                    tp_plan(pcfg, 1), 0)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), atol=tol * scale,
                               rtol=tol)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_forward_with_float32_h(arch):
    """The port's own expert FFN (``h`` in float32) against the
    reference's (``h`` rounded to bfloat16): at least 95% of the final
    hidden states within 2e-2, and the router losses within 2e-2."""
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch),
                                                "bfloat16")
    tok = np.random.default_rng(10).integers(0, rcfg.vocab, size=(12, 2))
    args = (params, jnp.asarray(tok, jnp.int32))
    want, waux = reference_compiled(lambda p, t: r_build_model(rcfg).forward(
        p, {"tokens": t}, remat=False), *args)(*args)
    got, aux = build_model(pcfg, device="cpu").forward(
        pparams, {"tokens": torch.from_numpy(tok.astype(np.int32))})
    g, w = _np(got), _np(want)
    within = np.abs(g - w) <= 2e-2 + 2e-2 * np.abs(w)
    BF16_H_ROUNDING[f"forward/{arch}"] = (float(1 - within.mean()),
                                          float(np.abs(g - w).max()))
    assert within.mean() >= 0.95
    for k in ("aux_lb", "aux_z"):
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=2e-2)


# ---------------------------------------------------------------------------
# params: the port's own init, and the reference's carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_init_moe_shapes_and_router_scale(arch):
    cfg = r_get_smoke(arch)
    want = jax.eval_shape(lambda k: r_build_model(cfg).init(k)[0],
                          jax.random.PRNGKey(0))
    got, specs = build_model(port_config(cfg), device="cpu").init(0)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k, leaf in want["layers"].items():
        assert tuple(got["layers"][k].shape) == leaf.shape, k
    router = got["layers"]["router"]           # (L, d, E), scale 0.1
    sigma = 0.1 / np.sqrt(router.shape[0])     # the reference's fan-in
    assert float(router.abs().max()) <= 2 * sigma + 1e-7
    assert abs(float(router.std()) / sigma - 0.88) < 0.1   # ±2σ truncation
    assert specs["layers"]["we_in"].tp_axis == 0
    assert specs["layers"]["we_out"].fsdp_axis == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_carry_across(arch):
    """router / we_in / we_out / shared_* arrive key for key, shape for
    shape, bfloat16 by its bits."""
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch),
                                                "bfloat16")
    keys = ["router", "we_in", "we_out"] + (
        ["shared_w_gate", "shared_w_up", "shared_w_out"]
        if rcfg.shared_expert_ff else [])
    assert sorted(pparams["layers"]) == sorted(params["layers"])
    for k in keys:
        want = np.asarray(params["layers"][k])
        got = pparams["layers"][k]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), k
