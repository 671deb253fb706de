"""The port's ssm and hybrid paths held against the JAX package on the CPU.

The same numpy-seeded inputs (for whole models, the reference's own params
carried across with ``params_from_numpy``) go through both packages:

* the SSD-scan kernel's plain version (``kernels/ssd_scan/ref.py``, the
  per-step recurrence) against the reference's ``ssd_scan_ref`` and its
  Pallas ``ssd_scan_tpu`` in interpret mode over the cases of
  ``tests/test_kernels.py::test_ssd_sweep`` (float32 5e-4, bfloat16 5e-2,
  that test's tolerances), and the seq-major adapter against the
  reference's;
* the plain version of the kernel's tensor-core variant
  (``ssd_scan_tc_ref``: the chunked scan with w·x as a bf16 pair, H_in
  and M rounded to bf16) against the same references at the same
  tolerances (y 5e-2, the final state 5e-4), at the kernel's chunk and a
  short one, with ragged s, s = 1, h0 in and a large dt; the variant rule
  (``variant``) on the served and sweep shapes and the strided-view rule
  (``rows_aligned``), which run on the CPU because they are pure;
* ``models/ssm.py``: ``ssd_scan`` (y and the final state, with and
  without h0, ragged lengths where the chunk rule steps down, s = 1,
  groups > 1) against the reference's ``ssd_scan`` and ``ssd_reference``
  at 1e-4 in float32; ``ssd_decode_step``, ``_causal_conv`` and
  ``ssm_op`` (float32 1e-4, bfloat16 2e-2, the reference compiled with
  XLA's excess precision off);
* ``forward`` of the mamba2-370m and hymba-1.5b smoke configs, several
  teacher-forced ``serve_step``s (tokens, SSM state, conv tail and K/V)
  and ``make_prefill_step`` against the reference's, and the launcher's
  token stream against the reference launcher loop's;
* the port's own ``init_ssm``: the reference's keys and shapes, and its
  scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as r_ssm
from repro.configs import get_smoke as r_get_smoke
from repro.distributed.comm import local_comm as r_local_comm
from repro.kernels.ssd_scan.kernel import ssd_scan_tpu
from repro.kernels.ssd_scan.ops import ssd_scan as r_ssd_scan_ops
from repro.kernels.ssd_scan.ref import ssd_scan_ref as r_ssd_scan_ref
from repro.models.blocks import tp_plan as r_tp_plan
from repro.models.registry import build_model as r_build_model
from repro.serving.engine import init_cache as r_init_cache
from repro.serving.engine import make_prefill_step as r_make_prefill_step
from repro.serving.engine import make_serve_step as r_make_serve_step

import repro_torch.models.ssm as p_ssm
from repro_torch.distributed import local_comm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import (TC_CHUNK, rows_aligned, ssd_scan,
                                          ssd_scan_bhsp, ssd_scan_ref,
                                          ssd_scan_tc_ref, tc_scratch_bytes,
                                          variant)
from repro_torch.kernels.ssd_scan.ops import _tc_view
from repro_torch.models.blocks import tp_plan
from repro_torch.models.registry import build_model
from repro_torch.serving import init_cache, make_prefill_step, \
    make_serve_step
from test_torch_models import (DTYPES, _np, _pair, carried_model,
                               port_config, reference_compiled)
from test_torch_serving import _launcher_loops_agree

ARCHS = ["mamba2-370m", "hymba-1.5b"]


def _ssd_inputs(rng, bs, h, s, p, g, n, dtype, *, seq_major=False,
                dt_scale=1.0):
    """The sweep's distributions (x ~ N(0,1), dt = softplus(N(0,1)), a_log
    ~ N(0,.25), B/C ~ N(0,.09), D ~ N(0,1)) from numpy, as (jax, torch)
    pairs; dt float32 unless ``dtype`` casts it as the sweep does."""
    def shape(*dims):            # dims in the kernel's order (bs, h, s, ...)
        return (dims[2], dims[0], dims[1]) + dims[3:] if seq_major else dims

    x = rng.standard_normal(shape(bs, h, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(shape(bs, h, s)))) * dt_scale
    a_log = rng.standard_normal(h).astype(np.float32) * 0.5
    b = rng.standard_normal(shape(bs, g, s, n)).astype(np.float32) * 0.3
    c = rng.standard_normal(shape(bs, g, s, n)).astype(np.float32) * 0.3
    d = rng.standard_normal(h).astype(np.float32)
    return (_pair(x, dtype), _pair(dt.astype(np.float32), dtype),
            _pair(a_log), _pair(b, dtype), _pair(c, dtype), _pair(d))


SWEEP = [(2, 4, 64, 16, 2, 8, 16), (1, 4, 128, 32, 1, 16, 32),
         (3, 6, 48, 8, 3, 4, 16)]


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,h,s,p,g,n,chunk", SWEEP)
def test_ssd_plain_matches_pallas(bs, h, s, p, g, n, chunk, dtype):
    rng = np.random.default_rng(20)
    pairs = _ssd_inputs(rng, bs, h, s, p, g, n, dtype)
    jargs, targs = [q[0] for q in pairs], [q[1] for q in pairs]
    tol = 5e-2 if dtype == "bfloat16" else 5e-4
    got, h_final = ssd_scan_ref(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (bs, h, s, p)
    for want in (ssd_scan_tpu(*jargs, chunk=chunk, interpret=True),
                 r_ssd_scan_ref(*jargs)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # the CPU wrapper is the plain version
    got2, h2 = ssd_scan_bhsp(*targs, chunk=chunk)
    assert torch.equal(got2, got) and torch.equal(h2, h_final)
    # the final state against the reference's recurrence (seq-major)
    sm = [jnp.moveaxis(a, 2, 0) if a.ndim >= 3 else a for a in jargs]
    _, want_h = r_ssm.ssd_reference(*sm)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(want_h),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_major_adapter_matches_reference(dtype):
    rng = np.random.default_rng(21)
    pairs = _ssd_inputs(rng, 2, 4, 40, 8, 2, 8, dtype, seq_major=True)
    jargs, targs = [q[0] for q in pairs], [q[1] for q in pairs]
    targs[1] = targs[1].float()
    want = r_ssd_scan_ops(*jargs, chunk=8)
    got, h_final = ssd_scan(*targs, chunk=8)
    assert got.shape == (40, 2, 4, 8) and got.is_contiguous()
    tol = 5e-2 if dtype == "bfloat16" else 5e-4
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert h_final.shape == (2, 4, 8, 8)


# ---------------------------------------------------------------------------
# the tensor-core variant's rounding, its variant rule and its layout rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [TC_CHUNK, 16])
@pytest.mark.parametrize("bs,h,s,p,g,n,sweep_chunk", SWEEP)
def test_tc_rounding_plain_matches_pallas(bs, h, s, p, g, n, sweep_chunk,
                                          chunk):
    """The tensor-core variant's arithmetic stays within the sweep's bf16
    tolerance of the Pallas kernel and the reference recurrence (y 5e-2),
    and its final state within 5e-4 of the reference's: the bf16 pair
    keeps w·x to ~2^-17."""
    rng = np.random.default_rng(20)
    pairs = _ssd_inputs(rng, bs, h, s, p, g, n, "bfloat16")
    jargs, targs = [q[0] for q in pairs], [q[1] for q in pairs]
    got, h_final = ssd_scan_tc_ref(*targs, chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (bs, h, s, p)
    for want in (ssd_scan_tpu(*jargs, chunk=sweep_chunk, interpret=True),
                 r_ssd_scan_ref(*jargs)):
        np.testing.assert_allclose(_np(got), _np(want), atol=5e-2,
                                   rtol=5e-2)
    sm = [jnp.moveaxis(a, 2, 0) if a.ndim >= 3 else a for a in jargs]
    _, want_h = r_ssm.ssd_reference(*sm)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(want_h),
                               atol=5e-4, rtol=5e-4)


#: (bs, h, s, p, g, n, with h0, dt scale): ragged s over several chunks,
#: one token, an initial state, a large dt (exp(cum) underflows)
TC_EDGES = {"ragged_s300_h0": (1, 4, 300, 32, 2, 16, True, 1.0),
            "s1_h0": (2, 4, 1, 64, 1, 16, True, 1.0),
            "h0_two_chunks": (2, 2, 256, 16, 1, 32, True, 1.0),
            "large_dt": (1, 4, 300, 16, 1, 16, False, 40.0)}


@pytest.mark.parametrize("case", list(TC_EDGES))
def test_tc_rounding_plain_edges(case):
    bs, h, s, p, g, n, with_h0, scale = TC_EDGES[case]
    rng = np.random.default_rng(26)
    pairs = _ssd_inputs(rng, bs, h, s, p, g, n, "bfloat16", seq_major=True,
                        dt_scale=scale)
    jargs, targs = [q[0] for q in pairs], [q[1] for q in pairs]
    jh0 = th0 = None
    if with_h0:
        jh0, th0 = _pair(rng.standard_normal((bs, h, n, p)).astype(
            np.float32))
    kern = [t.permute(1, 2, 0, 3) if t.dim() == 4 else
            t.permute(1, 2, 0) if t.dim() == 3 else t for t in targs]
    got, got_h = ssd_scan_tc_ref(*kern, h0=th0, chunk=TC_CHUNK)
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_h).all()
    want, want_h = r_ssm.ssd_reference(*jargs, h0=jh0)
    np.testing.assert_allclose(_np(got.permute(2, 0, 1, 3)), _np(want),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=5e-4, rtol=5e-4)
    ref_y, ref_h = ssd_scan_ref(*kern, h0=th0)
    np.testing.assert_allclose(_np(got), _np(ref_y), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(got_h.numpy(), ref_h.numpy(), atol=5e-4,
                               rtol=5e-4)


def _xb(dtype, p, n, s=8):
    return (torch.zeros(1, 2, s, p, dtype=dtype),
            torch.zeros(1, 1, s, n, dtype=dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_of_served_shapes(arch, dtype):
    """Every bf16 prefill call of mamba2-370m (P 64, N 128) and hymba-1.5b
    (P 64, N 16) takes the tensor cores; float32 the CUDA cores."""
    cfg = get_config(arch)
    want = "tc" if dtype == torch.bfloat16 else "simt"
    assert variant(*_xb(dtype, cfg.ssm_headdim, cfg.ssm_state)) == want


@pytest.mark.parametrize("p,n,want", [
    (16, 8, "simt"), (32, 16, "tc"), (8, 4, "simt"),    # the sweep's
    (16, 16, "tc"), (128, 256, "tc"), (48, 32, "tc"),
    (40, 256, "simt"), (144, 16, "simt"), (64, 272, "simt"),
    (64, 24, "simt")])
def test_variant_choice(p, n, want):
    """bf16 with P and N multiples of 16, P <= 128 and N <= 256 takes
    "tc"; any other bf16 shape and every float32 one "simt"."""
    assert variant(*_xb(torch.bfloat16, p, n)) == want
    assert variant(*_xb(torch.float32, p, n)) == "simt"


def test_rows_aligned():
    """The tensor-core variant reads a view in place when its last dim is
    contiguous and its base and other strides lie on 16 bytes: the kernel
    layout, the model's seq-major views and the fused projection's column
    views of B and C (N 128 and 16).  Anything else is copied (to equal
    values, contiguous) and still takes "tc"."""
    bf16 = torch.bfloat16
    s, bs, h, p = 12, 2, 4, 64
    x = torch.randn(bs, h, s, p).to(bf16)
    assert rows_aligned(x) and _tc_view(x) is x
    seq = torch.randn(s, bs, h * p).to(bf16)
    assert rows_aligned(seq.reshape(s, bs, h, p).permute(1, 2, 0, 3))
    for n in (128, 16):
        bc = torch.randn(s, bs, 2 * n).to(bf16)
        for t in torch.chunk(bc, 2, dim=-1):
            view = t.reshape(s, bs, 1, n).permute(1, 2, 0, 3)
            assert rows_aligned(view) and _tc_view(view) is view
    flat = torch.randn(1 + bs * h * s * p).to(bf16)
    off = flat[1:].view(bs, h, s, p)                        # base off 16 B
    odd = torch.randn(bs, h, s, p + 4).to(bf16)[..., :p]    # row 136 B
    cols = torch.randn(bs, h, p, s).to(bf16).transpose(2, 3)  # p strided
    for bad in (off, odd, cols):
        assert not rows_aligned(bad)
        copy = _tc_view(bad)
        assert copy is not bad and rows_aligned(copy) and \
            copy.is_contiguous() and torch.equal(copy, bad)
        assert variant(bad, torch.zeros(bs, 1, s, 16, dtype=bf16)) == "tc"
    # a dim of size 1 is never stepped along: its stride plays no part
    assert rows_aligned(torch.randn(1, 1, s, p).to(bf16).as_strided(
        (1, 1, s, p), (3, 5, p, 1)))


def test_tc_scratch_bytes():
    """Chunk states in float32 and H_in in bf16, C.B^T a group and a decay
    sum a chunk: 104.9 MB at mamba2's prefill shape (16 chunks of 128),
    23.9 MB at hymba's."""
    assert tc_scratch_bytes(4, 32, 2048, 64, 1, 128) == \
        16 * (6 * 4 * 32 * 128 * 64 + 4 * 4 * 128 * 128 + 4 * 4 * 32)
    assert tc_scratch_bytes(4, 50, 2048, 64, 1, 16) == \
        16 * (6 * 4 * 50 * 16 * 64 + 4 * 4 * 128 * 128 + 4 * 4 * 50)
    assert tc_scratch_bytes(1, 4, 129, 16, 2, 16) == \
        2 * (6 * 4 * 16 * 16 + 4 * 2 * 128 * 128 + 4 * 4)
    assert tc_scratch_bytes(2, 4, 0, 64, 1, 128) == 0


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,bs,h,p,g,n,chunk,with_h0", [
    (32, 2, 4, 8, 1, 8, 8, False),
    (32, 2, 4, 8, 2, 8, 8, True),          # groups > 1, an initial state
    (30, 1, 6, 8, 3, 4, 8, True),          # ragged: the chunk steps to 6
    (13, 1, 4, 16, 2, 16, 64, False),      # s < chunk, prime
    (1, 2, 4, 8, 1, 8, 8, True),           # one token
])
def test_ssd_scan_matches_reference(s, bs, h, p, g, n, chunk, with_h0):
    rng = np.random.default_rng(22)
    pairs = _ssd_inputs(rng, bs, h, s, p, g, n, "float32", seq_major=True)
    jargs, targs = [q[0] for q in pairs], [q[1] for q in pairs]
    jh0 = th0 = None
    if with_h0:
        jh0, th0 = _pair(rng.standard_normal((bs, h, n, p)).astype(
            np.float32))
    got, got_h = p_ssm.ssd_scan(*targs, chunk=chunk, h0=th0)
    for want, want_h in (r_ssm.ssd_scan(*jargs, chunk=chunk, h0=jh0),
                         r_ssm.ssd_reference(*jargs, h0=jh0)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   atol=1e-4, rtol=1e-4)
    ref_y, ref_h = p_ssm.ssd_reference(*targs, h0=th0)
    np.testing.assert_allclose(_np(got), _np(ref_y), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), ref_h.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_ssd_chunked_large_dt_stays_finite():
    """exp(cum) underflows to 0 over a chunk of large steps: finite, and
    equal to the recurrence."""
    rng = np.random.default_rng(23)
    pairs = _ssd_inputs(rng, 1, 4, 64, 8, 1, 8, "float32", seq_major=True,
                        dt_scale=40.0)
    targs = [q[1] for q in pairs]
    got, got_h = p_ssm.ssd_scan(*targs, chunk=64)
    want, want_h = p_ssm.ssd_reference(*targs)
    assert torch.isfinite(got).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), atol=1e-4,
                               rtol=1e-4)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_reference(dtype):
    rng = np.random.default_rng(24)
    bs, h, p, g, n = 3, 6, 8, 2, 4
    jhs, ths = _pair(rng.standard_normal((bs, h, n, p)).astype(np.float32))
    jx, tx = _pair(rng.standard_normal((bs, h, p)).astype(np.float32), dtype)
    jdt, tdt = _pair(np.log1p(np.exp(rng.standard_normal((bs, h)))).astype(
        np.float32))
    ja, ta = _pair(rng.standard_normal(h).astype(np.float32) * 0.5)
    jb, tb = _pair(rng.standard_normal((bs, g, n)).astype(np.float32), dtype)
    jc, tc = _pair(rng.standard_normal((bs, g, n)).astype(np.float32), dtype)
    jd, td = _pair(rng.standard_normal(h).astype(np.float32))
    want_h, want_y = reference_compiled(r_ssm.ssd_decode_step, jhs, jx, jdt,
                                        ja, jb, jc, jd)(jhs, jx, jdt, ja, jb,
                                                        jc, jd)
    got_h, got_y = p_ssm.ssd_decode_step(ths, tx, tdt, ta, tb, tc, td)
    assert got_y.dtype == tx.dtype and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(25)
    jx, tx = _pair(rng.standard_normal((11, 2, 24)).astype(np.float32),
                   dtype)
    jw, tw = _pair(rng.standard_normal((4, 24)).astype(np.float32), dtype)
    want = reference_compiled(r_ssm._causal_conv, jx, jw)(jx, jw)
    got = p_ssm._causal_conv(tx, tw)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))
    # a sequence shorter than the kernel: zeros before its start
    short = p_ssm._causal_conv(tx[:2], tw)
    np.testing.assert_allclose(_np(short), _np(got)[:2], atol=0)


def _layer(params, idx=0):
    return {k: v[idx] for k, v in params["layers"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_op_matches_reference(arch, dtype):
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch), dtype)
    rng = np.random.default_rng(26)
    jx, tx = _pair(rng.standard_normal((16, 2, rcfg.d_model)).astype(
        np.float32), dtype)
    jlp = {k: v for k, v in _layer(params).items() if k.startswith("ssm_")}
    want = reference_compiled(
        lambda x, lp: r_ssm.ssm_op(x, lp, rcfg, r_local_comm(),
                                   r_tp_plan(rcfg, 1)), jx, jlp)(jx, jlp)
    got = p_ssm.ssm_op(tx, _layer(pparams), pcfg, local_comm(),
                       tp_plan(pcfg, 1))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


# ---------------------------------------------------------------------------
# whole models: forward, serve steps, prefill, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch), dtype)
    tok = np.random.default_rng(27).integers(0, rcfg.vocab, size=(12, 2))
    args = (params, jnp.asarray(tok, jnp.int32))
    want, _ = reference_compiled(lambda p, t: r_build_model(rcfg).forward(
        p, {"tokens": t}, remat=False), *args)(*args)
    got, aux = build_model(pcfg, device="cpu").forward(
        pparams, {"tokens": torch.from_numpy(tok.astype(np.int32))})
    assert got.shape == want.shape and got.dtype == DTYPES[dtype][1]
    assert all(float(v) == 0.0 for v in aux.values())
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch):
    """Ten teacher-forced steps in float32: the tokens, and after each step
    the SSM state, the conv tail and (hybrid) the K/V cache."""
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch), "float32")
    S, B = 10, 2
    tokens = np.random.default_rng(28).integers(0, rcfg.vocab, size=(S, B)
                                                ).astype(np.int32)
    r_step = jax.jit(r_make_serve_step(rcfg))
    r_cache = r_init_cache(rcfg, S, B)
    step = make_serve_step(pcfg)
    cache = init_cache(pcfg, S, B, device="cpu")
    assert (cache.k is None) == (rcfg.family == "ssm")
    for i in range(S):
        want, r_cache = r_step(params, r_cache, jnp.asarray(tokens[i]))
        got, cache = step(pparams, cache, torch.from_numpy(tokens[i]))
        assert cache.length == i + 1
        assert got.numpy().tolist() == np.asarray(want).tolist()
        pairs = [(cache.ssm_state, r_cache.ssm_state),
                 (cache.conv_tail, r_cache.conv_tail)]
        if cache.k is not None:
            pairs += [(cache.k, r_cache.k), (cache.v, r_cache.v)]
        for g_, w_ in pairs:
            # the state sums terms of up to ~1e3 at the smoke init (the
            # reference's σ of w_dt gives dt up to ~15), so float32
            # rounding is measured against the tensor's largest element
            w_ = _np(w_)
            np.testing.assert_allclose(
                _np(g_), w_, rtol=1e-4,
                atol=1e-4 + 1e-6 * float(np.abs(w_).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch), "float32")
    tokens = np.random.default_rng(29).integers(0, rcfg.vocab, size=(12, 2)
                                                ).astype(np.int32)
    want_tok, want_last = jax.jit(r_make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    got_tok, got_last = make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(tokens)})
    assert got_tok.numpy().tolist() == np.asarray(want_tok).tolist()
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_loop_matches_reference_launcher(arch):
    """The reference launcher's loop and the port's ``serve`` on the same
    carried params and prompts: the same token stream per request (6
    requests, 4 slots: the second wave decodes on the state the first one
    left, in both packages)."""
    _launcher_loops_agree(r_get_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_ssm_shapes_and_scale(arch):
    """The port's own init: the reference's keys and shapes (ssm and
    hybrid layers), zeros, ones and float32 where the reference has them,
    and the truncated normal's scale (conv_w: σ = 0.5/sqrt(L))."""
    cfg = r_get_smoke(arch)
    want = jax.eval_shape(lambda k: r_build_model(cfg).init(k)[0],
                          jax.random.PRNGKey(0))
    got, specs = build_model(port_config(cfg), device="cpu").init(0)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k, leaf in want["layers"].items():
        assert tuple(got["layers"][k].shape) == leaf.shape
        assert got["layers"][k].dtype == torch.float32   # a float32 config
    lay = got["layers"]
    assert not lay["ssm_a_log"].any() and not lay["ssm_dt_bias"].any()
    assert (lay["ssm_d_skip"] == 1).all() and (lay["ssm_norm_w"] == 1).all()
    conv = lay["ssm_conv_w"]
    sigma = 0.5 / np.sqrt(conv.shape[0])
    assert float(conv.abs().max()) <= 2 * sigma + 1e-6
    assert abs(float(conv.std()) / sigma - 0.88) < 0.1   # ±2σ truncation
    assert specs["layers"]["ssm_w_out"].fsdp_axis == 1
    if cfg.family == "hybrid":
        assert (lay["mix_norm_a"] == 1).all() and "w_gate" in lay
    else:
        assert "wq" not in lay and "norm2" not in lay
