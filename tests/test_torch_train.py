"""The port's training stack held against the JAX package on the CPU.

The same numpy-seeded inputs (and the reference's own params, carried
across with ``params_from_numpy``) go through both packages; the
reference runs its plain ``jnp`` path, as it trains, compiled with
``xla_allow_excess_precision`` off (``test_torch_models.
reference_compiled``):

* the kernel wrappers' gradients on CPU tensors (their plain route)
  against ``jax.grad`` of the reference's plain functions
  (``repro/kernels/*/ref.py``): B2 causal / window / GQA at dh 64, 128,
  256, B3, B4 at all four activations, B5 without and with an initial
  state; and each wrapper's ``autograd.Function`` (the CUDA route's
  backward) run on the CPU with the plain forward in the kernel's place;
  the chunked scan's gradients finite where the reference's are NaN;
* each family's loss, metrics and every param gradient against
  ``jax.value_and_grad`` of the reference's ``model.loss``, remat on and
  off (float32: 2e-4 of the largest gradient of a leaf; bf16 dense: 5e-2;
  remat must not change a bit);
* five steps of ``make_train_step`` against the reference's jitted step;
  ``tests/test_train.py``'s cases mirrored; the launcher (one rank,
  ``--mesh 2x1``, ``--mesh 2x2`` against ``--mesh 1x1``, losses against the
  reference launcher's loop on carried params);
* serving builds no graph, even with params that require a gradient.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.flash_attention.ref as r_flash
import repro.kernels.moe_gmm.ref as r_gmm
import repro.kernels.rmsnorm.ref as r_rms
import repro.kernels.ssd_scan.ref as r_ssd
import repro.models.ssm as r_ssm
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.data import SyntheticPipeline as RPipeline
from repro.models.common import ModelConfig as RConfig
from repro.models.registry import build_model as r_build_model
from repro.optim import AdamWConfig as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro.train import make_train_step as r_make_train_step
from repro.train import train_state_init as r_train_state_init
from repro.train.loop import LoopConfig as RLoopConfig
from repro.train.loop import train_loop as r_train_loop

import repro_torch.kernels.flash_attention.ops as p_flash_ops
import repro_torch.kernels.moe_gmm.ops as p_gmm_ops
import repro_torch.kernels.rmsnorm.ops as p_rms_ops
import repro_torch.kernels.ssd_scan.ops as p_ssd_ops
import repro_torch.launch.train as p_launch
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd,
                                                 flash_attention_ref)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bhsp,
                                          ssd_scan_ref, ssd_scan_tc_ref)
from repro_torch.models.registry import build_model, params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.serving import init_cache, make_prefill_step, \
    make_serve_step
from repro_torch.train import (TrainState, loss_and_grads, make_train_step,
                               train_state_init)
from test_torch_models import (MODEL_CASES, carried_model, port_config,
                               reference_compiled)

F32 = jnp.float32


@pytest.fixture
def one_torch_thread():
    """One intra-op thread a test: these models are tiny, and the suite's
    workers share the machine's cores (several threads a worker spin
    against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


#: tests/test_train.py's config
CFG = RConfig(
    name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=64, tp_target=4, dtype=F32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _vjp_port(fn, inputs, ct):
    """(out, grads) of ``fn(*inputs)`` pulled back from ``ct``."""
    xs = [x.clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, ct)


def _vjp_ref(fn, inputs, ct):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return out, vjp(jnp.asarray(ct))


def _close_grads(got, want, tol):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, \
            (np.abs(g - w).max(), scale)


# ---------------------------------------------------------------------------
# the kernel wrappers' gradients on the CPU (the plain route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,dh,causal,window", [
    (1, 4, 2, 32, 64, True, 0),          # GQA, causal
    (2, 2, 1, 40, 128, True, 8),         # GQA, window
    (1, 2, 2, 24, 256, False, 0),        # bidirectional, dh 256
])
def test_flash_grads_match_reference(b, hq, hkv, s, dh, causal, window):
    """B2: d(q, k, v) through the wrapper (both layouts) against
    ``jax.vjp`` of the reference's plain attention, float32 at 1e-5 of
    the largest gradient."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hq, s, dh), np.float32)
    k = rng.standard_normal((b, hkv, s, dh), np.float32)
    v = rng.standard_normal((b, hkv, s, dh), np.float32)
    ct = rng.standard_normal((b, hq, s, dh), np.float32)
    kw = dict(causal=causal, window=window)
    want_o, want = _vjp_ref(functools.partial(r_flash.flash_attention_ref,
                                              **kw), (q, k, v), ct)
    got_o, got = _vjp_port(functools.partial(flash_attention_bhsd, **kw),
                           [_t(a) for a in (q, k, v)], _t(ct))
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=1e-5)
    _close_grads(got, want, 1e-5)
    seq = [_t(a).permute(2, 0, 1, 3).contiguous() for a in (q, k, v)]
    _, got_s = _vjp_port(functools.partial(flash_attention, **kw), seq,
                         _t(ct).permute(2, 0, 1, 3))
    for gs, g in zip(got_s, got):
        np.testing.assert_array_equal(_np(gs.permute(1, 2, 0, 3)), _np(g))


def test_rmsnorm_grads_match_reference():
    """B3: d(x, w) against ``jax.vjp`` of the reference's plain RMSNorm."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 96), np.float32)
    w = rng.standard_normal((96,), np.float32)
    ct = rng.standard_normal((6, 96), np.float32)
    want_o, want = _vjp_ref(r_rms.rmsnorm_ref, (x, w), ct)
    got_o, got = _vjp_port(rmsnorm, [_t(x), _t(w)], _t(ct))
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=1e-6)
    _close_grads(got, want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_gmm_grads_match_reference(act):
    """B4: d(x, w1, w2) against ``jax.vjp`` of the reference's plain
    grouped matmul; with ``rows``, the rows past each fill get no
    gradient and the rest are the reference's on the zeroed rows."""
    rng = np.random.default_rng(2)
    e, c, d, f = 3, 5, 16, 8
    mult = 2 if act in ("swiglu", "geglu") else 1
    x = rng.standard_normal((e, c, d), np.float32)
    w1 = rng.standard_normal((e, d, mult * f), np.float32) * 0.3
    w2 = rng.standard_normal((e, f, d), np.float32) * 0.3
    ct = rng.standard_normal((e, c, d), np.float32)
    ref = functools.partial(r_gmm.moe_gmm_ref, act=act)
    want_o, want = _vjp_ref(ref, (x, w1, w2), ct)
    got_o, got = _vjp_port(functools.partial(moe_gmm, act=act),
                           [_t(a) for a in (x, w1, w2)], _t(ct))
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=1e-5)
    _close_grads(got, want, 1e-5)
    rows = np.array([5, 2, 0], np.int32)
    keep = (np.arange(c)[None, :] < rows[:, None])[..., None]
    _, want_r = _vjp_ref(ref, (x, w1, w2), ct * keep)
    _, got_r = _vjp_port(functools.partial(
        moe_gmm, act=act, rows=torch.from_numpy(rows)),
        [_t(a) for a in (x, w1, w2)], _t(ct))
    assert not _np(got_r[0])[~np.broadcast_to(keep, x.shape)].any()
    _close_grads(got_r, want_r, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_grads_match_reference(with_h0):
    """B5: d(x, dt, a_log, b, c, d_skip[, h0]) against ``jax.vjp`` of the
    reference's plain recurrence: the kernel's ``ssd_scan_ref`` (y), or
    with an initial state ``models/ssm.py::ssd_reference`` (y and the
    final state, seq-major), float32 at 1e-4 of the largest gradient."""
    rng = np.random.default_rng(3)
    bs, h, s, p, g, n = 2, 4, 12, 8, 2, 4
    x = rng.standard_normal((bs, h, s, p), np.float32)
    dt = rng.uniform(0.05, 0.5, (bs, h, s)).astype(np.float32)
    a_log = rng.standard_normal((h,)).astype(np.float32) * 0.5
    b = rng.standard_normal((bs, g, s, n), np.float32)
    c = rng.standard_normal((bs, g, s, n), np.float32)
    d_skip = rng.standard_normal((h,)).astype(np.float32)
    ct = rng.standard_normal((bs, h, s, p), np.float32)
    if not with_h0:
        want_o, want = _vjp_ref(r_ssd.ssd_scan_ref,
                                (x, dt, a_log, b, c, d_skip), ct)
        got_o, got = _vjp_port(lambda *a: ssd_scan_bhsp(*a)[0],
                               [_t(a) for a in (x, dt, a_log, b, c,
                                                d_skip)], _t(ct))
        np.testing.assert_allclose(_np(got_o), _np(want_o), atol=1e-5)
        _close_grads(got, want, 1e-4)
        return
    h0 = rng.standard_normal((bs, h, n, p), np.float32)
    cth = rng.standard_normal((bs, h, n, p), np.float32)
    seq = [np.ascontiguousarray(np.moveaxis(x, 2, 0)),
           np.ascontiguousarray(np.moveaxis(dt, 2, 0)), a_log,
           np.ascontiguousarray(np.moveaxis(b, 2, 0)),
           np.ascontiguousarray(np.moveaxis(c, 2, 0)), d_skip, h0]
    cty = np.ascontiguousarray(np.moveaxis(ct, 2, 0))
    (wy, wh), vjp = jax.vjp(r_ssm.ssd_reference,
                            *[jnp.asarray(a) for a in seq])
    want = vjp((jnp.asarray(cty), jnp.asarray(cth)))
    xs = [_t(a).requires_grad_() for a in seq]
    y, hf = ssd_scan(*xs[:6], h0=xs[6])
    got = torch.autograd.grad((y, hf), xs, (_t(cty), _t(cth)))
    np.testing.assert_allclose(_np(y), _np(wy), atol=1e-4)
    np.testing.assert_allclose(_np(hf), _np(wh), atol=1e-4)
    _close_grads(got, want, 1e-4)


def test_ssd_chunked_grads_finite_where_exp_overflows():
    """The chunked scan at mamba2-370m's chunk (256) with dt where the
    masked exponents pass float32's range (cum_l - cum_j up to ~180 for
    j > l): the port masks the exponent before the exp, so its gradients
    stay finite; the reference takes exp of every pair and masks after,
    and its gradients are NaN (0 x inf; ROADMAP §C)."""
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(6)
    s, bs, h, p, g, n = 256, 1, 2, 4, 1, 4
    x = rng.standard_normal((s, bs, h, p)).astype(np.float32)
    dt = np.full((s, bs, h), 0.7, np.float32)
    a_log = np.zeros(h, np.float32)
    b = rng.standard_normal((s, bs, g, n)).astype(np.float32)
    c = rng.standard_normal((s, bs, g, n)).astype(np.float32)
    d_skip = np.ones(h, np.float32)
    args = (x, dt, a_log, b, c, d_skip)

    def port_loss(*a):
        return ssd_chunked(*a, chunk=256)[0].sum()
    xs = [_t(a).requires_grad_() for a in args]
    got = torch.autograd.grad(port_loss(*xs), xs)
    assert all(bool(torch.isfinite(gr).all()) for gr in got)
    want = jax.jit(jax.grad(lambda *a: r_ssm.ssd_scan(*a, chunk=256)[0]
                            .sum(), argnums=(0, 1, 3, 4)))(
        *[jnp.asarray(a) for a in args])
    assert not all(bool(jnp.isfinite(w).all()) for w in want)


def _plain_kernels(monkeypatch):
    """Each wrapper's kernel call replaced by its plain version, so that
    the CUDA route's ``autograd.Function`` runs on CPU tensors."""
    monkeypatch.setattr(p_rms_ops, "_launch",
                        lambda x, w, eps: rmsnorm_ref(x, w, eps=eps))

    def flash(q, k, v, *, causal, window, q_offset, seq):
        if seq:
            q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        o = flash_attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, p_dtype=torch.bfloat16
                                if q.dtype == torch.bfloat16 else None)
        return o.permute(2, 0, 1, 3) if seq else o
    monkeypatch.setattr(p_flash_ops, "_seq_call",
                        functools.partial(flash, seq=True))
    monkeypatch.setattr(p_flash_ops, "_bhsd_call",
                        functools.partial(flash, seq=False))
    monkeypatch.setattr(p_gmm_ops, "_launch", lambda x, w1, w2, act, rows:
                        moe_gmm_ref(x, w1, w2, act=act, rows=rows))
    monkeypatch.setattr(p_ssd_ops, "_bhsp_call", lambda *a: ssd_scan_ref(
        *a[:6], h0=a[6]))


def test_autograd_functions_backward_is_the_plain_vjp(monkeypatch):
    """The CUDA route's ``autograd.Function``s, run with the plain forward
    in the kernel's place: each backward equals autograd of the plain
    version of the variant (bf16: P in bf16 for B2, h rounded once for
    B4, ``ssd_scan_tc_ref`` for B5; float32: the plain versions)."""
    _plain_kernels(monkeypatch)
    rng = np.random.default_rng(4)

    def check(fn_apply, plain, arrays, dtype, n_out=1):
        xs = [_t(a).to(dtype).requires_grad_() for a in arrays]
        out = fn_apply(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        cts = [torch.from_numpy(rng.standard_normal(o.shape).astype(
            np.float32)).to(o.dtype) for o in outs[:n_out]]
        got = torch.autograd.grad(outs[:n_out], xs, cts)
        ys = [x.detach().clone().requires_grad_() for x in xs]
        pouts = plain(*ys)
        pouts = pouts if isinstance(pouts, tuple) else (pouts,)
        want = torch.autograd.grad(pouts[:n_out], ys, cts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g, w, rtol=0, atol=0)

    for dtype in (torch.float32, torch.bfloat16):
        x = rng.standard_normal((5, 64), np.float32)
        w = rng.standard_normal((64,), np.float32)
        check(lambda x, w: p_rms_ops._RmsNormFn.apply(x, w, 1e-6),
              lambda x, w: rmsnorm_ref(x, w), (x, w), dtype)
        q = rng.standard_normal((1, 2, 16, 64), np.float32)
        k = rng.standard_normal((1, 1, 16, 64), np.float32)
        pd = torch.bfloat16 if dtype == torch.bfloat16 else None
        check(lambda q, k, v: p_flash_ops._FlashFn.apply(
            q, k, v, True, 4, 0, False),
            lambda q, k, v: flash_attention_ref(q, k, v, window=4,
                                                p_dtype=pd),
            (q, k, k * 0.5), dtype)
        xe = rng.standard_normal((2, 4, 16), np.float32)
        w1 = rng.standard_normal((2, 16, 16), np.float32) * 0.3
        w2 = rng.standard_normal((2, 8, 16), np.float32) * 0.3
        check(lambda x, a, b: p_gmm_ops._MoeGmmFn.apply(x, a, b, "swiglu",
                                                        None),
              lambda x, a, b: moe_gmm_ref(x, a, b, h_dtype=pd),
              (xe, w1, w2), dtype)
    # B5: bf16 P, N multiples of 16 -> the tc variant's plain version
    xs = rng.standard_normal((1, 2, 8, 16), np.float32)
    dts = rng.uniform(0.1, 0.4, (1, 2, 8)).astype(np.float32)
    bcs = rng.standard_normal((1, 1, 8, 16), np.float32)
    for dtype, plain in ((torch.bfloat16, ssd_scan_tc_ref),
                         (torch.float32, ssd_scan_ref)):
        f32 = [_t(a).requires_grad_() for a in (dts, np.zeros(2, np.float32),
                                                np.ones(2, np.float32))]
        xin = [_t(a).to(dtype).requires_grad_() for a in (xs, bcs, bcs * 0.5)]
        y, hf = p_ssd_ops._SsdScanFn.apply(xin[0], f32[0], f32[1], xin[1],
                                           xin[2], f32[2], None, False)
        got = torch.autograd.grad((y, hf), xin + f32,
                                  (torch.ones_like(y), torch.ones_like(hf)))
        ys = [t.detach().clone().requires_grad_() for t in xin + f32]
        py, ph = plain(ys[0], ys[3], ys[4], ys[1], ys[2], ys[5])
        want = torch.autograd.grad((py, ph), ys, (torch.ones_like(py),
                                                  torch.ones_like(ph)))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_no_grad_call_is_the_plain_kernel_call(monkeypatch):
    """With no input requiring a gradient, a wrapper call records
    nothing: no ``grad_fn``, the same launch as before."""
    _plain_kernels(monkeypatch)
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    assert p_rms_ops._RmsNormFn.apply(x, None, 1e-6).grad_fn is None
    xr = x.clone().requires_grad_()
    assert p_rms_ops._RmsNormFn.apply(xr, None, 1e-6).grad_fn is not None
    with torch.no_grad():
        assert p_rms_ops._RmsNormFn.apply(xr, None, 1e-6).grad_fn is None


# ---------------------------------------------------------------------------
# whole models: loss, metrics and every gradient against the reference
# ---------------------------------------------------------------------------

FAMILY_CASES = {"dense": "gemma3-1b", "dense-olmo": "olmo-1b",
                "moe": "olmoe-1b-7b", "ssm": "mamba2-370m",
                "hybrid": "hymba-1.5b"}
METRICS = ("loss", "ce", "ntok", "aux_lb", "aux_z", "dropped_frac")


def _batch(vocab: int, s: int = 16, b: int = 2, seed: int = 3):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(s, b)).astype(np.int32)
    lab = rng.integers(0, vocab, size=(s, b)).astype(np.int32)
    lab[0, 0] = -100                                   # one ignored label
    return tok, lab


@functools.lru_cache(maxsize=None)
def _reference_grads(arch: str, dtype: str):
    rcfg, params, pcfg, pparams = carried_model(r_get_smoke(arch), dtype)
    tok, lab = _batch(rcfg.vocab)
    model = r_build_model(rcfg)

    def f(p, t, l):
        return jax.value_and_grad(lambda p: model.loss(
            p, {"tokens": t, "labels": l}, remat=False), has_aux=True)(p)
    args = (params, jnp.asarray(tok), jnp.asarray(lab))
    (_, metrics), grads = reference_compiled(f, *args)(*args)
    return pcfg, pparams, (tok, lab), metrics, grads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_family_grads_match_reference(family, remat):
    """Loss, ce, ntok, the router terms and the gradient of every param
    leaf against ``jax.value_and_grad`` of the reference's loss (float32,
    2e-4 of each leaf's largest gradient; metrics at 1e-5); remat on and
    off give the same bits."""
    pcfg, pparams, (tok, lab), want_m, want_g = _reference_grads(
        FAMILY_CASES[family], "float32")
    model = build_model(pcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    _, metrics, grads = loss_and_grads(model, pparams, batch,
                                       _local_comm(), remat=remat)
    assert set(metrics) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7)
    flat_want = dict(leaves_with_paths(jax.tree_util.tree_map(
        np.asarray, want_g)))
    got = leaves_with_paths(grads)
    assert [n for n, _ in got] == sorted(flat_want)
    for name, g in got:
        w = flat_want[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(_np(g) - w).max() <= 2e-4 * scale, name
    if remat:
        _, _, plain = loss_and_grads(model, pparams, batch, _local_comm(),
                                     remat=False)
        for (_, a), (_, b) in zip(got, leaves_with_paths(plain)):
            assert torch.equal(a, b)


def test_dense_bf16_grads_match_reference():
    """gemma3-1b's smoke config in bf16: the loss at 2e-2 and every
    gradient leaf within 5e-2 of its largest element (the gradients are
    bf16 in both packages)."""
    pcfg, pparams, (tok, lab), want_m, want_g = _reference_grads(
        "gemma3-1b", "bfloat16")
    _, metrics, grads = loss_and_grads(
        build_model(pcfg, device="cpu"), pparams,
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)},
        _local_comm())
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(want_m["loss"]), rtol=2e-2)
    flat_want = dict(leaves_with_paths(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), want_g)))
    for name, g in leaves_with_paths(grads):
        assert g.dtype == torch.bfloat16
        w = flat_want[name]
        assert np.abs(_np(g) - w).max() <= 5e-2 * max(np.abs(w).max(),
                                                      1e-12), name


def test_mamba2_full_width_grads_match_reference():
    """mamba2-370m at its full width (d 1024, 32 heads of 64, state 128,
    vocab 50280) and 2 of its 48 layers, float32: the loss and every param
    gradient against ``jax.value_and_grad`` of the reference's loss (2e-4
    of each leaf's largest gradient).  The reference's chunked scan gives
    NaN gradients at this width (ROADMAP §C), so it runs at chunk 1,
    where every exponent is a decay (the same function); the port at the
    config's chunk, 256."""
    base = dataclasses.replace(r_get_config("mamba2-370m"), n_layers=2)
    rcfg, params, pcfg, pparams = carried_model(
        dataclasses.replace(base, ssm_chunk=1), "float32")
    tok, lab = _batch(rcfg.vocab)
    model = r_build_model(rcfg)

    def f(p, t, l):
        return jax.value_and_grad(lambda p: model.loss(
            p, {"tokens": t, "labels": l}, remat=False), has_aux=True)(p)
    args = (params, jnp.asarray(tok), jnp.asarray(lab))
    (want_loss, _), want_g = reference_compiled(f, *args)(*args)
    loss, _, grads = loss_and_grads(
        build_model(dataclasses.replace(pcfg, ssm_chunk=base.ssm_chunk),
                    device="cpu"), pparams,
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)},
        _local_comm())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    flat_want = dict(leaves_with_paths(jax.tree_util.tree_map(
        np.asarray, want_g)))
    for name, g in leaves_with_paths(grads):
        w = flat_want[name]
        assert np.isfinite(w).all(), name
        assert np.abs(_np(g) - w).max() <= 2e-4 * np.abs(w).max(), name


def _local_comm():
    from repro_torch.distributed import local_comm
    return local_comm()


# ---------------------------------------------------------------------------
# the train step and loop
# ---------------------------------------------------------------------------

def _carried_state(cfg, lr_fn_pair, seed: int = 0, **opt_kw):
    """The reference's initial TrainState and the port's on carried params
    (the reference's draw)."""
    r_lr, p_lr = lr_fn_pair
    ropt = RAdamW(lr=r_lr, **opt_kw)
    rstate, rspecs = r_train_state_init(r_build_model(cfg),
                                        jax.random.PRNGKey(seed), ropt)
    pcfg = port_config(cfg)
    pmodel = build_model(pcfg, device="cpu")
    _, pspecs = pmodel.init(0)
    popt = AdamWConfig(lr=p_lr, **opt_kw)
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(
        np.asarray, rstate.params), device="cpu")
    return (ropt, rstate, rspecs), (popt, pmodel, pspecs, pparams)


def test_train_steps_match_reference():
    """Five steps of ``make_train_step`` from the same params and batches
    as the reference's jitted step: losses at 1e-5, grad norms at 1e-3,
    the params within 1e-3 (a step moves them by up to lr = 3e-3; Adam
    divides by sqrt(nu), so float32 differences in tiny gradients move
    a param by up to a fraction of a step)."""
    (ropt, rstate, rspecs), (popt, pmodel, pspecs, pparams) = \
        _carried_state(MODEL_CASES["dense"], (r_cosine(3e-3, 2, 5),
                                              cosine_schedule(3e-3, 2, 5)))
    state = TrainState(pparams, adamw_init(pparams, popt))
    rstep = jax.jit(r_make_train_step(r_build_model(MODEL_CASES["dense"]),
                                      rspecs, ropt))
    pstep = make_train_step(pmodel, pspecs, popt)
    rpipe = RPipeline(vocab=128, seq_len=16, global_batch=4)
    ppipe = SyntheticPipeline(vocab=128, seq_len=16, global_batch=4)
    for i in range(5):
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in
                                    rpipe.get_batch(i).items()})
        state, pm = pstep(state, ppipe.get_batch(i, device="cpu"))
        for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("ntok", 0),
                       ("grad_norm", 1e-3)):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=tol)
    assert int(state.opt.step) == 5
    for a, (_, b) in zip(jax.tree_util.tree_leaves(rstate.params),
                         leaves_with_paths(state.params)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-3)


def _port_run(cfg_r, opt, seed=0):
    pcfg = port_config(cfg_r)
    model = build_model(pcfg, device="cpu")
    state, specs = train_state_init(model, seed, opt)
    return model, state, specs, make_train_step(model, specs, opt)


def test_overfit_fixed_batch():
    """tests/test_train.py::test_overfit_fixed_batch on the port."""
    opt = AdamWConfig(lr=3e-3, weight_decay=0.0)
    _, state, _, step = _port_run(CFG, opt)
    batch = SyntheticPipeline(vocab=64, seq_len=32,
                              global_batch=8).get_batch(0, device="cpu")
    first = None
    for _ in range(80):
        state, metrics = step(state, batch)
        first = first if first is not None else float(metrics["loss"])
    assert float(metrics["loss"]) < 0.5 < first


def test_stream_learning():
    """tests/test_train.py::test_stream_learning on the port."""
    opt = AdamWConfig(lr=3e-3, weight_decay=0.0)
    _, state, _, step = _port_run(CFG, opt)
    pipe = SyntheticPipeline(vocab=64, seq_len=32, global_batch=8)
    losses = []
    for i in range(40):
        state, m = step(state, pipe.get_batch(i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.4


def test_training_is_deterministic():
    """tests/test_train.py::test_training_is_deterministic on the port."""
    opt = AdamWConfig(lr=1e-3)

    def run():
        _, state, _, step = _port_run(CFG, opt)
        pipe = SyntheticPipeline(vocab=64, seq_len=16, global_batch=4)
        for i in range(5):
            state, _ = step(state, pipe.get_batch(i, device="cpu"))
        return state

    s1, s2 = run(), run()
    for (_, a), (_, b) in zip(leaves_with_paths(s1.params),
                              leaves_with_paths(s2.params)):
        assert torch.equal(a, b)


def test_grad_clip_engages():
    """tests/test_train.py::test_grad_clip_engages on the port: the
    reported norm is the pre-clip one, and the update stays O(lr)."""
    opt = AdamWConfig(lr=1e-3, max_grad_norm=1e-6)
    _, state, _, step = _port_run(CFG, opt)
    before = {n: p.clone() for n, p in leaves_with_paths(state.params)}
    state, m = step(state, SyntheticPipeline(
        vocab=64, seq_len=16, global_batch=4).get_batch(0, device="cpu"))
    assert float(m["grad_norm"]) > 1e-3
    moved = max(float((p - before[n]).abs().max())
                for n, p in leaves_with_paths(state.params))
    assert 0 < moved < 1e-2


def test_schedules():
    """tests/test_train.py::test_schedules on the port."""
    from repro_torch.optim import linear_warmup
    warm = linear_warmup(1.0, 10)
    assert float(warm(0)) == 0.0
    assert abs(float(warm(5)) - 0.5) < 1e-6
    assert float(warm(20)) == 1.0
    cos = cosine_schedule(1.0, 10, 110, final_frac=0.1)
    assert abs(float(cos(10)) - 1.0) < 1e-5
    assert float(cos(110)) == pytest.approx(0.1, abs=1e-5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch olmo-1b --smoke --steps
    3 --device cpu`` and ``--mesh 2x1``: every loss finite; the two runs
    take the same global batches, so their losses agree (the mesh means
    two shards' losses)."""
    one = p_launch.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                         "--device", "cpu", "--seq", "16", "--batch", "4"])
    two = p_launch.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                         "--device", "cpu", "--seq", "16", "--batch", "4",
                         "--mesh", "2x1"])
    assert len(one) == len(two) == 3
    for a, b in zip(one, two):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    assert "[train] olmo-1b-smoke on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["olmo-1b", "llama-3.2-vision-90b",
                                  "whisper-tiny"])
def test_launcher_trains_on_a_2x2_mesh(arch):
    """``--mesh 2x2 --smoke --device cpu``: 4 rank threads (FSDP over
    data, tp 2, the state held as the ranks' shards) take the same global
    batches as ``--mesh 1x1`` (the vlm and audio archs with their stub
    image embeddings and frames cut over the mesh).  The first losses
    agree at 1e-4 relative; the second at 1e-3: the smoke configs are
    bf16, and tp = 2 rounds its partial sums in another order, so the
    first update differs by bf16 roundings (whisper-tiny: 2.0e-4 relative
    on the second loss; in float32 the two meshes' first gradients agree
    within 4.4e-4 of each leaf's largest element)."""
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--device", "cpu",
            "--seq", "16", "--batch", "4"]
    one = p_launch.main(argv + ["--mesh", "1x1"])
    four = p_launch.main(argv + ["--mesh", "2x2"])
    assert len(one) == len(four) == 2
    assert all(np.isfinite(r["loss"]) for r in four)
    np.testing.assert_allclose(four[0]["loss"], one[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(four[1]["loss"], one[1]["loss"], rtol=1e-3)


def test_launcher_loop_matches_reference_launcher():
    """The reference launcher's loop (``repro/launch/train.py``: the
    cosine schedule with 10 warmup steps, the jitted step, ``train_loop``
    over ``SyntheticPipeline``) and the port's :func:`train`, on the same
    carried params: the losses of 4 steps agree at 1e-4."""
    rcfg = dataclasses.replace(r_get_smoke("olmo-1b"), dtype=F32)
    steps, seq, batch, lr = 4, 16, 4, 1e-3
    (ropt, rstate, rspecs), (_, pmodel, pspecs, pparams) = _carried_state(
        rcfg, (r_cosine(lr, 10, steps), cosine_schedule(lr, 10, steps)))
    step = jax.jit(r_make_train_step(r_build_model(rcfg), rspecs, ropt))
    _, want = r_train_loop(
        rstate, step, RPipeline(vocab=rcfg.vocab, seq_len=seq,
                                global_batch=batch),
        RLoopConfig(total_steps=steps, log_every=0),
        batch_transform=lambda b, s: {k: jnp.asarray(v)
                                      for k, v in b.items()})
    state = TrainState(pparams, adamw_init(pparams, p_launch.opt_config(
        lr, steps)))
    got = p_launch.train(pmodel.cfg, state, pspecs, steps=steps, seq=seq,
                         batch=batch, lr=lr, device="cpu")
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-4)


# ---------------------------------------------------------------------------
# serving builds no graph
# ---------------------------------------------------------------------------

def test_serving_builds_no_graph():
    """Prefill, a decode step and ``Model.forward`` on params that
    require a gradient return outputs that do not."""
    cfg = port_config(r_get_smoke("gemma3-1b"))
    model = build_model(cfg, device="cpu")
    params, _ = model.init(0)
    params = tree_map(lambda p: p.requires_grad_(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(8, 2)).astype(np.int32))
    x, aux = model.forward(params, {"tokens": tok})
    assert not x.requires_grad and not any(v.requires_grad
                                           for v in aux.values())
    nxt, last = make_prefill_step(cfg)(params, {"tokens": tok})
    assert not nxt.requires_grad and not last.requires_grad
    cache = init_cache(cfg, 16, 2, device="cpu")
    nxt, cache = make_serve_step(cfg)(params, cache, tok[0])
    assert not nxt.requires_grad
