"""The port's vlm and audio families held against the JAX package on the
CPU.

The same numpy-seeded inputs, and the reference's own params carried
across with ``params_from_numpy``, go through both packages, in float32
at the tolerance of ``test_torch_models.py`` (1e-4).  The vision gates
start at zero in both packages (``tanh(0) = 0``: the cross-attention
layer adds nothing), so every model case here draws them nonzero with
numpy, and the vlm cases check that other image embeddings change the
hidden states and the decoded logits.

* ``sinusoidal_positions``; ``is_encdec``, ``attention_free``,
  ``layer_is_global``, ``param_count`` and ``active_param_count`` of
  every config and smoke config; ``n_cross_layers`` against the
  reference engine's count of cross-attention layers;
* ``init_params``: keys, shapes, dtypes and specs against the
  reference's (smoke and full configs; the full ones as meta tensors),
  the gates zero in the port's own draw;
* ``forward`` of ``tests/test_decode.py``'s ``vlm`` and ``whisper`` cases
  and of both smoke configs; the encoder's memory and
  ``precompute_cross_kv``; ``init_cache(n_memory=)``;
* teacher-forced decode: the reference's ``make_serve_step`` tokens
  (either of a near tie, as ``test_torch_serving.py`` allows) and more
  than 0.95 agreement with the port's own forward (``test_decode.py``'s
  bar), whisper's memory from each package's own encoder;
* the loss, its metrics and every gradient at tp = 1 against
  ``jax.value_and_grad`` (remat on and off, which must not change a bit);
* the train launcher on each family, its loop against the reference
  launcher's on carried params (the frontend stubs drawn alike), and a
  vlm ``TrainState`` checkpoint crossing the packages both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
from repro.checkpoint import restore as r_restore
from repro.checkpoint import save_sync as r_save_sync
from repro.configs import ARCH_NAMES
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.data import SyntheticPipeline as RPipeline
from repro.data import stub_frames as r_stub_frames
from repro.data import stub_image_embeds as r_stub_image_embeds
from repro.distributed.comm import local_comm as r_local_comm
from repro.models import lm as r_lm
from repro.models.blocks import tp_plan as r_tp_plan
from repro.models.common import ModelConfig as RConfig
from repro.models.registry import build_model as r_build_model
from repro.optim import AdamWConfig as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro.serving.engine import DecodeCache as RDecodeCache
from repro.serving.engine import _n_cross as r_n_cross
from repro.serving.engine import init_cache as r_init_cache
from repro.serving.engine import make_prefill_step as r_make_prefill_step
from repro.serving.engine import make_serve_step as r_make_serve_step
from repro.serving.engine import precompute_cross_kv as r_precompute
from repro.train import make_train_step as r_make_train_step
from repro.train import train_state_init as r_train_state_init
from repro.train.loop import LoopConfig as RLoopConfig
from repro.train.loop import train_loop as r_train_loop

import repro_torch.configs as p_configs
import repro_torch.launch.train as p_launch
import repro_torch.models.layers as p_layers
import repro_torch.serving.engine as p_engine
from repro_torch.checkpoint import restore, save_sync
from repro_torch.core.tree import leaves_with_paths
from repro_torch.distributed import local_comm
from repro_torch.models import lm as p_lm
from repro_torch.models.blocks import tp_plan
from repro_torch.models.layers import greedy_sample, lm_head_logits
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import init_cache, make_prefill_step, \
    make_serve_step
from repro_torch.train import (TrainState, loss_and_grads,
                               train_state_init)
from repro_torch.train.step import state_from_tree, state_tree
from test_torch_models import carried_model, port_config, \
    reference_compiled
from test_torch_serving import _same_or_near_tie
from test_torch_train import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F = jnp.float32
S, B = 16, 2
CROSS_ARCHS = ("llama-3.2-vision-90b", "whisper-tiny")

#: tests/test_decode.py's vlm and whisper cases, and both smoke configs;
#: each with the memory rows its batch carries
CASES = {
    "vlm": (RConfig(name="vlm", family="vlm", n_layers=4, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                    cross_attn_every=2, tp_target=4, dtype=F), 8),
    "whisper": (RConfig(name="whisper", family="audio", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab=128, norm="layernorm", mlp="gelu",
                        encoder_layers=2, tp_target=4, dtype=F,
                        tie_embeddings=True), 8),
    "llama-3.2-vision-90b-smoke": (r_get_smoke("llama-3.2-vision-90b"), 8),
    "whisper-tiny-smoke": (r_get_smoke("whisper-tiny"), 16),
}
SMOKE_CASES = ["llama-3.2-vision-90b-smoke", "whisper-tiny-smoke"]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _gates(rcfg, seed: int):
    """Nonzero gates (n_cross,) drawn with numpy: |tanh| 0.3-0.7."""
    n = rcfg.n_layers // rcfg.cross_attn_every
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.3, 0.9, n) * rng.choice([-1, 1], n)
             ).astype(np.float32) for _ in range(2)]


def model_pair(case: str, dtype: str = "float32"):
    """(rcfg, params, pcfg, pparams) with the reference's params carried
    across, the vision gates set nonzero in both."""
    cfg, _ = CASES[case]
    rcfg, params, pcfg, pparams = carried_model(cfg, dtype)
    if rcfg.family == "vlm":
        ga, gm = _gates(rcfg, 17)
        params = {**params, "cross_layers": {
            **params["cross_layers"], "gate_attn": jnp.asarray(ga),
            "gate_mlp": jnp.asarray(gm)}}
        pparams["cross_layers"]["gate_attn"] = torch.from_numpy(ga)
        pparams["cross_layers"]["gate_mlp"] = torch.from_numpy(gm)
    return rcfg, params, pcfg, pparams


def extras(case: str, b: int = B, seed: int = 5) -> dict:
    """The batch's frontend stub, numpy float32: image_embeds (ti, b, d)
    or frames (t, b, d)."""
    cfg, rows = CASES[case]
    x = np.random.default_rng(seed).standard_normal(
        (rows, b, cfg.d_model)).astype(np.float32)
    return {"image_embeds" if cfg.family == "vlm" else "frames": x}


def _tokens(cfg, s=S, b=B, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(s, b)
                                                ).astype(np.int32)


def _batches(tok, ext, labels=None):
    """The same batch for both packages."""
    r = {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v)
                                         for k, v in ext.items()}}
    p = {"tokens": torch.from_numpy(tok),
         **{k: torch.from_numpy(v) for k, v in ext.items()}}
    if labels is not None:
        r["labels"], p["labels"] = jnp.asarray(labels), \
            torch.from_numpy(labels)
    return r, p


# ---------------------------------------------------------------------------
# layers and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d,offset", [(5, 16, 0), (12, 64, 24),
                                        (7, 33, 3), (1500, 384, 0)])
def test_sinusoidal_positions_match_reference(s, d, offset):
    """1e-4, or two float32 ulps of the largest angle where that is more:
    the packages' float32 ``exp`` may round a frequency to neighbouring
    floats, and position p carries that as p ulps of the angle (at
    whisper's 1500 frames one ulp of the angle is 1.2e-4)."""
    want = r_layers.sinusoidal_positions(s, d, offset=offset)
    got = p_layers.sinusoidal_positions(s, d, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    atol = max(1e-4, 2 * float(np.spacing(np.float32(s - 1 + offset))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_properties_match_reference(arch):
    for ref, port in ((r_get_config(arch), p_configs.get_config(arch)),
                      (r_get_smoke(arch), p_configs.get_smoke(arch))):
        assert port.is_encdec == ref.is_encdec
        assert port.attention_free == ref.attention_free
        assert port.uses_subquadratic_attention() == \
            ref.uses_subquadratic_attention()
        assert [port.layer_is_global(i) for i in range(ref.n_layers + 2)] \
            == [ref.layer_is_global(i) for i in range(ref.n_layers + 2)]
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("case", list(ARCH_NAMES) + list(CASES))
def test_n_cross_layers_matches_reference(case):
    """``ModelConfig.n_cross_layers``, the port's one count of
    cross-attention layers (init, forward, the cache and the decode step
    read it), equals the reference engine's ``_n_cross``, and the port's
    stacked cross-attention params and cross-KV cache have that many
    layers."""
    refs = ([r_get_config(case), r_get_smoke(case)] if case in ARCH_NAMES
            else [CASES[case][0]])
    for ref in refs:
        cfg = port_config(ref)
        assert cfg.n_cross_layers == r_n_cross(ref)
        if ref is refs[-1] and cfg.n_cross_layers:
            params, _ = build_model(cfg, device="cpu").init(0)
            stack = params["cross_layers" if cfg.family == "vlm"
                           else "layers"]
            assert stack["x_wk"].shape[0] == cfg.n_cross_layers
            cache = init_cache(cfg, 4, 1, n_memory=3, device="cpu")
            assert cache.cross_k.shape[0] == cfg.n_cross_layers


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_init_params_match_reference(arch, smoke):
    """Keys, shapes, dtypes and specs of ``init_params`` against the
    reference's (the full configs as meta tensors: nothing is
    allocated); the port's own smoke draw has zero gates, as the
    reference's."""
    rcfg = r_get_smoke(arch) if smoke else r_get_config(arch)
    want, wspecs = r_build_model(rcfg).abstract_params()
    pcfg = port_config(rcfg, torch.bfloat16)
    got, gspecs = build_model(pcfg, device="meta").abstract_params()
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
    for name, w in _flat(wspecs).items():
        g = _flat(gspecs)[name]
        assert (g.tp_axis, g.fsdp_axis, g.stacked) == \
            (w.tp_axis, w.fsdp_axis, w.stacked), name
    if smoke:
        params, _ = build_model(pcfg, device="cpu").init(0)
        if rcfg.family == "vlm":
            for k in ("gate_attn", "gate_mlp"):
                g = params["cross_layers"][k]
                assert g.dtype == torch.float32 and not g.any()
        assert sorted(_flat(params)) == sorted(want)


# ---------------------------------------------------------------------------
# forward, the encoder's memory, the cross-KV
# ---------------------------------------------------------------------------

def _reference_forward(rcfg, params, batch):
    return reference_compiled(lambda p, b: r_build_model(rcfg).forward(
        p, b, remat=False), params, batch)(params, batch)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    """Hidden states at 1e-4 (float32), the aux terms at 1e-5; other
    frontend embeddings change the hidden states."""
    rcfg, params, pcfg, pparams = model_pair(case)
    ext = extras(case)
    rb, pb = _batches(_tokens(rcfg, s=12), ext)
    want, waux = _reference_forward(rcfg, params, rb)
    model = build_model(pcfg, device="cpu")
    got, aux = model.forward(pparams, pb)
    assert got.shape == want.shape and got.dtype == torch.float32
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    other = {k: torch.from_numpy(v) for k, v in extras(case, seed=6).items()}
    moved, _ = model.forward(pparams, {**pb, **other})
    assert float((moved - got).abs().max()) > 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_cross_kv_and_cache_match_reference(case):
    """The memory (whisper: the encoder's output, from each package's
    own encoder) and ``precompute_cross_kv`` at 1e-4; the cache's shapes,
    a vlm cache holding K/V for the self layers only."""
    rcfg, params, pcfg, pparams = model_pair(case)
    ext = extras(case)
    rb, pb = _batches(_tokens(rcfg), ext)
    if rcfg.is_encdec:
        rmem = r_lm._encode(params, rb, rcfg, r_local_comm(),
                            r_tp_plan(rcfg, 1), remat=False)
        pmem = p_lm._encode(pparams, pb, pcfg, local_comm(),
                            tp_plan(pcfg, 1), remat=False)
        np.testing.assert_allclose(_np(pmem), _np(rmem), atol=1e-4,
                                   rtol=1e-4)
    else:
        rmem, pmem = rb["image_embeds"], pb["image_embeds"]
    # the same memory into both (the encoders' 1e-4 apart is held above)
    wk, wv = r_precompute(params, rmem, rcfg)
    gk, gv = p_engine.precompute_cross_kv(pparams, torch.from_numpy(
        np.array(rmem)), pcfg)
    for g, w in ((gk, wk), (gv, wv)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)
    n_mem = rmem.shape[0]
    want = r_init_cache(rcfg, S, B, n_memory=n_mem)
    got = init_cache(pcfg, S, B, n_memory=n_mem, device="cpu")
    for f in ("k", "v", "cross_k", "cross_v"):
        assert tuple(getattr(got, f).shape) == getattr(want, f).shape, f
    if rcfg.family == "vlm":
        assert got.k.shape[0] == rcfg.n_layers - gk.shape[0]
    plain = init_cache(pcfg, S, B, device="cpu")
    assert plain.cross_k is None and plain.cross_v is None


def _ref_decode(rcfg, params, tokens, rb):
    """The reference's teacher-forced tokens (s, b), as
    ``tests/test_decode.py`` drives them, and its forward's logits."""
    comm = r_local_comm()
    if rcfg.is_encdec:
        mem = r_lm._encode(params, rb, rcfg, comm, r_tp_plan(rcfg, 1),
                           remat=False)
    else:
        mem = rb["image_embeds"]
    ck, cv = r_precompute(params, mem, rcfg, comm)
    c = r_init_cache(rcfg, S, B, n_memory=mem.shape[0])
    cache = RDecodeCache(k=c.k, v=c.v, cross_k=ck, cross_v=cv,
                         length=c.length)
    step = jax.jit(r_make_serve_step(rcfg))
    want = []
    for i in range(S):
        nxt, cache = step(params, cache, jnp.asarray(tokens[i]))
        want.append(np.asarray(nxt))
    x, _ = _reference_forward(rcfg, params, rb)
    head = params.get("lm_head", params["emb"])
    logits = np.asarray(r_layers.lm_head_logits(x, head, comm,
                                                real_vocab=rcfg.vocab))
    return np.stack(want), logits


def _port_decode(pcfg, pparams, tokens, pb, monkeypatch=None):
    """The port's teacher-forced tokens (s, b) and, with
    ``monkeypatch``, every step's logits."""
    if pcfg.is_encdec:
        mem = p_lm._encode(pparams, pb, pcfg, local_comm(),
                           tp_plan(pcfg, 1), remat=False)
    else:
        mem = pb["image_embeds"]
    cache = init_cache(pcfg, S, B, n_memory=mem.shape[0], device="cpu")
    cache.cross_k, cache.cross_v = p_engine.precompute_cross_kv(
        pparams, mem, pcfg)
    seen = []
    if monkeypatch is not None:
        def record(*a, **kw):
            seen.append(lm_head_logits(*a, **kw))
            return seen[-1]
        monkeypatch.setattr(p_engine, "lm_head_logits", record)
    step = make_serve_step(pcfg)
    got = []
    for i in range(S):
        nxt, cache = step(pparams, cache, torch.from_numpy(tokens[i]))
        assert nxt.dtype == torch.int32 and cache.length == i + 1
        got.append(nxt.numpy())
    return np.stack(got), seen


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_reference_and_forward(case, monkeypatch):
    rcfg, params, pcfg, pparams = model_pair(case)
    tokens = _tokens(rcfg)
    rb, pb = _batches(tokens, extras(case))
    want, logits = _ref_decode(rcfg, params, tokens, rb)
    got, seen = _port_decode(pcfg, pparams, tokens, pb, monkeypatch)
    assert _same_or_near_tie(case, got, want, logits).all()
    x, _ = build_model(pcfg, device="cpu").forward(pparams, pb)
    head = pparams.get("lm_head", pparams["emb"])
    oracle = greedy_sample(lm_head_logits(x, head, local_comm(),
                                          real_vocab=pcfg.vocab),
                           local_comm()).numpy()
    assert (got == oracle).mean() > 0.95
    # other frontend embeddings: other decoded logits
    other = {k: torch.from_numpy(v) for k, v in extras(case, seed=6).items()}
    _, seen2 = _port_decode(pcfg, pparams, tokens, {**pb, **other},
                            monkeypatch)
    assert len(seen) == len(seen2) == S
    assert max(float((a - b).abs().max()) for a, b in zip(seen, seen2)) \
        > 1e-3


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_prefill_step_matches_reference(case):
    rcfg, params, pcfg, pparams = model_pair(case)
    tokens = _tokens(rcfg, s=12)
    rb, pb = _batches(tokens, extras(case))
    want_tok, want_last = jax.jit(r_make_prefill_step(rcfg))(params, rb)
    got_tok, got_last = make_prefill_step(pcfg)(pparams, pb)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=1e-4, rtol=1e-4)
    x, _ = _reference_forward(rcfg, params, rb)
    head = params.get("lm_head", params["emb"])
    logits = np.asarray(r_layers.lm_head_logits(
        x, head, r_local_comm(), real_vocab=rcfg.vocab))[-1]
    assert _same_or_near_tie(case, got_tok.numpy()[None],
                             np.asarray(want_tok)[None], logits[None]).all()


# ---------------------------------------------------------------------------
# training at tp = 1
# ---------------------------------------------------------------------------

METRICS = ("loss", "ce", "ntok", "aux_lb", "aux_z", "dropped_frac")


def _float64_grads(pcfg, pparams, pb):
    """The port's gradients with params and frontend stub in float64."""
    cfg = dataclasses.replace(pcfg, dtype=torch.float64)
    params = jax.tree_util.tree_map(lambda t: t.double(), pparams)
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in pb.items()}
    return loss_and_grads(build_model(cfg, device="cpu"), params, batch,
                          local_comm(), remat=False)[2]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", SMOKE_CASES)
def test_loss_and_grads_match_reference(case, remat):
    """The loss, its metrics (1e-5) and the gradient of every param leaf
    against ``jax.value_and_grad`` of the reference's loss (float32);
    remat on and off give the same bits.

    A leaf's gradient is within 2e-4 of its largest element of the
    reference's, plus however far the reference's own float32 gradient
    lies from the port's float64 one.  That float64 run is the yardstick
    for rounding: whisper's encoder gradients pass through the whole
    decoder and the encoder's unmasked attention, and the reference's
    float32 ones lie up to 7.6e-4 of the leaf's max from it where the
    port's lie within 1.7e-4.  The float64 port must itself sit within
    2e-3 of the reference's gradient, so the allowance covers rounding
    only: a port computing another function fails there."""
    rcfg, params, pcfg, pparams = model_pair(case)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, rcfg.vocab, size=(S, B)).astype(np.int32)
    lab = rng.integers(0, rcfg.vocab, size=(S, B)).astype(np.int32)
    lab[0, 0] = -100
    rb, pb = _batches(tok, extras(case), lab)
    model = r_build_model(rcfg)

    def f(p, b):
        return jax.value_and_grad(lambda p: model.loss(p, b, remat=False),
                                  has_aux=True)(p)
    (_, want_m), want_g = reference_compiled(f, params, rb)(params, rb)
    pmodel = build_model(pcfg, device="cpu")
    _, metrics, grads = loss_and_grads(pmodel, pparams, pb, local_comm(),
                                       remat=remat)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7)
    flat_want = dict(leaves_with_paths(jax.tree_util.tree_map(
        np.asarray, want_g)))
    got = leaves_with_paths(grads)
    assert [n for n, _ in got] == sorted(flat_want)
    exact = dict(leaves_with_paths(_float64_grads(pcfg, pparams, pb)))
    for name, g in got:
        w = flat_want[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        scale = max(np.abs(w).max(), 1e-12)
        noise = np.abs(exact[name].numpy() - w).max()
        assert noise <= 2e-3 * scale, name
        assert np.abs(_np(g) - w).max() <= 2e-4 * scale + noise, name
    if rcfg.family == "vlm":
        assert np.abs(flat_want["cross_layers/gate_attn"]).max() > 0
    if remat:
        _, _, plain = loss_and_grads(pmodel, pparams, pb, local_comm(),
                                     remat=False)
        for (_, a), (_, b) in zip(got, leaves_with_paths(plain)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_train_launcher_runs_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --smoke``, on
    one device and ``--mesh 2x1`` (the stubs cut over data with the
    tokens): every loss finite, the two runs' losses within 1e-3 (the
    smoke configs are bf16, and a rank's products over 2 of the 4 rows
    round apart from the whole batch's; a stub cut wrongly would move
    the loss by far more)."""
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--device", "cpu",
            "--seq", "16", "--batch", "4"]
    one = p_launch.main(argv)
    two = p_launch.main(argv + ["--mesh", "2x1"])
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-3)
    assert f"[train] {arch}-smoke on cpu" in capsys.readouterr().out


def _reference_extras(cfg, batch, step):
    """The reference launcher's ``extras`` (``repro/launch/train.py``)."""
    out = {}
    if cfg.family == "vlm":
        out["image_embeds"] = r_stub_image_embeds(
            max(cfg.n_image_tokens, 4), batch, cfg.d_model, step)
    if cfg.is_encdec:
        t = max(((cfg.n_audio_frames + 15) // 16) * 16, 16)
        out["frames"] = r_stub_frames(t, batch, cfg.d_model, step)
    return {k: jnp.asarray(v, cfg.dtype) for k, v in out.items()}


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_launcher_loop_matches_reference_launcher(case):
    """The reference launcher's loop (cosine schedule, 10 warmup steps,
    the jitted step, ``train_loop`` with its frontend stubs) and the
    port's :func:`train` from the same carried params (gates nonzero):
    the losses of 3 steps at 1e-4."""
    rcfg, params, pcfg, pparams = model_pair(case)
    steps, seq, batch, lr = 3, 16, 4, 1e-3
    ropt = RAdamW(lr=r_cosine(lr, 10, steps))
    rstate, rspecs = r_train_state_init(r_build_model(rcfg),
                                        jax.random.PRNGKey(0), ropt)
    rstate.params = params
    if rstate.opt.master is not None:
        rstate.opt.master = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), params)
    step = jax.jit(r_make_train_step(r_build_model(rcfg), rspecs, ropt))
    _, want = r_train_loop(
        rstate, step, RPipeline(vocab=rcfg.vocab, seq_len=seq,
                                global_batch=batch),
        RLoopConfig(total_steps=steps, log_every=0),
        batch_transform=lambda b, s: {
            **{k: jnp.asarray(v) for k, v in b.items()},
            **_reference_extras(rcfg, batch, s)})
    _, pspecs = build_model(pcfg, device="cpu").init(0)
    state = TrainState(pparams, adamw_init(pparams, p_launch.opt_config(
        lr, steps)))
    got = p_launch.train(pcfg, state, pspecs, steps=steps, seq=seq,
                         batch=batch, lr=lr, device="cpu")
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-4)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_vlm_train_state_crosses_packages(tmp_path, direction):
    """A llama-3.2-vision smoke ``TrainState`` (bf16 params, the float32
    master and moments, gates nonzero) saved by one package restores
    bitwise in the other: the same leaf names (``cross_layers/...``)."""
    rcfg = r_get_smoke("llama-3.2-vision-90b")
    ropt = RAdamW(lr=1e-3)
    rstate, _ = r_train_state_init(r_build_model(rcfg),
                                   jax.random.PRNGKey(0), ropt)
    ga, gm = _gates(rcfg, 23)
    for tree in (rstate.params, rstate.opt.master, rstate.opt.mu):
        tree["cross_layers"]["gate_attn"] = jnp.asarray(ga)
        tree["cross_layers"]["gate_mlp"] = jnp.asarray(gm)
    pcfg = port_config(rcfg, torch.bfloat16)
    like, _ = train_state_init(build_model(pcfg, device="cpu"), 1,
                               AdamWConfig(lr=1e-3))
    want = dict(leaves_with_paths(jax.tree_util.tree_map(
        lambda a: np.asarray(a), (rstate.params, (
            rstate.opt.step, rstate.opt.mu, rstate.opt.nu,
            rstate.opt.master)))))
    assert any(n.startswith("0/cross_layers/") for n in want)

    def bits(a):
        """bf16 (``ml_dtypes``, or ``V2`` from the reference's restore)
        as its bits."""
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.itemsize == 2 else a

    def to_port(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    if direction == "reference_to_port":
        r_save_sync(str(tmp_path), 3, rstate)
        tree, _ = restore(str(tmp_path), state_tree(like), device="cpu")
        got = state_from_tree(tree)
        for name, g in leaves_with_paths(state_tree(got)):
            w = want[name]
            assert g.dtype == to_port(w).dtype, name
            assert np.array_equal(bits(g.view(torch.int16).numpy())
                                  if g.dtype == torch.bfloat16
                                  else g.numpy(), bits(w)), name
    else:
        pstate = state_from_tree(jax.tree_util.tree_map(
            to_port, (rstate.params, (rstate.opt.step, rstate.opt.mu,
                             rstate.opt.nu, rstate.opt.master))))
        save_sync(str(tmp_path), 3, state_tree(pstate))
        got, manifest = r_restore(str(tmp_path), rstate)
        assert manifest["step"] == 3
        flat = dict(leaves_with_paths(jax.tree_util.tree_map(
            np.asarray, (got.params, (got.opt.step, got.opt.mu,
                                      got.opt.nu, got.opt.master)))))
        assert sorted(flat) == sorted(want)
        for name, w in want.items():
            assert np.array_equal(bits(flat[name]), bits(w)), name
