"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device.

* every kernel wrapper's meta outputs (and gradients) have its plain
  version's shapes and dtypes;
* ``run_cell`` on a smoke config of each family on an abstract (2, 2)
  mesh, for train, prefill and decode, and at ``tp2d`` / ``pad_heads``;
* parity with the reference's ``build_cell`` + ``count_costs`` on those
  cells (``tests/helpers/torch_costs_ref.py``, a child on fake devices
  with ``dryrun.get_config`` / ``SHAPES`` rebound to the smoke configs
  and small shapes): prefill and decode collectives (bytes by kind,
  ppermute bytes and steps by direction) equal; params equal; argument
  bytes equal to the reference's ``memory_analysis()`` once the named
  differences are added back; prefill and decode flops equal once the
  named differences are added back, each computed from the cell's calls;
* two full-config cells on the production (16, 16) mesh, and the command
  line writing only under ``--out``.

The named differences (each a ROADMAP §C row):

* ``flash``: B2's formula counts the (padded) tiles the kernel visits;
  the reference's scan counts every (q, k) pair at the true head dim,
  ``4 b hq sq skv dh`` a call;
* ``ssd``: B5's formula counts the kernel's chunked products at its own
  chunk; the reference counts its chunked einsums at ``cfg.ssm_chunk``
  (its walker's count of ``repro.models.ssm.ssd_scan`` at the call's
  shapes);
* ``ssd_decode``: the reference's decode-step state update is an einsum
  (``2 b h n p`` FLOPs a call); the port's is a broadcast product;
* ``ssm_pad``: the port pads the SSM mixer's fused ``[z | x | dt]``
  projection to a multiple of 64 columns (16-byte aligned rows for the
  GEMM), ``2 rows d pad`` FLOPs a prefill layer (a training layer: its
  forward, its recompute and the backward's two products);
* ``length``: ``DecodeCache.length`` is a host int in the port, a 4-byte
  int32 argument in the reference;
* ``unused``: ``jax.jit`` prunes arguments the step never reads (the
  encoder or vision weights at decode); the port's argument bytes count
  every shard it is handed (``unused_argument_bytes``).

Train cells (``train_s``, and gemma3-1b's in float32 too: ``dtype``)
add two named differences, each a ROADMAP §C row:

* ``loss_remat``: the port checkpoints each loss chunk (one chunk's
  float32 logits live at a time) and recomputes its logits in backward,
  ``2 rows d V_local`` a chunk; the reference keeps the chunks'
  residuals (its ``lax.map`` is not rematerialized).  The recompute
  reuses the chunk's collectives' outputs, so it sends nothing;
* ``vjp``: a kernel wrapper's backward is the autograd of its plain
  version recomputed from the saved inputs (the flops counted inside
  ``plain_vjp``: the plain forward and its backward); the reference's is
  JAX's AD of its own jnp code, counted without its forward: flash
  ``8 b hq sq skv dh`` a call (four products), moe ``2 x`` its two
  einsums, ssd the walker's count of ``jax.vjp``'s pullback of
  ``repro.models.ssm.ssd_scan`` at ``cfg.ssm_chunk``, rmsnorm 0.

Their collectives are equal: the tape's remat leaves out what the
reference's leaves out, and each transpose sends what JAX's AD of the
reference's ring sends.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.costs import count_costs as ref_count
from repro.models.ssm import ssd_scan as ref_ssd_scan

import repro_torch.models.lm as port_lm
import repro_torch.models.ssm as port_ssm
import repro_torch.serving.engine as port_engine
from repro_torch.configs import Shape, get_smoke
from repro_torch.core.modes import CommMode
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd)
from repro_torch.kernels import cost_sinks
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bhsp
from repro_torch.kernels.ssm_conv import ssm_conv
from repro_torch.launch import dryrun
from repro_torch.models.blocks import tp_plan

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

FAMILIES = {"dense": "gemma3-1b", "moe": "olmoe-1b-7b",
            "ssm": "mamba2-370m", "hybrid": "hymba-1.5b",
            "vlm": "llama-3.2-vision-90b", "audio": "whisper-tiny"}
SHAPES = {"train_s": ["train", 32, 4], "prefill_s": ["prefill", 32, 4],
          "decode_s": ["decode", 64, 4], "long_s": ["decode", 64, 1]}
CELLS = [[a, k, {}] for a in FAMILIES.values()
         for k in ("prefill_s", "decode_s", "train_s")]
CELLS += [["mamba2-370m", "long_s", {}], ["hymba-1.5b", "long_s", {}],
          ["gemma3-1b", "decode_s", {"tp2d": True}],
          ["hymba-1.5b", "prefill_s", {"pad_heads": True}],
          ["gemma3-1b", "train_s", {"dtype": "float32"}]]
#: the cells whose step the helper compiles for its argument bytes: a
#: prefill's params and a train state's shards, and a decode cache of the
#: vlm, the audio and the ssm family (the named differences)
COMPILED = [CELLS.index(c) for c in (
    ["gemma3-1b", "prefill_s", {}], ["gemma3-1b", "train_s", {}],
    ["llama-3.2-vision-90b", "decode_s", {}],
    ["whisper-tiny", "decode_s", {}], ["mamba2-370m", "long_s", {}])]
#: the cells whose collectives and flops are compared: every one
COUNTED = list(range(len(CELLS)))


def _cell_id(c):
    return "-".join([c[0], c[1]] + sorted(c[2]))


# ---------------------------------------------------------------------------
# the reference's counts, computed in a child while the port's tests run
# ---------------------------------------------------------------------------

class _Reference:
    def __init__(self, tmp):
        spec = tmp / "spec.json"
        self.out = tmp / "out.json"
        spec.write_text(json.dumps({"shapes": SHAPES, "cells": CELLS,
                                    "count": COUNTED,
                                    "compile": COMPILED}))
        env = dict(os.environ, PYTHONPATH=SRC)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HELPERS, "torch_costs_ref.py"),
             "cells", str(spec), str(self.out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._got = None

    def result(self):
        if self._got is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "HELPER-OK" in out, err
            self._got = json.loads(self.out.read_text())
        return self._got


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("dryrun_ref"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


# ---------------------------------------------------------------------------
# meta outputs
# ---------------------------------------------------------------------------

def _wrapper_calls():
    g = torch.Generator().manual_seed(1)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    bf = torch.bfloat16
    return [
        ("rmsnorm", rmsnorm, (r(6, 32, dtype=bf), r(32)), {}),
        ("flash_seq", flash_attention,
         (r(40, 2, 4, 64, dtype=bf), r(40, 2, 2, 64, dtype=bf),
          r(40, 2, 2, 64, dtype=bf)), {"window": 8}),
        ("flash_bhsd", flash_attention_bhsd,
         (r(2, 4, 40, 24), r(2, 2, 40, 24), r(2, 2, 40, 24)),
         {"causal": False}),
        ("moe_gmm", moe_gmm, (r(3, 5, 16, dtype=bf), r(3, 16, 48, dtype=bf),
                              r(3, 24, 16, dtype=bf)), {"act": "swiglu"}),
        ("ssd_seq", ssd_scan, (r(40, 2, 4, 16, dtype=bf), r(40, 2, 4).abs(),
                               r(4), r(40, 2, 2, 16, dtype=bf),
                               r(40, 2, 2, 16, dtype=bf), r(4)), {}),
        ("ssd_bhsp", ssd_scan_bhsp, (r(2, 4, 40, 8), r(2, 4, 40).abs(),
                                     r(4), r(2, 2, 40, 8), r(2, 2, 40, 8),
                                     r(4)), {"h0": r(2, 4, 8, 8)}),
        ("ssm_conv", ssm_conv, (r(11, 2, 24, dtype=bf),
                                r(11, 2, 4, dtype=bf), r(4, 24, dtype=bf),
                                r(4)), {}),
    ]


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("call", _wrapper_calls(), ids=lambda c: c[0])
def test_meta_outputs_and_gradients_have_the_plain_shapes(call):
    """Each wrapper on meta tensors returns its plain version's shapes and
    dtypes, and its recorded backward (the plain version's autograd, run
    on meta) gives gradients of the inputs' shapes and dtypes."""
    _, fn, args, kw = call

    def run(device):
        xs = [a.to(device).requires_grad_(a.is_floating_point())
              for a in args]
        kws = {k: v.to(device) for k, v in kw.items()
               if isinstance(v, torch.Tensor)}
        kws.update({k: v for k, v in kw.items()
                    if not isinstance(v, torch.Tensor)})
        outs = _outs(fn(*xs, **kws))
        loss = sum(o.float().sum() for o in outs)
        grads = torch.autograd.grad(loss, xs)
        return outs, grads
    cpu_outs, cpu_grads = run("cpu")
    meta_outs, meta_grads = run("meta")
    assert all(o.is_meta for o in meta_outs)
    assert [(o.shape, o.dtype) for o in meta_outs] == \
        [(o.shape, o.dtype) for o in cpu_outs]
    assert [(t.shape, t.dtype) for t in meta_grads] == \
        [(t.shape, t.dtype) for t in cpu_grads]


def test_tc_scratch_is_allocated_on_meta():
    """B5 "tc" allocates its scratch on meta too (``tc_scratch_bytes``),
    so the dry run's peak sees it; a meta tensor never reaches a CUDA
    launch (``_launch`` still raises for it)."""
    from repro_torch.launch.costs import CostCounter
    bs, h, s, p, g, n = 2, 4, 256, 16, 1, 32
    x = torch.empty(s, bs, h, p, dtype=torch.bfloat16, device="meta")
    b = torch.empty(s, bs, g, n, dtype=torch.bfloat16, device="meta")
    dt = torch.empty(s, bs, h, device="meta")
    a = torch.empty(h, device="meta")
    with CostCounter() as c:
        ssd_scan(x, dt, a, b, b, a)
    outs = 2 * x.numel() + 4 * bs * h * n * p
    assert c.peak_bytes >= outs + ssd_ops.tc_scratch_bytes(bs, h, s, p, g,
                                                           n)
    xt, dtt, bt, _ = ssd_ops._seq_major(x, dt, b, b)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops._launch(xt, dtt, a, bt, bt, a, None, torch.empty_like(xt))


# ---------------------------------------------------------------------------
# the smoke cells on an abstract (2, 2) mesh
# ---------------------------------------------------------------------------

REF_KEYS = ("cell", "status", "arch", "shape", "mesh", "mode", "n_devices",
            "lower_s", "compile_s", "flops_per_device",
            "bytes_accessed_per_device", "collectives", "n_collective_ops",
            "params", "active_params", "analytic", "roofline",
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "alias_size_in_bytes")
ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "bsp_bound_s", "lci_bound_s", "overlap_speedup",
                 "model_flops_per_device", "useful_flop_ratio",
                 "roofline_fraction")


class _Calls:
    """The kernel and decode-step calls of one traced cell, for the named
    flop differences: flash (q, k shapes seq-major or not), ssd (x, b
    shapes and the chunk the model asked for), ssd_decode (h_state
    shape), the loss chunks (their head products) and each wrapper's
    backward (its plain version's counted flops and its inputs'
    shapes)."""

    def __init__(self, monkeypatch):
        self.flash, self.ssd, self.decode = [], [], []
        self.heads, self.vjps = [], []
        head = port_lm.lm_head_loss

        def head_loss(x, emb, *a, **kw):
            self.heads.append(2 * x.numel() * emb.shape[0])
            return head(x, emb, *a, **kw)
        monkeypatch.setattr(port_lm, "lm_head_loss", head_loss)
        for kind, mod in (("flash", flash_ops), ("moe", moe_ops),
                          ("ssd", ssd_ops), ("rmsnorm", rms_ops)):
            monkeypatch.setattr(mod, "plain_vjp",
                                self._vjp(kind, mod.plain_vjp))
        f_cost, s_cost = flash_ops.cost, ssd_ops.cost
        step = port_ssm.ssd_decode_step
        s_fn = ssd_ops.ssd_scan

        def flash_cost(q, k, **kw):
            self.flash.append((tuple(q.shape), tuple(k.shape), kw,
                               f_cost(q, k, **kw)[0]))
            return f_cost(q, k, **kw)

        def ssd_cost(x, dt, a_log, b, c, d_skip, h0, **kw):
            got = s_cost(x, dt, a_log, b, c, d_skip, h0, **kw)
            self.ssd[-1][2] = got[0]
            return got

        def ssd_scan_rec(x, dt, a_log, b, c, d_skip, *, chunk=128, h0=None):
            self.ssd.append([tuple(x.shape), tuple(b.shape), None, chunk])
            return s_fn(x, dt, a_log, b, c, d_skip, chunk=chunk, h0=h0)

        def decode_step(h_state, *a):
            self.decode.append(tuple(h_state.shape))
            return step(h_state, *a)
        monkeypatch.setattr(flash_ops, "cost", flash_cost)
        monkeypatch.setattr(ssd_ops, "cost", ssd_cost)
        monkeypatch.setattr(port_ssm, "ssd_scan_kernel", ssd_scan_rec)
        monkeypatch.setattr(port_engine, "ssd_decode_step", decode_step)

    def _vjp(self, kind, fn):
        def vjp(plain, inputs, wanted, cotangents):
            sink = [m for m in cost_sinks() if hasattr(m, "costs")][-1]
            before = sink.costs.flops
            got = fn(plain, inputs, wanted, cotangents)
            self.vjps.append((kind, [tuple(t.shape) if isinstance(
                t, torch.Tensor) else t for t in inputs],
                sink.costs.flops - before))
            return got
        return vjp

    def _ref_bwd(self, cfg, kind, shapes) -> float:
        """The reference's backward flops of one kernel call."""
        if kind == "rmsnorm":
            return 0
        if kind == "flash":                 # the layout of its forward
            q, k = shapes[0], shapes[1]
            seq = any(c[0] == q and c[2]["seq_major"] for c in self.flash)
            sq, b, hq, dh = q if seq else (q[2], q[0], q[1], q[3])
            skv = k[0] if seq else k[2]
            return 8 * b * hq * sq * skv * dh
        if kind == "moe":
            (e, c, d), (_, _, m), (_, f, _) = shapes[:3]
            return 2 * (2 * e * c * d * m + 2 * e * c * f * d)
        x, bshape = shapes[0], shapes[3]    # ssd: as its forward's x
        if not any(c[0] == x for c in self.ssd):
            x = (x[2], x[0], x[1], x[3])
            bshape = (bshape[2], bshape[0], bshape[1], bshape[3])
        sds = jax.ShapeDtypeStruct
        dt = jnp.float32
        args = (sds(x, dt), sds(x[:3], dt), sds(x[2:3], dt),
                sds(bshape, dt), sds(bshape, dt), sds(x[2:3], dt))

        def fwd(*a):
            return ref_ssd_scan(*a, chunk=cfg.ssm_chunk)[0]

        def both(*a):
            y, pull = jax.vjp(fwd, *a)
            return pull(y)
        return (ref_count(jax.make_jaxpr(both)(*args), {}).flops
                - ref_count(jax.make_jaxpr(fwd)(*args), {}).flops)

    def named_flops(self, cfg, shape) -> dict:
        """port − reference flops, by named difference (``shape``: the
        cell's (kind, seq, batch) on the (2, 2) mesh)."""
        flash = 0
        for q, k, kw, got in self.flash:
            sq, b, hq, dh = q if kw["seq_major"] else (q[2], q[0], q[1], q[3])
            skv = k[0] if kw["seq_major"] else k[2]
            flash += got - 4 * b * hq * sq * skv * dh
        ssd = 0
        for x, bshape, got, chunk in self.ssd:
            s, bs, h, p = x
            g, n = bshape[2], bshape[3]
            sds = jax.ShapeDtypeStruct
            dt = jnp.float32
            want = ref_count(jax.make_jaxpr(
                lambda *a: ref_ssd_scan(*a, chunk=chunk))(
                sds(x, cfg_jnp(cfg)), sds((s, bs, h), dt), sds((h,), dt),
                sds(bshape, cfg_jnp(cfg)), sds(bshape, cfg_jnp(cfg)),
                sds((h,), dt)), {}).flops
            ssd += got - want
        decode = -sum(2 * bs * h * n * p for bs, h, n, p in self.decode)
        pad = 0
        if self.ssd and shape[0] in ("prefill", "train"):
            shard = tp_plan(cfg, 2).shard_ssm_heads
            tp = 2 if shard else 1
            cols = -(2 * cfg.ssm_d_inner // tp + cfg.ssm_heads // tp) % 64
            rows = (shape[1] if shard else shape[1] // 2) * shape[2] // 2
            # a forward product a call; in training the backward's two
            # (dx and dw) a call too
            products = len(self.ssd) + 2 * sum(
                kind == "ssd" for kind, _, _ in self.vjps)
            pad = products * 2 * rows * cfg.d_model * cols
        vjp = sum(got - self._ref_bwd(cfg, kind, shapes)
                  for kind, shapes, got in self.vjps)
        remat = sum(self.heads) / 2 if shape[0] == "train" else 0
        return {"flash": flash, "ssd": ssd, "ssd_decode": decode,
                "ssm_pad": pad, "loss_remat": remat, "vjp": vjp}


def cfg_jnp(cfg):
    return jnp.bfloat16 if cfg.dtype == torch.bfloat16 else jnp.float32


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    monkeypatch.setattr(dryrun, "SHAPES", {k: Shape(k, *v)
                                           for k, v in SHAPES.items()})
    return dryrun.AbstractMesh((2, 2), ("data", "model"))


_PORT_CELLS = {}


def _port_cell(cell, mesh, monkeypatch):
    """(artifact, named flop differences) of one smoke cell, traced once."""
    key = _cell_id(cell)
    if key not in _PORT_CELLS:
        arch, shape, kw = cell
        kw = dict(kw)
        if kw.pop("dtype", None):
            monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses
                                .replace(get_smoke(a), dtype=torch.float32))
        calls = _Calls(monkeypatch)
        art = dryrun.run_cell(arch, shape, False, CommMode.LCI_DEDICATED,
                              save=False, mesh=mesh, **kw)
        _PORT_CELLS[key] = (art, calls.named_flops(dryrun.cell_config(
            arch, pad_heads=kw.get("pad_heads", False)), SHAPES[shape]))
    return _PORT_CELLS[key]


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_smoke_cell_runs_on_an_abstract_2x2_mesh(cell, smoke, monkeypatch,
                                                 reference):
    """``run_cell`` traces rank 0's step on meta: ok, every reference key,
    every roofline key, the family's kernels recorded, no loop left
    unknown."""
    arch, shape, kw = cell
    art, _ = _port_cell(cell, smoke, monkeypatch)
    assert art["status"] == "ok"
    assert set(REF_KEYS) <= set(art) and set(ROOFLINE_KEYS) <= set(
        art["roofline"])
    assert art["n_devices"] == 4 and art["analytic"]["unknown_while"] == 0
    assert art["flops_per_device"] == art["analytic"]["flops"] > 0
    kernels = art["analytic"]["kernels"]
    cfg = get_smoke(arch)
    if cfg.family != "ssm" and shape != "decode_s" and shape != "long_s":
        assert kernels["flash_attention"]["launches"] > 0
    if cfg.family in ("ssm", "hybrid") and shape in ("prefill_s", "train_s"):
        assert kernels["ssd_scan"]["launches"] > 0
    if cfg.family == "moe":
        assert kernels["moe_gmm"]["launches"] > 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_local_cell_counts_equal_on_cpu_and_meta(arch, smoke):
    """``chip_smoke.py`` 22a's gate, rehearsed on the CPU: a prefill's
    counts (matmuls, each kernel's formula and launches) and argument
    bytes are the same when it runs (the plain versions paused) as when
    the dry run traces it on the meta device."""
    shape = Shape("p", "prefill", 32, 2)
    got = {}
    for device in ("cpu", "meta"):
        fn, args = dryrun.local_cell(arch, shape, device=device)
        got[device] = dryrun.trace_cell(fn, args)
    cpu, meta = got["cpu"], got["meta"]
    assert cpu["costs"].kernels == meta["costs"].kernels
    assert (cpu["costs"].flops, cpu["costs"].dot_bytes) == (
        meta["costs"].flops, meta["costs"].dot_bytes)
    assert cpu["argument_size_in_bytes"] == meta["argument_size_in_bytes"]


# ---------------------------------------------------------------------------
# full configs on the production mesh, and the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("olmoe-1b-7b", "train_4k"),
                                        ("gemma3-1b", "decode_32k")])
def test_full_config_cell_on_the_production_mesh(arch, shape):
    art = dryrun.run_cell(arch, shape, False, CommMode.LCI_DEDICATED,
                          save=False)
    assert art["status"] == "ok" and art["n_devices"] == 256
    assert set(REF_KEYS) <= set(art) and set(ROOFLINE_KEYS) <= set(
        art["roofline"])
    assert art["analytic"]["flops"] > 0
    assert art["analytic"]["unknown_while"] == 0
    assert art["argument_size_in_bytes"] > 0 and art["temp_size_in_bytes"] > 0
    if shape == "train_4k":
        # the state is updated in place but for the step counter (a new
        # int32 scalar); the batch is read only
        assert art["alias_size_in_bytes"] == art["argument_size_in_bytes"] \
            - art["unused_argument_bytes"] - _batch_bytes(arch, shape) - 4


def _batch_bytes(arch, shape):
    s = dryrun.SHAPES[shape]
    return 2 * 4 * (s.seq_len // 16) * (s.global_batch // 16)


def test_command_line_writes_only_under_out(tmp_path):
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "long_500k",
                        "--mesh", "multi", "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [
        "gemma3-1b__long_500k__multi__lci_dedicated.json",
        "whisper-tiny__decode_32k__single__lci_dedicated.json"]
    art = json.loads((tmp_path / names[0]).read_text())
    assert art["status"] == "ok" and art["n_devices"] == 512
    assert set(REF_KEYS) <= set(art)


DIRS = ("ppermute_fwd_bytes", "ppermute_bwd_bytes", "ppermute_fwd_steps",
        "ppermute_bwd_steps")


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_smoke_cell_matches_the_reference(cell, smoke, monkeypatch,
                                          reference):
    """Params equal; argument bytes equal to the reference's compiled
    step's once ``unused`` (and at decode ``length``) are added back;
    prefill and decode: collectives equal, and flops equal once the
    named kernel and decode-step differences are added back;
    train cells alike, their ``loss_remat`` and ``vjp`` differences
    added back too."""
    art, named = _port_cell(cell, smoke, monkeypatch)
    ref = reference.result()[CELLS.index(cell)]
    assert (art["params"], art["active_params"]) == (
        ref["params"], ref["active_params"])
    if "argument_size_in_bytes" in ref:
        length = 4 if cell[1] in ("decode_s", "long_s") else 0
        assert art["argument_size_in_bytes"] - \
            art["unused_argument_bytes"] + length == \
            ref["argument_size_in_bytes"]
    a, r = art["analytic"], ref["analytic"]
    assert a["coll_bytes_by_kind"] == r["coll_bytes_by_kind"]
    assert {k: a[k] for k in DIRS} == {k: r[k] for k in DIRS}
    assert a["flops"] - sum(named.values()) == r["flops"], named
