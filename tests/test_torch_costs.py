"""The port's op and collective counter (``repro_torch.launch.costs``)
against the reference's jaxpr walker, and each kernel wrapper's formula.

* every case of ``tests/test_costs.py`` through the port's counter, with
  the same numbers (a Python loop stands for the scan);
* the collectives on P = 4 CPU rank threads (``LciAxis``) and on the dry
  run's shape-only axis, against the reference's walker inside
  ``shard_map`` on 4 fake devices (``tests/helpers/torch_costs_ref.py``),
  the ppermute direction split included (the case the reference skips);
* each kernel formula against its plain version's counted matmuls at a
  shape where the kernel visits every block, and the same counts on the
  CPU and on the meta device.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.launch.costs import count_costs as ref_count

from repro_torch.core.axis import DistAxis, LciAxis, RECORDED
from repro_torch.distributed import Mesh, P, spmd_map
from repro_torch.distributed.spmd_map import PER_RANK
from repro_torch.kernels.doorbell import stage_copy, stage_copy_rows
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bhsp
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_tc_ref
from repro_torch.kernels.ssm_conv import ssm_conv
from repro_torch.launch.costs import Costs, CostCounter, count_costs
from repro_torch.launch.dryrun import CostAxis

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _ref(fn, *args):
    return ref_count(jax.make_jaxpr(fn)(*args), {"model": 4, "data": 2})


# ---------------------------------------------------------------------------
# tests/test_costs.py's cases
# ---------------------------------------------------------------------------

class TestFlops:
    def test_plain_matmul(self):
        _, c = count_costs(lambda x, y: x @ y, torch.ones(8, 16),
                           torch.ones(16, 4))
        assert c.flops == 2 * 8 * 16 * 4
        assert c.dot_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4

    def test_batched_einsum(self):
        a = torch.ones(3, 8, 16, dtype=torch.bfloat16)
        b = torch.ones(3, 16, 4, dtype=torch.bfloat16)
        _, c = count_costs(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                           a, b)
        assert c.flops == 2 * 3 * 8 * 16 * 4
        r = _ref(lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
                 jax.ShapeDtypeStruct((3, 8, 16), jnp.bfloat16),
                 jax.ShapeDtypeStruct((3, 16, 4), jnp.bfloat16))
        assert (c.flops, c.dot_bytes) == (r.flops, r.dot_bytes)

    def test_loop_stands_for_the_scan(self):
        def fn(x):
            c = x
            for _ in range(7):
                c = c @ x
            return c
        _, c = count_costs(fn, torch.ones(8, 8))
        assert c.flops == 7 * 2 * 8 * 8 * 8
        assert c.unknown_while == 0

    def test_nested_loops(self):
        def fn(x):
            c = x
            for _ in range(5):
                for _ in range(3):
                    c = c @ x
            return c
        _, c = count_costs(fn, torch.ones(4, 4))
        assert c.flops == 5 * 3 * 2 * 4 ** 3

    def test_remat_gradient_equals_the_reference(self):
        def fn(x):
            x = x.detach().requires_grad_()
            y = checkpoint(lambda y: (y @ y).sum(), x, use_reentrant=False)
            return torch.autograd.grad(y, x)[0]
        _, c = count_costs(fn, torch.ones(8, 8))

        def rfn(x):
            return jax.grad(jax.checkpoint(lambda y: (y @ y).sum()))(x)
        r = _ref(rfn, jax.ShapeDtypeStruct((8, 8), jnp.float32))
        assert c.flops >= 3 * 2 * 8 ** 3
        assert (c.flops, c.dot_bytes) == (r.flops, r.dot_bytes)


class TestCollectives:
    def test_link_bytes_takes_busier_direction(self):
        c = Costs()
        c.coll_bytes["ppermute"] = 100.0
        c.ppermute_fwd_bytes = 60.0
        c.ppermute_bwd_bytes = 40.0
        assert c.link_bytes == 60.0
        c.coll_bytes["psum"] = 10.0
        assert c.link_bytes == 70.0          # non-split adds on top

    def test_every_axis_records(self):
        for cls in (LciAxis, DistAxis, CostAxis):
            for name in RECORDED:
                assert getattr(getattr(cls, name), "recorded", False), \
                    (cls.__name__, name)


N = 4
FWD = [(i, (i + 1) % N) for i in range(N)]
BWD = [(i, (i - 1) % N) for i in range(N)]
CASES = {
    "ppermute_fwd": lambda ax, x: ax.ppermute(x, FWD),
    "ppermute_bwd": lambda ax, x: ax.ppermute(x, BWD),
    "rings": lambda ax, x: ax.ppermute(ax.ppermute(x, FWD), BWD)
    + ax.ppermute(x, FWD),
    "all_gather": lambda ax, x: ax.all_gather(x, 0),
    "psum": lambda ax, x: ax.psum(x),
    "psum_scatter": lambda ax, x: ax.psum_scatter(x, 0),
    "pmax": lambda ax, x: ax.pmax(x),
    "all_to_all": lambda ax, x: ax.all_to_all(x, 0, 1),
}
KEYS = ("coll_bytes_by_kind", "coll_bytes_total", "coll_link_bytes",
        "ppermute_fwd_bytes", "ppermute_bwd_bytes", "ppermute_fwd_steps",
        "ppermute_bwd_steps")


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll") / "out.json"
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
    r = subprocess.run([sys.executable, os.path.join(
        HELPERS, "torch_costs_ref.py"), "collectives", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "HELPER-OK" in r.stdout, r.stderr
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def lci_collectives():
    """Each case on P = 4 rank threads, every rank's own counts."""
    got = {}
    with Mesh((N,), ("model",), device="cpu") as mesh:
        for name, body in CASES.items():
            def fn(comm, x, body=body):
                return count_costs(body, comm.model_axis, x)[1].as_dict()
            run = spmd_map(fn, mesh, in_specs=(P("model", None),),
                           out_specs=PER_RANK, data_axis=None)
            got[name] = run(torch.zeros(8 * N, 6))
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_lci_axis_counts_equal_the_reference(case, reference_collectives,
                                             lci_collectives):
    """Every rank thread's counts (rank 0's first) equal the reference's
    per-device walk, bytes by kind and ppermute bytes and steps by
    direction."""
    want = reference_collectives[case]
    for got in lci_collectives[case]:
        assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}


@pytest.mark.parametrize("case", list(CASES))
def test_cost_axis_counts_equal_the_reference(case, reference_collectives):
    """The dry run's shape-only axis (rank 0 of 4, meta operands)."""
    ax = CostAxis(N, 0, "model")
    _, c = count_costs(CASES[case], ax, torch.empty(8, 6, device="meta"))
    want = reference_collectives[case]
    assert {k: c.as_dict()[k] for k in KEYS} == {k: want[k] for k in KEYS}


# ---------------------------------------------------------------------------
# the kernel formulas
# ---------------------------------------------------------------------------

def _matmuls(fn, *args, **kw):
    """flops of the matmuls ``fn`` (a plain version) dispatches."""
    return count_costs(fn, *args, **kw)[1].flops


@pytest.mark.parametrize("dtype,dh,s", [(torch.bfloat16, 64, 256),
                                        (torch.float32, 32, 128)],
                         ids=["tc_dh64_s256", "simt_dh32_s128"])
def test_flash_formula_is_the_plain_matmuls_unmasked(dtype, dh, s):
    """B2 unmasked (causal off, no window) at sq = skv multiples of the
    variant's tiles and an instantiated head dim: the kernel visits every
    block, so its formula is the plain version's two products."""
    q = torch.zeros(2, 4, s, dh, dtype=dtype)
    k = torch.zeros(2, 2, s, dh, dtype=dtype)
    want = _matmuls(flash_attention_ref, q, k, k, causal=False)
    _, c = count_costs(flash_attention_bhsd, q, k, k, causal=False)
    assert c.kernels["flash_attention"] == {
        "launches": 1, "flops": want,
        "bytes": 2 * (q.numel() + k.numel()) * q.element_size()}
    assert c.flops == want                  # the plain version uncounted


def test_flash_formula_skips_masked_blocks():
    """Causal at 4 tiles of 128: the kernel visits 1 + 2 + 3 + 4 of the
    16 (q, kv) tiles; a 128-key window from the third tile on visits 2
    tiles a q tile (the first only 1)."""
    q = torch.zeros(1, 2, 512, 64, dtype=torch.bfloat16)
    per_tile = 4 * 2 * 64 * 128 * 128
    _, c = count_costs(flash_attention_bhsd, q, q, q, causal=True)
    assert c.flops == 10 * per_tile
    _, c = count_costs(flash_attention_bhsd, q, q, q, causal=True,
                       window=128)
    assert c.flops == 7 * per_tile


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_formula_is_the_plain_matmuls_all_rows(act):
    """B4 with all rows (no ``rows``): 3 products for a gated activation,
    2 otherwise, the plain version's matmuls exactly."""
    e, cap, d, f = 4, 8, 16, 24
    x = torch.zeros(e, cap, d, dtype=torch.bfloat16)
    w1 = torch.zeros(e, d, (2 if act == "swiglu" else 1) * f,
                     dtype=torch.bfloat16)
    w2 = torch.zeros(e, f, d, dtype=torch.bfloat16)
    want = _matmuls(moe_gmm_ref, x, w1, w2, act=act)
    _, c = count_costs(moe_gmm, x, w1, w2, act=act)
    assert c.kernels["moe_gmm"]["flops"] == want == c.flops
    assert want == 2 * e * cap * d * f * (3 if act == "swiglu" else 2)


def test_ssd_formula_is_the_chunked_plain_matmuls():
    """B5 "tc" (bf16, P and N multiples of 16) at s = 2 chunks of 128:
    the formula is ``ssd_scan_tc_ref``'s products at chunk 128; "simt"
    (float32) at chunk 64 with one head a group and P = 32 (one block of
    state columns, so C.B^T once a head): the chunked plain version's
    products at chunk 64."""
    bs, h, g, s, p, n = 2, 4, 2, 256, 16, 32
    x = torch.zeros(bs, h, s, p, dtype=torch.bfloat16)
    dt = torch.zeros(bs, h, s)
    a = torch.zeros(h)
    b = torch.zeros(bs, g, s, n, dtype=torch.bfloat16)
    want = _matmuls(ssd_scan_tc_ref, x, dt, a, b, b, a, chunk=128)
    _, c = count_costs(ssd_scan_bhsp, x, dt, a, b, b, a)
    assert c.flops == c.kernels["ssd_scan"]["flops"] == want
    x = torch.zeros(bs, 2, s, 32)
    b = torch.zeros(bs, 2, s, n)
    dt = torch.zeros(bs, 2, s)
    a = torch.zeros(2)
    assert ssd_ops.variant(x, b) == "simt"
    want = _matmuls(ssd_scan_tc_ref, x, dt, a, b, b, a, chunk=64)
    _, c = count_costs(ssd_scan_bhsp, x, dt, a, b, b, a)
    assert c.flops == want


def _calls():
    """One call of every wrapper on small CPU tensors: (name, fn, args,
    kwargs)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    bf = torch.bfloat16
    return [
        ("rmsnorm", rmsnorm, (r(6, 32), r(32)), {}),
        ("flash_seq", flash_attention,
         (r(48, 2, 4, 24), r(48, 2, 2, 24), r(48, 2, 2, 24)),
         {"causal": True, "window": 16}),
        ("flash_bhsd", flash_attention_bhsd,
         (r(2, 4, 40, 64, dtype=bf), r(2, 2, 40, 64, dtype=bf),
          r(2, 2, 40, 64, dtype=bf)), {"causal": True, "q_offset": 8}),
        ("moe_gmm", moe_gmm, (r(3, 5, 16), r(3, 16, 48), r(3, 24, 16)),
         {"act": "swiglu"}),
        ("ssd_seq", ssd_scan, (r(40, 2, 4, 16, dtype=bf), r(40, 2, 4).abs(),
                               r(4), r(40, 2, 2, 16, dtype=bf),
                               r(40, 2, 2, 16, dtype=bf), r(4)), {}),
        ("ssd_bhsp", ssd_scan_bhsp, (r(2, 4, 40, 8), r(2, 4, 40).abs(),
                                     r(4), r(2, 2, 40, 8), r(2, 2, 40, 8),
                                     r(4)), {"h0": r(2, 4, 8, 8)}),
        ("ssm_conv", ssm_conv, (r(11, 2, 24, dtype=bf),
                                r(11, 2, 4, dtype=bf), r(4, 24, dtype=bf),
                                r(4)), {}),
        ("stage_copy", stage_copy, (r(5, 12),), {"wire_bf16": True}),
        ("stage_copy_rows", stage_copy_rows, ([r(3, 4)] * 300,), {}),
    ]


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, list):
        return [_meta(t) for t in x]
    return x


@pytest.mark.parametrize("call", _calls(), ids=lambda c: c[0])
def test_one_count_a_call_equal_on_cpu_and_meta(call):
    """Each wrapper records its formula once a call (the launches the card
    makes), the same on the CPU (its plain version runs paused) and on
    the meta device (nothing runs)."""
    _, fn, args, kw = call
    _, cpu = count_costs(fn, *args, **kw)
    _, meta = count_costs(fn, *_meta(args), **kw)
    assert cpu.kernels == meta.kernels and len(cpu.kernels) == 1
    assert (cpu.flops, cpu.dot_bytes) == (meta.flops, meta.dot_bytes)
    (k,) = cpu.kernels.values()
    assert k["launches"] == (2 if call[0] == "stage_copy_rows" else 1)
    assert cpu.flops == k["flops"]


def test_counter_is_per_thread_and_nests():
    """A counter sees its own thread's ops only; an inner counter's ops
    reach the outer one too."""
    import threading
    x = torch.ones(4, 4)
    with CostCounter() as outer:
        with CostCounter() as inner:
            x @ x
        t = threading.Thread(target=lambda: x @ x)
        t.start()
        t.join()
    assert inner.costs.flops == 2 * 4 ** 3
    assert outer.costs.flops == 2 * 4 ** 3


def test_a_storage_freed_inside_the_counters_lock_does_not_deadlock():
    """A storage's finalizer (``CostCounter._free``) can run on the
    counting thread while the counter holds its lock (the collector runs
    inside ``_track``'s bookkeeping): the lock is reentrant, so the
    thread goes on instead of waiting on itself."""
    counter = CostCounter()
    done = threading.Event()

    def bookkeeping():
        with counter._lock:
            counter._free(0)
        done.set()
    t = threading.Thread(target=bookkeeping, daemon=True)
    t.start()
    t.join(5)
    assert done.is_set()
