"""The port's in-graph collectives held against the reference under
``shard_map``.

The same numpy-drawn inputs go through the reference's nine collectives
on P fake devices (``tests/helpers/torch_collectives_ref.py``, one child
process a P, run side by side) and through the port's on P rank threads
of ``LocalCluster(P, device="cpu")`` (``LciAxis``, through ``spmd_map``),
for P in {2, 3, 4, 8}, every ``CommMode``, float32 and bfloat16 inputs,
and ``wire_bf16`` off and on in the LCI modes.  Every rank's output is
compared:

* bitwise: the gathers, the all-to-alls (chunked and the monolithic
  fallbacks), the barrier token, the tree broadcast and reduce, and
  partial ``ppermute`` (non-targets get zeros);
* in float32, the ring reduce-scatter and all-reduce of the LCI modes
  (the same adds in the same order), also bitwise; the all-gather matmul
  at 1e-4 and the matmul reduce-scatter and every BSP or fallback psum at
  1e-3 (``collectives_check.py``'s tolerances: the same sums in another
  order);
* in bfloat16, and under ``wire_bf16``, every case with a sum at
  ``P * 2**-7 * max|reference|``: each of the up to P - 1 hops (or the
  final rounding) may round the accumulator to bfloat16 on another side
  of a tie, one bfloat16 ulp (2**-7 relative) each.

Then ``DistAxis`` over gloo at P = 4 (four spawned processes): the LCI
modes bitwise equal to ``LciAxis``, BSP (``all_reduce`` and friends) at
the tolerances above against the reference.  And the port's own
mechanics: two rings in flight at once never match each other's
messages, and the reference's indivisible ``reduce_scatter`` (which
``psum_scatter`` cannot take either) raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.core.modes import CommConfig, CommMode
from repro_torch.distributed import Mesh, P, spmd_map

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
PS = (2, 3, 4, 8)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARGS = ("x", "xk", "w", "wk", "r", "r1", "y", "rf", "y2", "y3")
SPECS = (P("x"), P(None, "x"), P(), P("x"), P("x"), P("x"), P("x"),
         P("x"), P("x"), P("x"))
BITWISE = {"ag", "ag1", "a2a", "a2a_feat", "a2a_odd"}
CONFIGS = [(m, dt, w) for m in CommMode for dt in DTYPES
           for w in (False, True) if not (w and m == CommMode.BSP)]


def make_inputs(p: int) -> dict:
    rng = np.random.default_rng(100 + p)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"x": normal(4 * p, 8 * p), "xk": normal(4 * p, 8 * p),
            "w": normal(8 * p, 6), "wk": normal(8 * p, 6),
            "r": normal(p * 4 * p, 6), "r1": normal(2 * p, 2 * p, 6),
            "y": normal(2 * p, 4 * p, 8), "rf": normal(p * (p + 1), 6),
            "y2": normal(2 * p, 4 * p), "y3": normal(2 * p, 4 * p, 3),
            "v": normal(p, 3)}


def main_cases(cfg, ax, x, xk, w, wk, r, r1, y, rf, y2, y3) -> dict:
    """The helper's ``main_cases``, on the port."""
    return {
        "ag": C.all_gather(x, ax, cfg),
        "ag1": C.all_gather(xk, ax, cfg, axis=1),
        "agmm": C.all_gather_matmul(x, w, ax, cfg),
        "mrs": C.matmul_reduce_scatter(xk, wk, ax, cfg),
        "rs": C.reduce_scatter(r, ax, cfg),
        "rs1": C.reduce_scatter(r1, ax, cfg, axis=1),
        "ar": C.all_reduce(r, ax, cfg),
        "a2a": C.all_to_all(y, ax, split_axis=1, concat_axis=0, config=cfg),
        "ar_fb": C.all_reduce(rf, ax, cfg),
        "ar0": C.all_reduce(rf.sum(), ax, cfg),
        "a2a_feat": C.all_to_all(y2, ax, split_axis=1, concat_axis=0,
                                 config=cfg),
        "a2a_odd": C.all_to_all(y3, ax, split_axis=1, concat_axis=0,
                                config=cfg),
    }


def misc_cases(ax, v) -> dict:
    p = ax.size
    chain = [(i, i + 1) for i in range(p - 1)]
    return {
        "barrier": C.dissemination_barrier(ax),
        "tree_b": C.tree_broadcast(v[0], ax, root=p - 1),
        "tree_r": C.tree_reduce(v[0], ax, root=1 % p),
        "tree_r0": C.tree_reduce(v[0], ax, root=0),
        "pperm_chain": ax.ppermute(v[0], chain),
        "pperm_one": ax.ppermute(v[0], [(0, p - 1)]),
    }


def all_cases(comm, *args):
    """Every config's cases on this rank (a module-level function, so the
    gloo ranks can run it too): {key: local output (1, ...)}."""
    ax = comm.model_axis
    *main, v = args
    out = {}
    for mode, dt, wire in CONFIGS:
        cfg = CommConfig(mode=mode, wire_bf16=wire)
        conv = [a.to(DTYPES[dt]) for a in main]
        for name, o in main_cases(cfg, ax, *conv).items():
            out[f"{mode.value}/{dt}/{int(wire)}/{name}"] = o[None].float()
    for name, o in misc_cases(ax, v).items():
        out[f"misc/{name}"] = o[None].float()
    return out


def _run(mesh: Mesh, data: dict) -> dict:
    args = [torch.from_numpy(data[a]) for a in ARGS + ("v",)]
    out = spmd_map(all_cases, mesh, SPECS + (P("x"),), P("x"),
                   model_axis="x")(*args)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{P: (reference outputs, LciAxis outputs)}: the P helpers run side
    by side while the port computes."""
    tmp = tmp_path_factory.mktemp("collectives")
    procs = {}
    for p in PS:
        data = make_inputs(p)
        np.savez(tmp / f"in{p}.npz", **data)
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={p}")
        procs[p] = subprocess.Popen(
            [sys.executable, os.path.join(HELPERS,
                                          "torch_collectives_ref.py"),
             str(tmp / f"in{p}.npz"), str(tmp / f"out{p}.npz"), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    port = {}
    try:
        for p in PS:
            with Mesh((p,), ("x",), device="cpu") as mesh:
                port[p] = _run(mesh, make_inputs(p))
        out = {}
        for p, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "HELPER-OK" in stdout, stderr
            out[p] = (dict(np.load(tmp / f"out{p}.npz")), port[p])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _check(key: str, got: np.ndarray, want: np.ndarray, p: int) -> None:
    mode, dt, wire, name = key.split("/")
    assert got.shape == want.shape, (key, got.shape, want.shape)
    summed = name not in BITWISE
    if not summed:
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif dt == "bfloat16" or wire == "1":
        tol = p * 2.0 ** -7 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=key)
    elif mode != "bsp" and name in ("rs", "rs1", "ar"):
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        tol = 1e-4 if name == "agmm" else 1e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("mode,dtype,wire", CONFIGS,
                         ids=[f"{m.value}-{d}-wire{int(w)}"
                              for m, d, w in CONFIGS])
@pytest.mark.parametrize("p", PS)
def test_collectives_match_reference(cases, p, mode, dtype, wire):
    ref, port = cases[p]
    prefix = f"{mode.value}/{dtype}/{int(wire)}/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert len(keys) == 12 and set(keys) <= set(port)
    for k in keys:
        _check(k, port[k], ref[k], p)


@pytest.mark.parametrize("p", PS)
def test_barrier_trees_and_partial_ppermute_bitwise(cases, p):
    """Barrier token (P for a power of two; the reference's dissemination
    doubles the token each round, so 4 at P = 3), tree broadcast from
    the last rank, tree reduce to rank 1 and rank 0, and partial
    permutations whose non-targets get zeros — all bitwise."""
    ref, port = cases[p]
    for k in [k for k in ref if k.startswith("misc/")]:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert (port["misc/pperm_chain"][0] == 0).all()
    assert port["misc/barrier"].tolist() == [2 ** int(np.ceil(np.log2(p)))
                                             ] * p


def test_rings_in_flight_never_cross_match():
    """Both rings of the dedicated mode posted before either is waited
    on, on one device and on two: each arrival is its own ring's."""
    def fn(comm, x):
        ax = comm.model_axis
        p = ax.size
        outs = []
        for chans in ((0, 1), (None, None)):
            fwd = ax.ppermute_start(x + 1000.0, [(i, (i + 1) % p)
                                                 for i in range(p)],
                                    channel=chans[0])
            bwd = ax.ppermute_start(x + 2000.0, [(i, (i - 1) % p)
                                                 for i in range(p)],
                                    channel=chans[1])
            outs += [bwd.wait(), fwd.wait()]
        return torch.stack(outs)[None]
    for p in (3, 4):
        x = torch.arange(p, dtype=torch.float32).reshape(p, 1)
        with Mesh((p,), ("x",), device="cpu") as mesh:
            got = spmd_map(fn, mesh, (P("x"),), P("x"), model_axis="x")(x)
        for r in range(p):
            for k in (0, 2):
                assert got[r, k].item() == (r + 1) % p + 2000.0
                assert got[r, k + 1].item() == (r - 1) % p + 1000.0


def test_indivisible_reduce_scatter_raises():
    """The reference's ``reduce_scatter`` falls back to ``psum_scatter``
    when the axis does not divide, which cannot take an indivisible
    dim either; the port raises there too."""
    def fn(comm, x):
        return C.reduce_scatter(x, comm.model_axis, comm.cfg)[None]
    with Mesh((2,), ("x",), device="cpu") as mesh:
        with pytest.raises(RuntimeError, match="does not divide"):
            spmd_map(fn, mesh, (P(),), P("x"), model_axis="x")(
                torch.ones(3, 4))


def test_rendezvous_pieces_and_protocol_counts():
    """Pieces above ``eager_max_bytes`` go by rendezvous (no buffer-copy
    packet), pieces below it are eager; the ring's result is the same."""
    def fn(comm, x):
        return C.all_gather(x, comm.model_axis, comm.cfg)[None]
    for rows, proto in ((8, "inject"), (512, "zerocopy")):
        x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
            (4 * rows, 64)).astype(np.float32))
        with Mesh((4,), ("x",), device="cpu") as mesh:
            got = spmd_map(fn, mesh, (P("x"),), P("x"), model_axis="x",
                           config=CommConfig(mode=CommMode.LCI_DEDICATED))(x)
            totals = mesh.protocol_totals()
        assert all(torch.equal(g, x) for g in got)
        assert totals[f"{proto}_msgs"] == 4 * 3
        assert totals["bufcopy_msgs"] == 0


def test_dist_axis_over_gloo_matches(cases):
    """``DistAxis`` at P = 4 over gloo (four spawned processes): every
    LCI-mode case bitwise equal to ``LciAxis`` (the fallbacks' psum at the
    tolerances above: gloo sums in its own order), and BSP against the
    reference at the tolerances above."""
    p = 4
    data = make_inputs(p)
    args = [torch.from_numpy(data[a]) for a in ARGS + ("v",)]
    with Mesh((p,), ("x",), substrate="dist", device="cpu") as mesh:
        dist = spmd_map(all_cases, mesh, SPECS + (P("x"),), P("x"),
                        model_axis="x")(*args)
    ref, lci = cases[p]
    for k, v in dist.items():
        v = v.numpy()
        mode, dt, wire, name = (k.split("/") + [""] * 4)[:4]
        if k.startswith("misc/") or (mode != "bsp" and name not in
                                     ("ar_fb", "ar0")):
            np.testing.assert_array_equal(v, lci[k], err_msg=k)
        else:
            _check(k, v, ref[k], p)
