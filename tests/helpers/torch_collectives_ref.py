"""Helper: the reference's in-graph collectives under ``shard_map`` on P
fake devices, on inputs drawn with numpy by the port's test.

    python torch_collectives_ref.py IN.npz OUT.npz P

``IN.npz`` holds the test's float32 inputs (``tests/
test_torch_collectives.py::make_inputs``); ``OUT.npz`` gets one float32
array a case, named ``mode/dtype/wire/case`` (or ``misc/case``), each of
shape (P, ...): every rank's local output, stacked.  The conftest's
runner sets XLA_FLAGS to P devices before jax is imported.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as Ps

from repro.compat import make_mesh, shard_map
from repro.core import collectives as C
from repro.core.modes import CommConfig, CommMode

IN, OUT, NP = sys.argv[1], sys.argv[2], int(sys.argv[3])
MESH = make_mesh((NP,), ("x",))
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARGS = ("x", "xk", "w", "wk", "r", "r1", "y", "rf", "y2", "y3")
SPECS = (Ps("x"), Ps(None, "x"), Ps(), Ps("x"), Ps("x"), Ps("x"), Ps("x"),
         Ps("x"), Ps("x"), Ps("x"))


def compiled(fn, args, in_specs, n_out):
    f = jax.jit(shard_map(fn, mesh=MESH, in_specs=in_specs,
                          out_specs=(Ps("x"),) * n_out, check_vma=False))
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def main_cases(cfg, x, xk, w, wk, r, r1, y, rf, y2, y3):
    """Every collective at the mode of ``cfg``: names and outputs."""
    out = {
        "ag": C.all_gather(x, "x", cfg),
        "ag1": C.all_gather(xk, "x", cfg, axis=1),
        "agmm": C.all_gather_matmul(x, w, "x", cfg),
        "mrs": C.matmul_reduce_scatter(xk, wk, "x", cfg),
        "rs": C.reduce_scatter(r, "x", cfg),
        "rs1": C.reduce_scatter(r1, "x", cfg, axis=1),
        "ar": C.all_reduce(r, "x", cfg),
        "a2a": C.all_to_all(y, "x", split_axis=1, concat_axis=0,
                            config=cfg),
        # the fallbacks: psum for an indivisible leading dim and for 0-d;
        # a monolithic all-to-all when the feature axis is the split axis
        # or does not divide into the channels
        "ar_fb": C.all_reduce(rf, "x", cfg),
        "ar0": C.all_reduce(rf.sum(), "x", cfg),
        "a2a_feat": C.all_to_all(y2, "x", split_axis=1, concat_axis=0,
                                 config=cfg),
        "a2a_odd": C.all_to_all(y3, "x", split_axis=1, concat_axis=0,
                                config=cfg),
    }
    return out


def misc_cases(v):
    p = NP
    chain = [(i, i + 1) for i in range(p - 1)]
    return {
        "barrier": C.dissemination_barrier("x"),
        "tree_b": C.tree_broadcast(v[0], "x", root=p - 1),
        "tree_r": C.tree_reduce(v[0], "x", root=1 % p),
        "tree_r0": C.tree_reduce(v[0], "x", root=0),
        "pperm_chain": jax.lax.ppermute(v[0], "x", chain),
        "pperm_one": jax.lax.ppermute(v[0], "x", [(0, p - 1)]),
    }


def main():
    data = dict(np.load(IN))
    results = {}
    for mode in CommMode:
        for dt in ("float32", "bfloat16"):
            for wire in (False, True):
                if wire and mode == CommMode.BSP:
                    continue
                cfg = CommConfig(mode=mode, wire_bf16=wire)
                args = [jnp.asarray(data[a], DTYPES[dt]) for a in ARGS]
                names = []

                def fn(*a):
                    outs = main_cases(cfg, *a)
                    names[:] = list(outs)
                    return tuple(o[None] for o in outs.values())
                got = compiled(fn, args, SPECS, 12)
                for n, g in zip(names, got):
                    results[f"{mode.value}/{dt}/{int(wire)}/{n}"] = \
                        np.asarray(g, np.float32)
    names = []

    def fn(v):
        outs = misc_cases(v)
        names[:] = list(outs)
        return tuple(o[None] for o in outs.values())
    got = compiled(fn, [jnp.asarray(data["v"])], (Ps("x"),), 6)
    for n, g in zip(names, got):
        results[f"misc/{n}"] = np.asarray(g, np.float32)
    np.savez(OUT, **results)
    print("HELPER-OK")


main()
