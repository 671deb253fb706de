"""Helper: the reference's cost walker on what the port's cost tests
count, in a child with fake devices.

    python torch_costs_ref.py collectives OUT.json   # 4 fake devices
    python torch_costs_ref.py cells SPEC.json OUT.json
    python torch_costs_ref.py transposes SPEC.json OUT  # 4 fake devices

``collectives``: each collective kind under ``shard_map`` on a (4,) mesh
(``ppermute`` on the forward and on the backward ring, tiled
``all_gather``, ``psum``, tiled ``psum_scatter``, ``pmax``, tiled
``all_to_all``) on a (8, 6) float32 operand a device, counted by
``repro.launch.costs.count_costs``: ``{case: Costs.as_dict()}``.

``cells``: the reference's ``dryrun.build_cell`` on the cells of
``SPEC.json`` (``{"shapes": {name: [kind, seq, batch]}, "cells": [[arch,
shape, {build_cell kwargs}], ...], "count": [cell indices], "compile":
[cell indices]}``; a cell's ``dtype`` names another dtype for its
smoke config) on a
(2, 2) ("data", "model") mesh, with ``dryrun.get_config`` rebound to the
smoke configs and ``dryrun.SHAPES`` to the spec's shapes (in this
process only): each cell's ``params`` / ``active_params``, for the cells
in ``count`` the ``count_costs`` of its ``shard_map``'d step, and for
those in ``compile`` the compiled step's ``argument_size_in_bytes``.
``transposes``: each ``Comm`` method's forward and ``jax.vjp`` pullback
on rank-stacked inputs (see :func:`transposes`), as
``tests/test_torch_comm_transposes.py`` holds the port's tape against
them.  Prints HELPER-OK.
"""
import json
import sys

MODE = sys.argv[1]


def collectives(out_path):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.launch.costs import count_costs

    n = 4
    mesh = make_mesh((n,), ("model",))
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    cases = {
        "ppermute_fwd": lambda x: lax.ppermute(x, "model", fwd),
        "ppermute_bwd": lambda x: lax.ppermute(x, "model", bwd),
        "rings": lambda x: lax.ppermute(lax.ppermute(x, "model", fwd),
                                        "model", bwd)
        + lax.ppermute(x, "model", fwd),
        "all_gather": lambda x: lax.all_gather(x, "model", axis=0,
                                               tiled=True),
        "psum": lambda x: lax.psum(x, "model"),
        "psum_scatter": lambda x: lax.psum_scatter(
            x, "model", scatter_dimension=0, tiled=True),
        "pmax": lambda x: lax.pmax(x, "model"),
        "all_to_all": lambda x: lax.all_to_all(x, "model", 0, 1,
                                               tiled=True),
    }
    x = jax.ShapeDtypeStruct((8 * n, 6), jnp.float32)
    out = {}
    for name, body in cases.items():
        fn = shard_map(body, mesh=mesh, in_specs=P("model"),
                       out_specs=P("model"), check_vma=False)
        out[name] = count_costs(jax.make_jaxpr(fn)(x),
                                {"model": n}).as_dict()
    with open(out_path, "w") as f:
        json.dump(out, f)


def cells(spec_path, out_path):
    import dataclasses

    import repro.launch.dryrun as dryrun    # sets 512 fake devices
    import jax
    import jax.numpy as jnp

    from repro.compat import make_mesh
    from repro.configs import Shape, get_smoke
    from repro.core.modes import CommMode
    from repro.launch.costs import count_costs

    spec = json.load(open(spec_path))
    dryrun.get_config = get_smoke
    dryrun.SHAPES = {k: Shape(k, *v) for k, v in spec["shapes"].items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for i, (arch, shape, kw) in enumerate(spec["cells"]):
        kw = dict(kw)
        dtype = kw.pop("dtype", None)
        dryrun.get_config = get_smoke if dtype is None else (
            lambda a: dataclasses.replace(get_smoke(a),
                                          dtype=getattr(jnp, dtype)))
        cfg = dryrun.get_config(arch)
        got = {"params": cfg.param_count(),
               "active_params": cfg.active_param_count()}
        if i not in spec["count"] and i not in spec["compile"]:
            out.append(got)
            continue
        jitted, raw, args = dryrun.build_cell(
            arch, shape, mesh, CommMode.LCI_DEDICATED, **kw)
        if i in spec["count"]:
            got["analytic"] = count_costs(jax.make_jaxpr(raw)(*args),
                                          sizes).as_dict()
        if i in spec.get("compile", []):
            mem = jitted.lower(*args).compile().memory_analysis()
            got["argument_size_in_bytes"] = int(mem.argument_size_in_bytes)
        out.append(got)
    with open(out_path, "w") as f:
        json.dump(out, f)


def _messages(jaxpr, sizes) -> list:
    """Every collective of ``jaxpr`` (sub-jaxprs and scan bodies, each
    counted once a trip): ``[kind, dtype, bytes, direction]``, the
    direction of a ppermute ``fwd`` when its first pair sends to the next
    rank, as ``repro.launch.costs`` reads it."""
    from repro.launch.costs import _sub_jaxprs

    kinds = {"ppermute": "ppermute", "psum": "psum",
             "psum_invariant": "psum", "pmax": "pmax",
             "all_gather": "all_gather", "reduce_scatter": "reduce_scatter",
             "all_to_all": "all_to_all"}
    out = []

    def walk(jx, mult):
        jx = jx.jaxpr if hasattr(jx, "jaxpr") else jx
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name in kinds:
                for v in eqn.invars:
                    if hasattr(v, "aval") and not hasattr(v, "val"):
                        a = v.aval
                        way = ""
                        if name == "ppermute":
                            src, dst = eqn.params["perm"][0]
                            n = max(max(q) for q in eqn.params["perm"]) + 1
                            way = "fwd" if dst == (src + 1) % n else "bwd"
                        out.extend([[kinds[name], str(a.dtype),
                                     int(a.size * a.dtype.itemsize),
                                     way]] * int(mult))
                continue
            if name == "scan":
                walk(eqn.params["jaxpr"], mult * eqn.params["length"])
                continue
            for sub in _sub_jaxprs(eqn.params):
                walk(sub, mult)
    walk(jaxpr, 1)
    return sorted(out)


def transposes(spec_path, out_path):
    """Each case of SPEC.json (``{"inputs": NPZ, "cases": [[id, method,
    P, mode, dtype, wire_bf16], ...]}``): under ``shard_map`` on a (P,)
    mesh, each rank runs the reference's ``Comm`` method on its inputs
    (``NPZ``'s ``method/P/i``, stacked a rank, and ``method/P/ct``, the
    rank's cotangent) and pulls the cotangent back through ``jax.vjp``.
    Writes ``{id: {"costs", "messages"}}`` (``count_costs`` and
    :func:`_messages` of the whole function) to OUT.json and each
    cotangent to OUT.npz (``id/i``; a bf16 case also ``id/f32/i``: the
    same inputs in float32)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.core.modes import CommConfig, CommMode
    from repro.distributed.comm import Comm
    from repro.launch.costs import count_costs
    from repro.models.layers import lm_head_loss

    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"])

    def method_fn(comm, method):
        if method == "ag_matmul":
            return comm.ag_matmul
        if method == "matmul_rs":
            return comm.matmul_rs
        if method == "ag_seq":
            return comm.ag_seq
        if method == "rs_seq":
            return comm.rs_seq
        if method == "a2a":
            return lambda x: comm.a2a(x, split_axis=0, concat_axis=1)
        if method == "weight":
            return lambda w: comm.weight(w, fsdp_axis=1)
        if method == "segment":
            def seg(x, w1, w2):
                h = jax.nn.gelu(comm.ag_matmul(x, w1))
                return x + comm.matmul_rs(h, w2)
            return jax.checkpoint(seg)
        if method == "loss":
            def loss(x, emb, labels):
                return lm_head_loss(x, emb, labels.astype(jnp.int32),
                                    comm, real_vocab=int(
                                        emb.shape[0] * comm.tp - 3))[0]
            return loss
        raise ValueError(method)

    info, grads = {}, {}
    for cid, method, p, mode, dtype, wire in spec["cases"]:
        axis = "data" if method == "weight" else "model"
        mesh = make_mesh((p,), (axis,), devices=jax.devices()[:p])
        comm = Comm(CommConfig(mode=CommMode(mode), wire_bf16=wire),
                    model_axis=None if axis == "data" else "model",
                    data_axis="data" if axis == "data" else None)
        fn = method_fn(comm, method)
        n_in = sum(1 for k in data.files
                   if k.startswith(f"{method}/{p}/") and k[-1].isdigit())

        def run(dt, fn=fn, n_in=n_in, method=method, p=p, axis=axis):
            xs = [jnp.asarray(data[f"{method}/{p}/{i}"]) for i in
                  range(n_in)]
            xs = [x if method == "loss" and i == 2 else x.astype(dt)
                  for i, x in enumerate(xs)]
            ct = jnp.asarray(data[f"{method}/{p}/ct"])

            def body(*a):
                a = [t[0] for t in a]
                ins, c = a[:-1], a[-1]
                diff = ins[:2] if method == "loss" else ins
                y, pull = jax.vjp(lambda *z: fn(*z, *ins[len(diff):]),
                                  *diff)
                return tuple(g[None] for g in pull(c.astype(y.dtype)))
            n_out = 2 if method == "loss" else n_in
            f = shard_map(body, mesh=mesh, in_specs=(P(axis),) * (n_in + 1),
                          out_specs=(P(axis),) * n_out, check_vma=False)
            return f, xs, ct

        dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        f, xs, ct = run(dt)
        jx = jax.make_jaxpr(f)(*xs, ct)
        info[cid] = {"costs": count_costs(jx, {axis: p}).as_dict(),
                     "messages": _messages(jx, {axis: p})}
        for i, g in enumerate(jax.jit(f)(*xs, ct)):
            grads[f"{cid}/{i}"] = np.asarray(g.astype(jnp.float32))
        if dtype == "bfloat16":
            f, xs, ct = run(jnp.float32)
            for i, g in enumerate(jax.jit(f)(*xs, ct)):
                grads[f"{cid}/f32/{i}"] = np.asarray(g)
    with open(out_path + ".json", "w") as fh:
        json.dump(info, fh)
    np.savez(out_path + ".npz", **grads)


if MODE == "collectives":
    collectives(sys.argv[2])
elif MODE == "transposes":
    transposes(sys.argv[2], sys.argv[3])
else:
    cells(sys.argv[2], sys.argv[3])
print("HELPER-OK")
