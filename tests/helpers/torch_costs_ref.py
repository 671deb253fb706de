"""Helper: the reference's cost walker on what the port's cost tests
count, in a child with fake devices.

    python torch_costs_ref.py collectives OUT.json   # 4 fake devices
    python torch_costs_ref.py cells SPEC.json OUT.json

``collectives``: each collective kind under ``shard_map`` on a (4,) mesh
(``ppermute`` on the forward and on the backward ring, tiled
``all_gather``, ``psum``, tiled ``psum_scatter``, ``pmax``, tiled
``all_to_all``) on a (8, 6) float32 operand a device, counted by
``repro.launch.costs.count_costs``: ``{case: Costs.as_dict()}``.

``cells``: the reference's ``dryrun.build_cell`` on the cells of
``SPEC.json`` (``{"shapes": {name: [kind, seq, batch]}, "cells": [[arch,
shape, {build_cell kwargs}], ...], "count": [cell indices], "compile":
[cell indices]}``) on a
(2, 2) ("data", "model") mesh, with ``dryrun.get_config`` rebound to the
smoke configs and ``dryrun.SHAPES`` to the spec's shapes (in this
process only): each cell's ``params`` / ``active_params``, for the cells
in ``count`` the ``count_costs`` of its ``shard_map``'d step, and for
those in ``compile`` the compiled step's ``argument_size_in_bytes``.
Prints HELPER-OK.
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
    import repro.launch.dryrun as dryrun    # sets 512 fake devices
    import jax

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
        cfg = get_smoke(arch)
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


if MODE == "collectives":
    collectives(sys.argv[2])
else:
    cells(sys.argv[2], sys.argv[3])
print("HELPER-OK")
