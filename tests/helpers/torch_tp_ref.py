"""Helper: the reference's tensor-parallel forward, decode and Comm
methods under ``shard_map`` on a (data 2, model 4) mesh of 8 fake
devices, on params and tokens drawn with numpy by the port's test.

    python torch_tp_ref.py forward|decode|comm IN.npz CASES.json OUT.npz

``CASES.json`` maps a case name to its ``ModelConfig`` fields (float32);
``IN.npz`` holds each case's params (``<case>/<path>``), tokens
(``<case>/tokens``) and, for a vlm or audio case, its frontend stub
(``<case>/image_embeds`` or ``<case>/frames``).  ``OUT.npz`` gets, per
case and mode:

* ``forward``: the post-final-norm hidden states (s, b, d) and the aux
  terms of ``forward`` at tokens (32, 4) sharded ("model", "data"),
  image embeddings (ti, 4, d) at (None, "data", None), frames (t, 4, d)
  at ("model", "data", None);
* ``decode``: the teacher-forced greedy tokens (S, b) of the classic and
  the tp2d decode (``joint_kv`` when b == 1), and the local oracle's; a
  vlm or audio case's cross-KV is computed once at one rank
  (``precompute_cross_kv`` of the image embeddings, or of the encoder's
  memory) and cut by ``cache_pspecs``;
* ``comm``: every rank's results of the ``Comm`` methods, stacked.

The conftest-style environment (XLA_FLAGS for 8 devices, PYTHONPATH) is
set by the caller.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as Ps

from repro.compat import make_mesh, shard_map
from repro.core.modes import CommConfig, CommMode
from repro.core.progress import EndpointSpec
from repro.distributed.comm import Comm
from repro.distributed.comm import local_comm
from repro.models import lm as lm_mod
from repro.models.blocks import tp_plan
from repro.models.common import ModelConfig
from repro.models.registry import build_model
from repro.serving.engine import (DecodeCache, cache_pspecs, init_cache,
                                  make_serve_step, precompute_cross_kv)

KIND, IN, CASES, OUT = sys.argv[1:5]
MESH = make_mesh((2, 4), ("data", "model"))
F = jnp.float32
OPTS = {"xla_allow_excess_precision": False}
#: a case's inputs in IN.npz, with their batch specs
INPUTS = {"image_embeds": Ps(None, "data", None),
          "frames": Ps("model", "data", None)}


def is_input(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in ("tokens",) + tuple(INPUTS)


def extras(data, name):
    """The case's frontend stub, by batch key."""
    return {k: jnp.asarray(data[f"{name}/{k}"]) for k in INPUTS
            if f"{name}/{k}" in data}


def unflatten(data, prefix):
    tree = {}
    for k, v in data.items():
        if not k.startswith(prefix + "/") or is_input(k):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)


def case_setup(name, fields, data):
    cfg = ModelConfig(name=name, dtype=F, **fields)
    m = build_model(cfg)
    _, specs = m.init(jax.random.PRNGKey(0))
    params = unflatten(data, name)
    pspecs = jax.tree_util.tree_map(lambda sp: sp.pspec(), specs)
    return cfg, m, params, pspecs


def run_forward(cases, data, out):
    for name, fields in cases.items():
        cfg, m, params, pspecs = case_setup(name, fields, data)
        tokens = jnp.asarray(data[name + "/tokens"], jnp.int32)
        ext = extras(data, name)
        for mode in (CommMode.BSP, CommMode.LCI_DEDICATED):
            comm = Comm(CommConfig(mode=mode), model_axis="model",
                        data_axis="data")

            def fwd(p, t, e):
                x, aux = m.forward(p, {"tokens": t, **e}, comm, remat=False)
                return x, {k: v[None] for k, v in aux.items()}
            f = shard_map(fwd, mesh=MESH,
                          in_specs=(pspecs, Ps("model", "data"),
                                    {k: INPUTS[k] for k in ext}),
                          out_specs=(Ps(None, "data"),
                                     Ps(("data", "model"))),
                          check_vma=False)
            x, aux = compiled(f, params, tokens, ext)(params, tokens, ext)
            out[f"{name}/{mode.value}/x"] = np.asarray(x)
            for k, v in aux.items():
                out[f"{name}/{mode.value}/{k}"] = np.asarray(v)


def fresh_cache(cfg, params, data, name, S, batch):
    """A zeroed cache; a vlm or audio case's holds the cross-KV computed
    at one rank."""
    ext = extras(data, name)
    if not ext:
        return init_cache(cfg, S, batch)
    if cfg.is_encdec:
        mem = lm_mod._encode(params, ext, cfg, local_comm(), tp_plan(cfg, 1),
                             remat=False)
    else:
        mem = ext["image_embeds"]
    ck, cv = precompute_cross_kv(params, mem, cfg)
    c = init_cache(cfg, S, batch, n_memory=mem.shape[0])
    return DecodeCache(k=c.k, v=c.v, ssm_state=c.ssm_state,
                       conv_tail=c.conv_tail, cross_k=ck, cross_v=cv,
                       length=c.length)


def run_decode(cases, data, out):
    for name, fields in cases.items():
        cfg, m, params, pspecs = case_setup(name, fields, data)
        tokens = jnp.asarray(data[name + "/tokens"], jnp.int32)
        S, batch = tokens.shape
        comm = Comm(CommConfig(mode=CommMode.LCI_DEDICATED),
                    model_axis="model", data_axis="data")
        for tp2d in (False, True):
            cspecs = cache_pspecs(cfg, batch=batch, tp2d=tp2d)
            tok_spec = Ps("data") if (batch > 1 and not tp2d) else Ps()
            serve = make_serve_step(cfg, comm, joint_kv=batch == 1,
                                    tp2d=tp2d)
            fn = jax.jit(shard_map(
                serve, mesh=MESH, in_specs=(pspecs, cspecs, tok_spec),
                out_specs=(tok_spec, cspecs), check_vma=False))
            cache = fresh_cache(cfg, params, data, name, S, batch)
            preds = []
            for i in range(S):
                nxt, cache = fn(params, cache, tokens[i])
                preds.append(np.asarray(nxt))
            out[f"{name}/{'tp2d' if tp2d else 'classic'}"] = np.stack(preds)
        serve_l = jax.jit(make_serve_step(cfg))
        cache = fresh_cache(cfg, params, data, name, S, batch)
        preds = []
        for i in range(S):
            nxt, cache = serve_l(params, cache, tokens[i])
            preds.append(np.asarray(nxt))
        out[f"{name}/oracle"] = np.stack(preds)


def comm_methods(comm, x, w, wk):
    """Every Comm method on one rank: {name: (1, ...) array}."""
    r = {
        "tp": jnp.full((1,), comm.tp, F), "dp": jnp.full((1,), comm.dp, F),
        "model_index": comm.model_index()[None].astype(F),
        "data_index": comm.data_index()[None].astype(F),
        "ag_matmul": comm.ag_matmul(x, w),
        "matmul_rs": comm.matmul_rs(x, wk),
        "matmul_ar": comm.matmul_ar(x, wk),
        "ag_seq": comm.ag_seq(x), "rs_seq": comm.rs_seq(x),
        "psum_model": comm.psum_model(x),
        "psum_model_ge": comm.psum_model_ge(x),
        "pmax_model": comm.pmax_model(x),
        "a2a": comm.a2a(x.reshape(4, -1, x.shape[-1]), split_axis=0,
                        concat_axis=1),
        "weight": comm.weight(wk, fsdp_axis=1),
        "psum_data": comm.psum_data(x), "ag_data": comm.ag_data(x, axis=1),
        "pmean_data": comm.pmean_data(x), "psum_all": comm.psum_all(x),
        "pmean_all": comm.pmean_all(x),
        "barrier": comm.barrier()[None].astype(F),
    }
    return {k: v[None] if v.ndim and k not in
            ("tp", "dp", "model_index", "data_index", "barrier") else v
            for k, v in r.items()}


def run_comm(cases, data, out):
    x, w, wk = (jnp.asarray(data[k]) for k in ("comm/x", "comm/w",
                                                 "comm/wk"))
    for mode in CommMode:
        comm = Comm(CommConfig(mode=mode), model_axis="model",
                    data_axis="data")
        names = []

        def fn(x, w, wk):
            res = comm_methods(comm, x, w, wk)
            names[:] = list(res)
            return tuple(res.values())
        f = shard_map(fn, mesh=MESH,
                      in_specs=(Ps(("data", "model")), Ps(), Ps()),
                      out_specs=Ps(("data", "model")), check_vma=False)
        got = compiled(f, x, w, wk)(x, w, wk)
        for n, g in zip(names, got):
            out[f"{mode.value}/{n}"] = np.asarray(g)
    # attribute introspection: no mesh needed
    for mode in CommMode:
        for ep in (None, EndpointSpec(n_devices=3, progress="dedicated"),
                   EndpointSpec(n_devices=2, progress="shared")):
            c = Comm(CommConfig(mode=mode, n_channels=5), endpoint=ep)
            key = f"attrs/{mode.value}/{None if ep is None else ep.progress}"
            out[key] = np.frombuffer(json.dumps(
                {"attrs": {k: str(v) for k, v in c.attrs.items()},
                 "get": {n: str(c.get_attr(n)) for n in
                         ("mode", "n_channels", "tp", "dp", "wire_bf16",
                          "inject_max_bytes")},
                 "mode": c.cfg.mode.value,
                 "channels": c.cfg.resolved_channels()},
                sort_keys=True).encode(), np.uint8)


def main():
    data = dict(np.load(IN))
    cases = json.load(open(CASES))
    for c in cases.values():
        if "global_layers" in c:
            c["global_layers"] = tuple(c["global_layers"])
    out = {}
    {"forward": run_forward, "decode": run_decode,
     "comm": run_comm}[KIND](cases, data, out)
    np.savez(OUT, **out)
    print("HELPER-OK")


main()
