"""Helper: the reference's data-parallel training under ``shard_map`` on a
(data 2, model 1) mesh of 2 fake devices, on params and batches drawn by
the port's test.

    python torch_train_ref.py IN.npz CFG.json OUT.npz

``CFG.json`` holds the ``ModelConfig`` fields (float32) and the AdamW
learning rate; ``IN.npz`` the params (``params/<path>``) and the batches
(``tokens/<i>``, ``labels/<i>``, (s, b) each).  ``OUT.npz`` gets the
synced gradient of batch 0 (``grads/<path>``: ``value_and_grad`` of the
loss, then ``grad_sync``), the params after one ``make_train_step`` a
batch (``params/<path>``) and each step's metrics (``loss``,
``grad_norm``).  The caller sets ``XLA_FLAGS`` for 2 devices and
``PYTHONPATH``.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as Ps

from repro.compat import make_mesh, shard_map
from repro.core.modes import CommConfig, CommMode
from repro.distributed.comm import Comm
from repro.models.common import ModelConfig
from repro.models.registry import build_model
from repro.optim import AdamWConfig, adamw_init, grad_sync
from repro.optim.adamw import OptState
from repro.train import make_train_step
from repro.train.step import TrainState

IN, CFG, OUT = sys.argv[1:4]
MESH = make_mesh((2, 1), ("data", "model"))
OPTS = {"xla_allow_excess_precision": False}


def unflatten(data, prefix):
    tree = {}
    for k, v in data.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)


def main():
    with open(CFG) as f:
        spec = json.load(f)
    lr = spec.pop("lr")
    cfg = ModelConfig(dtype=jnp.float32, **spec)
    data = dict(np.load(IN))
    params = unflatten(data, "params")
    n = len([k for k in data if k.startswith("tokens/")])
    batches = [{"tokens": jnp.asarray(data[f"tokens/{i}"]),
                "labels": jnp.asarray(data[f"labels/{i}"])}
               for i in range(n)]
    model = build_model(cfg)
    _, specs = model.init(jax.random.PRNGKey(0))
    opt = AdamWConfig(lr=lr)
    comm = Comm(CommConfig(mode=CommMode.LCI_DEDICATED), model_axis="model",
                data_axis="data", fsdp=cfg.fsdp_params)
    pspecs = jax.tree_util.tree_map(lambda sp: sp.pspec(), specs)
    bspec = {"tokens": Ps("model", "data"), "labels": Ps("model", "data")}

    def synced(p, batch):
        grads = jax.grad(lambda q: model.loss(q, batch, comm)[0])(p)
        return grad_sync(grads, specs, comm)

    f = shard_map(synced, mesh=MESH, in_specs=(pspecs, bspec),
                  out_specs=pspecs, check_vma=False)
    out = {}
    flatten(compiled(f, params, batches[0])(params, batches[0]), "grads",
            out)

    sspecs = TrainState(pspecs, OptState(Ps(), pspecs, pspecs, pspecs))
    mkeys = ("loss", "ce", "ntok", "aux_lb", "aux_z", "dropped_frac",
             "grad_norm")
    step = shard_map(make_train_step(model, specs, opt, comm), mesh=MESH,
                     in_specs=(sspecs, bspec),
                     out_specs=(sspecs, {k: Ps() for k in mkeys}),
                     check_vma=False)
    state = TrainState(params, adamw_init(params, opt))
    step = compiled(step, state, batches[0])
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flatten(state.params, "params", out)
    out["loss"] = np.asarray(losses)
    out["grad_norm"] = np.asarray(norms)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
    print("HELPER-OK")
