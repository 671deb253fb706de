#!/usr/bin/env python3
"""On the CPU: mamba2-370m's gradients at full width and a chosen depth,
the port against the JAX package, both float32, on one seeded batch of
2 x 16 tokens with the reference's params carried across.

The reference's chunked scan takes the exponent of every masked pair and
its gradients are NaN at this width (ROADMAP §C); at chunk 1 every
exponent is a decay, so it runs there (the same function).  It runs
again with every param multiplied by 1 + e z (z standard normal,
seeded) for each e of ``--perturb``: a change at float32's rounding
(e near 6e-8, half an ulp), as a yardstick of how far the model at that
depth amplifies it.  The port runs at the config's chunk (256).  Prints
one JSON line: the loss of each run, each layer's gradient norm (the
reference's, summed over the layer's leaves), and for each leaf the
largest error as a share of its largest element, port against
reference and each perturbed reference against reference, overall and
by layer for ``w_out``.  Needs about 10 GB of host memory at 48 layers
(~1 min).

    PYTHONPATH=src:tests python3 tools/mamba2_depth_grads.py \
        [--layers 48] [--perturb 1e-7,1e-6]
"""
import argparse
import dataclasses
import json
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--perturb", default="1e-7,1e-6")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as r_get_config
    from repro.models.registry import build_model as r_build_model
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.distributed import local_comm
    from repro_torch.models.registry import build_model
    from repro_torch.train import loss_and_grads
    from test_torch_models import carried_model, reference_compiled
    from test_torch_train import _batch

    base = dataclasses.replace(r_get_config("mamba2-370m"),
                               n_layers=args.layers)
    chunk = base.ssm_chunk

    def reference(rcfg, params, tok, lab):
        model = r_build_model(rcfg)

        def f(p, t, l):
            return jax.value_and_grad(lambda p: model.loss(
                p, {"tokens": t, "labels": l}, remat=False),
                has_aux=True)(p)
        a = (params, jnp.asarray(tok), jnp.asarray(lab))
        (loss, _), grads = reference_compiled(f, *a)(*a)
        return float(loss), dict(leaves_with_paths(
            jax.tree_util.tree_map(np.asarray, grads)))

    rcfg, params, pcfg, pparams = carried_model(
        dataclasses.replace(base, ssm_chunk=1), "float32")
    tok, lab = _batch(rcfg.vocab)
    loss1, ref1 = reference(rcfg, params, tok, lab)
    losses, perturbed = {"reference_chunk1": loss1}, {}
    for e in args.perturb.split(","):
        rng = np.random.default_rng(1)
        moved = jax.tree_util.tree_map(lambda a: jnp.asarray(
            np.asarray(a) * (1 + float(e) * rng.standard_normal(a.shape))
            .astype(np.float32)), params)
        losses[f"perturbed_{e}"], perturbed[e] = reference(rcfg, moved,
                                                           tok, lab)
        del moved
    del params
    torch.set_num_threads(4)
    loss_p, _, grads = loss_and_grads(
        build_model(dataclasses.replace(pcfg, ssm_chunk=chunk),
                    device="cpu"), pparams,
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)},
        local_comm())
    port = {n: g.numpy() for n, g in leaves_with_paths(grads)}

    def share(got, want):
        return float(np.abs(got - want).max() / max(np.abs(want).max(),
                                                    1e-30))

    def by_layer(got, want):
        g = got.reshape(got.shape[0], -1)
        w = want.reshape(want.shape[0], -1)
        return (np.abs(g - w).max(1) / np.maximum(np.abs(w).max(1), 1e-30)
                ).tolist()
    layer_names = [n for n in ref1 if n.startswith("layers/")]
    norms = np.sqrt(sum((ref1[n].reshape(args.layers, -1) ** 2).sum(1)
                        for n in layer_names))
    losses[f"port_chunk{chunk}"] = float(loss_p)
    runs = {"port": port, **{f"perturbed_{e}": g
                             for e, g in perturbed.items()}}
    w_out = "layers/ssm_w_out"
    print(json.dumps({
        "arch": "mamba2-370m", "layers": args.layers, "tokens": [16, 2],
        "loss": losses, "grad_norm_by_layer": norms.tolist(),
        "vs_reference": {k: {n: share(g[n], ref1[n]) for n in ref1}
                         for k, g in runs.items()},
        "w_out_by_layer": {k: by_layer(g[w_out], ref1[w_out])
                           for k, g in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
