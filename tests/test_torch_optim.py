"""The port's optimizer held against the JAX package on the CPU.

The same numpy gradients go through both packages' AdamW (float32 and
bf16 params, master weights on and off, the decay mask by path) over
twelve steps of a cosine schedule, the schedules themselves, and
``global_norm`` / ``clip_by_global_norm``: all within 1e-7 relative of
the reference run op by op (eagerly, as its code reads; under ``jax.jit``
XLA may rewrite a division into a product by a reciprocal, one ulp
apart).
"""
import jax
import jax.numpy as jnp
import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke as r_get_smoke
from repro.distributed.comm import local_comm as r_local_comm
from repro.models.registry import build_model as r_build_model
from repro.optim import adamw as r_adamw
from repro.optim import schedules as r_sched
from repro.models.common import ParamSpec as RSpec

from repro_torch.distributed import local_comm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm, grad_sync, linear_warmup)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.optim.adamw import _decay_mask
from repro_torch.models.common import ParamSpec

#: the module (``repro.optim.grad_sync`` names the function there)
r_sync = importlib.import_module("repro.optim.grad_sync")

SHAPES = {"emb": (7, 5), "final_norm": (5,),
          "layers": {"norm1": (2, 5), "wq": (2, 5, 6), "ssm_a_log": (2, 3)}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _pairs(jtree, ptree):
    return zip(jax.tree_util.tree_leaves(jtree),
               [t for _, t in leaves_with_paths(ptree)])


def _rel_close(want, got, rtol=1e-7):
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert w.shape == g.shape
    np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype, master):
    """Twelve AdamW steps on the same numpy grads (magnitudes 1e-3..10):
    params, mu, nu and master within 1e-7 relative; the decay mask skips
    the norms and ``a_log`` as the reference's does."""
    rng = np.random.default_rng(0)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" \
        else (lambda a: a)
    host = _tree(SHAPES, lambda s: cast(rng.standard_normal(s).astype(
        np.float32)))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = jax.tree_util.tree_map(_to_torch, host)
    rcfg = r_adamw.AdamWConfig(lr=r_sched.cosine_schedule(1e-2, 3, 10),
                               use_master=master)
    pcfg = AdamWConfig(lr=cosine_schedule(1e-2, 3, 10), use_master=master)
    rst, pst = r_adamw.adamw_init(jp, rcfg), adamw_init(tp, pcfg)
    for _ in range(12):
        g = jax.tree_util.tree_map(lambda a: cast(
            (rng.standard_normal(a.shape) * 10.0 ** rng.integers(-3, 2))
            .astype(np.float32)), host)
        jp, rst = r_adamw.adamw_update(jax.tree_util.tree_map(jnp.asarray,
                                                              g), rst, jp,
                                       rcfg)
        tp, pst = adamw_update(jax.tree_util.tree_map(_to_torch, g), pst,
                               tp, pcfg)
    assert int(pst.step) == int(rst.step) == 12
    assert (pst.master is None) == (not master)
    for want, got in [*_pairs(jp, tp), *_pairs(rst.mu, pst.mu),
                      *_pairs(rst.nu, pst.nu),
                      *(_pairs(rst.master, pst.master) if master else [])]:
        assert got.dtype == (torch.bfloat16 if np.asarray(want).dtype.name
                             == "bfloat16" else torch.float32)
        _rel_close(want, got)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decay_mask_matches_reference(arch):
    """Every param path of every architecture decays in the port iff it
    does in the reference."""
    params = jax.eval_shape(lambda k: r_build_model(r_get_smoke(arch)).init(
        k)[0], jax.random.PRNGKey(0))
    paths = r_adamw._leaf_paths(params)
    assert paths
    assert [_decay_mask(p) for p in paths] == \
        [r_adamw._decay_mask(p) for p in paths]


def test_schedules_match_reference_bitwise():
    for steps in (np.arange(0, 130), np.arange(0, 130, 7)):
        for r_fn, p_fn in (
                (r_sched.linear_warmup(3e-4, 10), linear_warmup(3e-4, 10)),
                (r_sched.cosine_schedule(1e-3, 10, 110),
                 cosine_schedule(1e-3, 10, 110)),
                (r_sched.cosine_schedule(1.0, 0, 50, final_frac=0.0),
                 cosine_schedule(1.0, 0, 50, final_frac=0.0))):
            for s in steps:
                want = np.float32(r_fn(jnp.int32(s)))
                got = p_fn(torch.tensor(int(s), dtype=torch.int32))
                assert got.dtype == torch.float32
                assert float(got) == float(want), (s, float(got), want)


@pytest.mark.parametrize("max_norm", [1e-6, 0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """One rank: the norm and the clipped gradients (bf16 and float32
    leaves, replicated and sharded specs) within 1e-7 relative."""
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((6, 4)).astype(np.float32),
             "b": rng.standard_normal((8,)).astype(ml_dtypes.bfloat16),
             "c": {"d": rng.standard_normal((3, 5)).astype(np.float32)}}
    specs_r = {"a": RSpec(0, 1), "b": RSpec(),
               "c": {"d": RSpec(None, 0)}}
    specs_p = {"a": ParamSpec(0, 1), "b": ParamSpec(),
               "c": {"d": ParamSpec(None, 0)}}
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tg = jax.tree_util.tree_map(_to_torch, grads)
    want, wn = r_sync.clip_by_global_norm(jg, specs_r, r_local_comm(),
                                          max_norm)
    got, gn = clip_by_global_norm(tg, specs_p, local_comm(), max_norm)
    _rel_close(wn, gn)
    _rel_close(r_sync.global_norm(jg, specs_r, r_local_comm()),
               global_norm(tg, specs_p, local_comm()))
    for w, g in _pairs(want, got):
        _rel_close(w, g)
    synced = grad_sync(tg, specs_p, local_comm())       # one rank: as is
    for (_, a), (_, b) in zip(leaves_with_paths(synced),
                              leaves_with_paths(tg)):
        assert torch.equal(a, b)
