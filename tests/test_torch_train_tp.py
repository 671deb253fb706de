"""Training at tp > 1: the port's loss and gradients on a (data 2, model 4)
mesh of rank threads held against the reference's local oracle.

The reference's own params (``init(PRNGKey(0))``) are carried across as
numpy, the batches drawn with numpy; the reference runs its plain local
loss (``m.loss(params, batch, local_comm())``) and ``jax.grad`` of it in
this process, the port 8 rank threads of ``LocalCluster(8,
device="cpu")`` through ``spmd_map`` (every param cut by its spec's
``pspec()``: tp over ``model``, FSDP over ``data``), its gradient taken
on each rank thread by the tape (``repro_torch.distributed.
spmd_autograd``, remat on) and then ``grad_sync``'d:

* every Comm method's backward (the transpose of the reference's AD) on
  a (1, 4) or (4, 1) mesh against autograd of its single-rank plain
  oracle, through the tape and through the ``autograd.Function``;
* ``tests/helpers/dist_equivalence.py``'s eight configs, and its whisper
  config with the heads replicated (Plan B), in BSP and LCI_DEDICATED:
  the loss within 1e-4 of the local oracle's, every
  synced gradient leaf within 2e-4 of its largest element, the global
  norm within 1e-4 relative.  Two cases are held at measured distances
  below the helper's own limits (3e-3 on the loss, 3e-2 on a gradient):
  moe, whose ``aux_lb`` at tp > 1 is the mean over the model ranks of
  each rank's load-balance term over its own tokens (the reference's
  definition: ``test_torch_tp.py`` holds it to the reference's under
  ``shard_map`` at 1e-5), 4.7e-4 from the local loss and 4.2e-3 on the
  router's gradient; and whisper (either plan), whose cross-attention K
  gradient sits up to 3.2e-4 from the oracle's (float32 rounding: the
  reference's encoder gradients sit up to 7.6e-4 from float64,
  ``test_torch_crossattn.py``).
  The vlm case's gates are drawn nonzero (at init they are zero, and the
  cross layers would add nothing).

The thread guard, the planted faults and a reference fault the port does
not copy are ``test_torch_train_tp_guard.py``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.comm import local_comm as r_local_comm
from repro.models.common import ModelConfig as RConfig
from repro.models.registry import build_model as r_build_model

from repro_torch.core.modes import CommConfig, CommMode
from repro_torch.core.tree import leaves_with_paths
from repro_torch.distributed import Mesh, P, spmd_map
from repro_torch.distributed.spmd_autograd import Tape
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model, params_from_numpy
from repro_torch.optim import grad_sync
from repro_torch.optim.grad_sync import global_norm
from repro_torch.train import loss_and_grads
from test_torch_models import reference_compiled
from test_torch_tp import EXTRAS, FORWARD, pspec_tree

MODES = (CommMode.BSP, CommMode.LCI_DEDICATED)
S, B = 32, 4
#: dist_equivalence.py's configs, and its whisper config with the heads
#: replicated over the model axis (4 heads do not shard at tp_target 8:
#: Plan B, where each rank's encoder queries are its own frames)
CONFIGS = {**FORWARD, "whisper-planB": {**FORWARD["whisper"],
                                        "tp_target": 8}}
#: (loss, gradient) limits: 1e-4 and 2e-4 of a leaf's largest element,
#: but where measured and stated above
LIMITS = {"moe": (1e-3, 1e-2), "whisper": (1e-4, 5e-4),
          "whisper-planB": (1e-4, 5e-4)}


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def mesh():
    with Mesh((2, 4), ("data", "model"), device="cpu") as m:
        yield m


# ---------------------------------------------------------------------------
# each Comm method's backward against its single-rank plain oracle
# ---------------------------------------------------------------------------

def _rng_t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _a2a_full(xs, split, concat):
    """The tiled all-to-all of every rank's ``xs[r]`` (the oracle)."""
    p = len(xs)
    return [torch.cat([torch.chunk(xs[s], p, dim=split)[r]
                       for s in range(p)], dim=concat) for r in range(p)]


def _method_cases():
    """name -> (axis the method runs over, fn(comm, *local) -> output,
    in_specs, out_spec, full inputs, full cotangent, oracle(*full) ->
    full output; each rank's cotangent is its slice of the cotangent by
    the output's spec)."""
    rng = np.random.default_rng(11)
    s, b, k, n, p = 8, 2, 6, 12, 4
    x, w = _rng_t(rng, s, b, k), _rng_t(rng, k, n)
    xk, wk = _rng_t(rng, s, b, n), _rng_t(rng, n, k)
    stack = _rng_t(rng, p * s, b, k)        # a different (s, b, k) a rank
    disp = _rng_t(rng, p * 8, 4, 6)         # (E, cap, d) a rank
    return {
        "ag_matmul": ("model", lambda c, x, w: c.ag_matmul(x, w),
                      (P("model"), P(None, "model")), P(None, None, "model"),
                      (x, w), _rng_t(rng, s, b, n), lambda x, w: x @ w),
        "matmul_rs": ("model", lambda c, x, w: c.matmul_rs(x, w),
                      (P(None, None, "model"), P("model")), P("model"),
                      (xk, wk), _rng_t(rng, s, b, k), lambda x, w: x @ w),
        "matmul_ar": ("model", lambda c, x, w: c.matmul_ar(x, w)[None],
                      (P(None, None, "model"), P("model")), P("model"),
                      (xk, wk), _rng_t(rng, p, s, b, k),
                      lambda x, w: (x @ w)[None].expand(p, s, b, k)),
        "ag_seq": ("model", lambda c, x: c.ag_seq(x)[None], (P("model"),),
                   P("model"), (x,), _rng_t(rng, p, s, b, k),
                   lambda x: x[None].expand(p, s, b, k)),
        "rs_seq": ("model", lambda c, x: c.rs_seq(x), (P("model"),),
                   P("model"), (stack,), _rng_t(rng, s, b, k),
                   lambda x: sum(torch.chunk(x, p, 0))),
        "psum_model": ("model", lambda c, x: c.psum_model(x)[None],
                       (P("model"),), P("model"), (stack,),
                       _rng_t(rng, p, s, b, k),
                       lambda x: sum(torch.chunk(x, p, 0))[None].expand(
                           p, s, b, k)),
        # a replicated consumer: every rank's cotangent is the whole one
        "psum_model_ge": ("model", lambda c, x: c.psum_model_ge(x),
                          (P("model"),), P(), (stack,), _rng_t(rng, s, b, k),
                          lambda x: sum(torch.chunk(x, p, 0))),
        "a2a": ("model", lambda c, x: c.a2a(x, split_axis=0, concat_axis=1),
                (P("model"),), P("model"), (disp,),
                _rng_t(rng, 8, 4 * p, 6),
                lambda x: torch.cat(_a2a_full(torch.chunk(x, p, 0), 0, 1))),
        "weight": ("data", lambda c, w: c.weight(w, fsdp_axis=1)[None],
                   (P(None, "data"),), P("data"), (w,),
                   _rng_t(rng, p, k, n), lambda w: w[None].expand(p, k, n)),
    }


METHOD_CASES = _method_cases()


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
@pytest.mark.parametrize("name", sorted(METHOD_CASES))
def test_comm_backward_matches_plain_oracle(name, mode):
    """A Comm method's input gradients on 4 rank threads, through the
    tape (on the rank thread) and through its ``autograd.Function``,
    against autograd of the plain single-rank oracle on the whole
    tensors (1e-5 of the largest gradient); the forward at 1e-5."""
    axis, fn, in_specs, out_spec, full, ct, oracle = METHOD_CASES[name]
    shape = (1, 4) if axis == "model" else (4, 1)

    def rank(comm, ct_local, *xs, tape):
        xs = [x.clone().requires_grad_() for x in xs]
        if tape:
            t = Tape()
            with t.recording():
                y = fn(comm, *xs)
            t.backward([y], [ct_local])
            grads = [x.grad for x in xs]
        else:
            y = fn(comm, *xs)
            grads = torch.autograd.grad(y, xs, ct_local)
        return (y.detach(),) + tuple(grads)

    xs = [x.clone().requires_grad_() for x in full]
    want_y = oracle(*xs)
    want = torch.autograd.grad(want_y, xs, ct)
    with Mesh(shape, ("data", "model"), device="cpu") as mesh:
        for tape in (True, False):
            got = spmd_map(lambda c, t, *a: rank(c, t, *a, tape=tape), mesh,
                           (out_spec,) + in_specs, (out_spec,) + in_specs,
                           config=CommConfig(mode=mode))(ct, *full)
            np.testing.assert_allclose(got[0].numpy(),
                                       want_y.detach().numpy(),
                                       atol=1e-5, rtol=1e-5)
            for g, w in zip(got[1:], want):
                scale = float(w.abs().max())
                assert float((g - w).abs().max()) <= 1e-5 * scale, \
                    (name, tape)


# ---------------------------------------------------------------------------
# dist_equivalence.py's configs: loss and synced gradients
# ---------------------------------------------------------------------------

def _extras(name):
    fields = CONFIGS[name]
    if fields["family"] not in EXTRAS:
        return {}, {}
    key, rows, spec = EXTRAS[fields["family"]]
    arr = np.random.default_rng(5).standard_normal(
        (rows, B, fields["d_model"])).astype(np.float32)
    return {key: arr}, {key: spec}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port config, carried params, numpy batch, batch specs, the
    reference's local loss, its gradients by leaf path)."""
    fields = CONFIGS[name]
    rcfg = RConfig(name=name, dtype=jnp.float32, **fields)
    model = r_build_model(rcfg)
    host = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(1)
    if "cross_layers" in host:
        # the gates are zero at init (the cross layers would add nothing)
        for k in ("gate_attn", "gate_mlp"):
            n = host["cross_layers"][k].shape[0]
            host["cross_layers"][k] = (rng.uniform(0.3, 0.9, n) * rng.choice(
                [-1, 1], n)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    tok = rng.integers(0, fields["vocab"], size=(S, B)).astype(np.int32)
    lab = rng.integers(0, fields["vocab"], size=(S, B)).astype(np.int32)
    ext, ext_spec = _extras(name)
    batch = {"tokens": tok, "labels": lab, **ext}
    bspec = {"tokens": P("model", "data"), "labels": P("model", "data"),
             **ext_spec}

    def f(p, bt):
        return jax.value_and_grad(lambda q: model.loss(
            q, bt, r_local_comm())[0])(p)
    args = (params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = reference_compiled(f, *args)(*args)
    want = dict(leaves_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         grads)))
    pcfg = ModelConfig(name=name, dtype=torch.float32, **fields)
    return pcfg, host, batch, bspec, float(loss), want


def _port_grads(name, mode, mesh):
    """The port's pmean'd loss, synced gradients and global norm on the
    mesh (every rank's gradients are kept: the ranks' copies of a
    replicated leaf must agree)."""
    pcfg, host, batch, bspec, _, _ = _case(name)
    model = build_model(pcfg, device="cpu")
    _, specs = model.init(0)

    def rank(comm, params, b):
        loss, _, grads = loss_and_grads(model, params, b, comm)
        synced = grad_sync(grads, specs, comm)
        return (comm.pmean_data(loss), synced,
                global_norm(synced, specs, comm))

    return spmd_map(rank, mesh, (pspec_tree(specs), bspec),
                    (P(), pspec_tree(specs), P()),
                    config=CommConfig(mode=mode))(
        params_from_numpy(pcfg, host, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})


def _grad_distance(name, got) -> float:
    """The largest distance of a synced leaf from the oracle's, as a share
    of the oracle leaf's largest element."""
    want = _case(name)[-1]
    worst = 0.0
    for path, g in leaves_with_paths(got):
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        worst = max(worst, float(np.abs(g.numpy() - w).max())
                    / max(float(np.abs(w).max()), 1e-12))
    return worst


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_grads_match_local_oracle(mesh, name, mode):
    """The loss, every ``grad_sync``'d gradient leaf and the global norm
    at (2, 4) against the reference's local oracle (limits in the module
    docstring)."""
    loss, grads, gnorm = _port_grads(name, mode, mesh)
    want_loss, want = _case(name)[4], _case(name)[5]
    loss_tol, grad_tol = LIMITS.get(name, (1e-4, 2e-4))
    assert abs(float(loss) - want_loss) <= loss_tol, (float(loss), want_loss)
    assert _grad_distance(name, grads) <= grad_tol
    want_norm = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                            for w in want.values()))
    assert abs(float(gnorm) - want_norm) <= max(grad_tol, 1e-4) * want_norm
