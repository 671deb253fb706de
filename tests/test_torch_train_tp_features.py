"""Training at tp > 1 on a (data 2, model 4) mesh of rank threads: the
reference's compressed-training and elastic-reshard checks, and the
sharded state between steps.

* ``tests/helpers/compressed_training.py`` on the port: 30 steps of int8
  + error-feedback gradient sync on (2, 4) learn (the last 5 losses'
  mean at least 0.3 under the first) and stay within 0.4 of the
  uncompressed run; the uncompressed run's first 5 losses agree with the
  reference's jitted local steps on the same carried params at 1e-4
  relative (later ones drift further apart: at lr 3e-3 without clipping
  Adam amplifies float32 differences in tiny gradients step by step,
  1.5e-2 relative by step 20);
* ``tests/helpers/elastic_reshard.py`` on the port: 3 launcher steps
  (``mesh_step``) on (2, 4), a checkpoint, its restore resharded onto
  (4, 2) and 3 more steps there, within 2e-3 of the unresharded
  continuation on (2, 4); the checkpoint's files byte-identical to the
  reference store's at the same state; every rank's params, master, mu
  and nu exactly its ``ParamSpec`` shard (no rank holds more).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_sync as r_save_sync
from repro.data import SyntheticPipeline as RPipeline
from repro.distributed.comm import local_comm as r_local_comm
from repro.models.common import ModelConfig as RConfig
from repro.models.registry import build_model as r_build_model
from repro.optim import AdamWConfig as RAdamW
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import grad_sync as r_grad_sync
from repro.optim.adamw import OptState as ROptState
from repro.train.step import TrainState as RTrainState

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.modes import CommConfig, CommMode
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.data import SyntheticPipeline
from repro_torch.distributed import PER_RANK, Mesh, P, reshard_state, \
    spmd_map
from repro_torch.distributed.compression import (grad_sync_compressed,
                                                 init_error_state)
from repro_torch.launch.mesh import batch_pspecs, state_pspecs
from repro_torch.launch.train import mesh_step, shard_state
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model, params_from_numpy
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               grad_sync)
from repro_torch.train import (TrainState, loss_and_grads, state_from_tree,
                               state_tree)
from test_torch_train_tp import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: the helpers' config (vocab 64 in compressed_training.py, 256 in
#: elastic_reshard.py)
FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, tp_target=4)


def _carried(vocab):
    """The reference's model and params (its own draw), the port's config,
    specs and the params as numpy."""
    rcfg = RConfig(dtype=jnp.float32, vocab=vocab, **FIELDS)
    rmodel = r_build_model(rcfg)
    params, rspecs = rmodel.init(jax.random.PRNGKey(0))
    pcfg = ModelConfig(dtype=torch.float32, vocab=vocab, **FIELDS)
    _, specs = build_model(pcfg, device="cpu").init(0)
    return rmodel, params, rspecs, pcfg, specs, \
        jax.tree_util.tree_map(np.asarray, params)


def test_compressed_training_on_2x4():
    rmodel, rparams, rspecs, pcfg, specs, host = _carried(64)
    model = build_model(pcfg, device="cpu")
    opt = AdamWConfig(lr=3e-3, weight_decay=0.0, max_grad_norm=0.0)
    pipe = SyntheticPipeline(vocab=64, seq_len=32, global_batch=8)
    pspecs = tree_map(lambda sp: sp.pspec(), specs)

    def run(compressed, mesh, steps=30):
        params = params_from_numpy(pcfg, host, device="cpu")
        st = reshard_state((params, adamw_init(params, opt),
                            init_error_state(params)),
                           (pspecs, state_pspecs(specs).opt, pspecs), mesh)

        def rank_step(comm, state, batch):
            p, o, e = state
            loss, _, grads = loss_and_grads(model, p, batch, comm)
            if compressed:
                grads, e = grad_sync_compressed(grads, specs, e, comm)
            else:
                grads = grad_sync(grads, specs, comm)
            p, o = adamw_update(grads, o, p, opt)
            return (p, o, e), comm.pmean_all(loss)

        step = spmd_map(rank_step, mesh,
                        (PER_RANK, batch_pspecs(None, "train", mesh,
                                                batch=8)),
                        (PER_RANK, P()),
                        config=CommConfig(mode=CommMode.LCI_DEDICATED))
        losses = []
        for i in range(steps):
            st, loss = step(st, pipe.get_batch(i, device="cpu"))
            losses.append(float(loss))
        return losses

    with Mesh((2, 4), ("data", "model"), device="cpu") as mesh:
        base = run(False, mesh)
        comp = run(True, mesh)
    assert np.mean(comp[-5:]) < comp[0] - 0.3
    assert abs(np.mean(comp[-5:]) - np.mean(base[-5:])) < 0.4

    # the reference's local steps on the same params and batches
    ropt = RAdamW(lr=3e-3, weight_decay=0.0, max_grad_norm=0.0)

    def rstep(p, o, batch):
        (loss, _), g = jax.value_and_grad(lambda q: rmodel.loss(
            q, batch, r_local_comm()), has_aux=True)(p)
        p, o = r_adamw_update(r_grad_sync(g, rspecs, r_local_comm()), o, p,
                              ropt)
        return p, o, loss
    rstep = jax.jit(rstep)
    rpipe = RPipeline(vocab=64, seq_len=32, global_batch=8)
    p, o, want = rparams, r_adamw_init(rparams, ropt), []
    for i in range(30):
        p, o, loss = rstep(p, o, {k: jnp.asarray(v) for k, v in
                                  rpipe.get_batch(i).items()})
        want.append(float(loss))
    np.testing.assert_allclose(base[:5], want[:5], rtol=1e-4)


def _shard_numel(t_full, spec, mesh) -> int:
    n = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= mesh.shape[mesh.names.index(a)]
    return t_full.numel() // n


def _ref_tree(state: TrainState):
    """The port's whole state as the reference's ``TrainState`` of numpy
    arrays (the pytree its checkpoint store flattens)."""
    params, (step, mu, nu, master) = tree_map(
        lambda t: t.numpy(), state_tree(state))
    return RTrainState(params, ROptState(step, mu, nu, master))


def test_elastic_reshard_2x4_to_4x2(tmp_path):
    *_, pcfg, specs, host = _carried(256)
    model = build_model(pcfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    pipe = SyntheticPipeline(vocab=256, seq_len=32, global_batch=8)
    config = CommConfig(mode=CommMode.LCI_DEDICATED)
    params = params_from_numpy(pcfg, host, device="cpu")
    with Mesh((2, 4), ("data", "model"), device="cpu") as mesh_a, \
            Mesh((4, 2), ("data", "model"), device="cpu") as mesh_b:
        step_a = mesh_step(model, specs, opt, mesh_a, config, batch=8)
        step_b = mesh_step(model, specs, opt, mesh_b, config, batch=8)
        state = shard_state(TrainState(params, adamw_init(params, opt)),
                            specs, mesh_a)
        # no rank holds more than its shard of params, master, mu, nu
        full = dict(leaves_with_paths(params))
        spec_of = {path: sp.pspec() for path, sp in leaves_with_paths(specs)}
        for rank in state.ranks:
            for tree in (rank.params, rank.opt.mu, rank.opt.nu,
                         rank.opt.master):
                for path, t in leaves_with_paths(tree):
                    assert t.numel() == _shard_numel(full[path],
                                                     spec_of[path], mesh_a)
        for i in range(3):
            state, m = step_a(state, pipe.get_batch(i, device="cpu"))
        store = CheckpointStore(str(tmp_path / "port"))
        store.save(2, state_tree(state), meta={"next_step": 3},
                   blocking=True)
        # the same state through the reference's store: the same bytes
        r_save_sync(str(tmp_path / "ref"), 2, _ref_tree(state.gather()),
                    meta={"next_step": 3})
        names = sorted(os.listdir(tmp_path / "ref" / "step_00000002"))
        assert names == sorted(os.listdir(tmp_path / "port" /
                                          "step_00000002"))
        for n in names:
            assert (tmp_path / "port" / "step_00000002" / n).read_bytes() \
                == (tmp_path / "ref" / "step_00000002" / n).read_bytes(), n

        def continued(like, step_fn):
            """The checkpoint restored and cut as ``like`` is, then steps
            3-5."""
            tree, manifest = store.restore(state_tree(like), device="cpu")
            st = like.resharded(state_from_tree(tree))
            for i in range(manifest["meta"]["next_step"], 6):
                st, m = step_fn(st, pipe.get_batch(i, device="cpu"))
            return float(m["loss"])

        loss_b = continued(shard_state(state.gather(), specs, mesh_b),
                           step_b)
        loss_a = continued(state, step_a)
    assert np.isfinite(loss_b)
    assert abs(loss_a - loss_b) < 2e-3


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_rendezvous_landing_zone_released(pkg):
    """A zero-copy receive's landing zone (the CTS state that holds the
    receive buffer) is dropped once the payload lands in the port, so a
    training step's collective buffers do not outlive it (on the card
    every rendezvous piece of every step stayed alive: phase 21b's peak
    grew by ~11 GB a step); the reference keeps every zone in its list
    (ROADMAP §C)."""
    import weakref
    import repro.core as ref
    import repro_torch.core as port
    m = port if pkg == "port" else ref
    kw = {"device": "cpu"} if m is port else {}
    size = 3 * 1024 * 1024
    with m.LocalCluster(2, attrs={"eager_max_bytes": 1024}, **kw) as cl:
        src = np.random.default_rng(3).integers(0, 256, size, np.uint8)
        dst = np.zeros(size, np.uint8)
        held = weakref.ref(dst)
        sync = cl[1].alloc_sync()
        m.post_recv(cl[1], 0, dst, size, tag=5, local_comp=sync)
        m.post_send(cl[0], 1, src, size, tag=5)
        cl.quiesce()
        assert sync.test()[0] and np.array_equal(dst, src)
        del dst
        zones = cl[1]._rendezvous_landing
        assert len(zones) == 1
        if m is port:
            assert zones[0] is None and held() is None
        else:
            assert zones[0][0] is held() is not None
