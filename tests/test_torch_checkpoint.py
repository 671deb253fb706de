"""The port's checkpoint store (``repro_torch/checkpoint/store.py``) on the
CPU, held against the reference (``repro.checkpoint.store``).

* the store cases of ``tests/test_checkpoint.py`` on tensor trees:
  roundtrip, corruption detected, async signals, unified wait, async
  failure is loud, the commit graph's partial order, atomic commit, gc;
* the mid-commit kill of ``tests/test_chaos.py::TestMidCommitKill``, its
  child inlined (:data:`KILL_CHILD`);
* for one tree of float32 / float64 / int32 / int64 / 0-d / bf16 leaves,
  every file the port writes (each ``.npy``, ``manifest.json``,
  ``LATEST``) byte-identical to the reference's, and each package
  restoring the other's checkpoint (the reference hands a bf16 leaf back
  as ``V2``, so its side compares bits; the port restores bf16);
* ``save_async``'s snapshot survives an in-place write to the source
  right after the call;
* the reference's gemma3-1b SMOKE params (bf16) saved by the reference,
  restored by the port resharded onto a (1, 2) mesh, each rank's leaves
  bitwise its shard, and the port's tp = 2 forward on them equal to the
  reference's forward within ``tests/test_torch_tp.py``'s tolerance
  (float32, 1e-4);
* ``tests/test_checkpoint.py::test_resume_exactness`` on the port's
  ``train_loop`` (a straight run of 10 steps equals 6 steps with
  checkpoints, then a resume to 10), and a cross-package resume: a
  ``TrainState`` checkpoint the reference's loop wrote, continued by the
  port's loop, equals the reference continuing it.

Inputs come from numpy with a seed.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as r_restore
from repro.checkpoint import save_sync as r_save_sync
from repro.configs.gemma3_1b import SMOKE as R_SMOKE
from repro.models.registry import build_model as r_build_model

from repro_torch.checkpoint import (CheckpointStore, latest_step, restore,
                                    restore_resharded, save_async, save_sync)
from repro_torch.checkpoint.store import build_commit_graph
from repro_torch.configs.gemma3_1b import SMOKE
from repro_torch.core.completion import Synchronizer
from repro_torch.core.status import FatalError
from repro_torch.distributed import Mesh, P, shard, spmd_map
from repro_torch.models.registry import build_model
from test_torch_train import one_torch_thread  # noqa: F401  (a fixture)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}


def _bf16_bits(shape, seed):
    """Bits of bf16 values: the top halves of float32 normals."""
    f = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def _pair_trees(seed=0):
    """The same values as a reference (numpy, ml_dtypes bf16) tree and a
    port (CPU tensor) tree."""
    rng = np.random.default_rng(seed)
    np_tree = {
        "w": rng.standard_normal((4, 6)).astype(np.float32),
        "opt": {"mu": rng.standard_normal(7),
                "count": np.asarray(rng.integers(0, 100), np.int64)},
        "ids": rng.integers(-50, 50, (3, 2)).astype(np.int32),
        "pos": [rng.integers(0, 1 << 40, (5,)).astype(np.int64),
                np.zeros((), np.float32)],
        "bias": _bf16_bits((2, 3), seed + 1).view(jnp.bfloat16),
    }

    def port(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return np_tree, jax.tree_util.tree_map(port, np_tree)


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            full = os.path.join(root, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    save_sync(str(tmp_path), 3, t, meta={"next_step": 4})
    assert latest_step(str(tmp_path)) == 3
    got, manifest = restore(str(tmp_path), t, device="cpu")
    assert torch.equal(got["a"], t["a"])
    assert torch.equal(got["b"]["c"], t["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32
    assert manifest["meta"]["next_step"] == 4


def test_corruption_detected(tmp_path):
    t = _tree()
    path = save_sync(str(tmp_path), 1, t)
    victim = os.path.join(path, "a.npy")
    arr = np.load(victim)
    arr[0, 0] += 1
    np.save(victim, arr)
    with pytest.raises(FatalError, match="corrupt"):
        restore(str(tmp_path), t, device="cpu")


def test_async_save_signals_synchronizer(tmp_path):
    t = _tree()
    sync = save_async(str(tmp_path), 2, t)
    for _ in range(500):
        if sync.ready:
            break
        time.sleep(0.01)
    assert sync.ready
    ok, payloads = sync.test()
    assert ok and payloads[0].is_done()
    assert latest_step(str(tmp_path)) == 2


def test_async_save_unified_wait(tmp_path):
    t = _tree()
    sync = save_async(str(tmp_path), 7, t)
    (status,) = sync.wait()
    assert status.is_done()
    assert status.get_buffer().endswith("step_00000007")
    assert latest_step(str(tmp_path)) == 7


def test_async_save_failure_is_loud(tmp_path):
    target = tmp_path / "not-a-dir"
    target.write_text("file where the ckpt dir should go")
    sync = save_async(str(target / "sub"), 3, _tree())
    with pytest.raises(FatalError, match="synchronizer failed"):
        sync.wait()
    with pytest.raises(FatalError):
        _ = sync.ready


def test_commit_graph_partial_order(tmp_path):
    t = _tree()
    sync = Synchronizer(1)
    g = build_commit_graph(str(tmp_path), 5, t, None, sync)
    g.execute()
    g.assert_partial_order()
    names = {n.name: n.nid for n in g._nodes}
    pos = {nid: i for i, nid in enumerate(g.fire_order)}
    writes = [nid for name, nid in names.items() if name.startswith("write:")]
    assert len(writes) == 2                      # leaves a, b_c
    assert all(pos[w] < pos[names["manifest"]] for w in writes)
    assert pos[names["manifest"]] < pos[names["commit"]] \
        < pos[names["signal"]]
    assert sync.ready and latest_step(str(tmp_path)) == 5


def test_commit_graph_matches_the_reference(tmp_path):
    """The same nodes in the same order, and the same attrs."""
    from repro.checkpoint.store import build_commit_graph as r_build
    from repro.core.completion import Synchronizer as RSync
    np_tree, tree = _pair_trees()
    g = build_commit_graph(str(tmp_path / "p"), 1, tree, None,
                           Synchronizer(1))
    rg = r_build(str(tmp_path / "r"), 1, np_tree, None, RSync(1))
    assert [n.name for n in g._nodes] == [n.name for n in rg._nodes]
    assert [n.deps for n in g._nodes] == [n.deps for n in rg._nodes]
    for attr in ("n_nodes", "n_comm_nodes"):
        assert g.get_attr(attr) == rg.get_attr(attr)


def test_atomic_commit_no_partial(tmp_path):
    t = _tree()
    os.makedirs(tmp_path / "step_00000009.tmp")
    save_sync(str(tmp_path), 5, t)
    assert latest_step(str(tmp_path)) == 5
    got, _ = restore(str(tmp_path), t, device="cpu")
    assert torch.equal(got["a"], t["a"])


def test_gc_keeps_last(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2)
    for s in range(5):
        store.save(s, _tree(), blocking=True)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    got, manifest = store.restore(_tree(), device="cpu")
    assert manifest["step"] == 4 and torch.equal(got["a"], _tree()["a"])


def test_restore_names_the_card_by_default(tmp_path):
    """No entry point runs on the CPU unless asked: without a card,
    ``restore`` with no device raises instead of restoring to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    save_sync(str(tmp_path), 0, _tree())
    with pytest.raises(FatalError, match="no CUDA device"):
        restore(str(tmp_path), _tree())


def test_restore_checks_shape_and_dtype(tmp_path):
    save_sync(str(tmp_path), 0, _tree())
    bad = {"a": torch.empty(4, 3, device="meta"), "b": {"c": _tree()["b"]["c"]}}
    with pytest.raises(FatalError, match="shape"):
        restore(str(tmp_path), bad, device="cpu")
    like = {"a": torch.empty(3, 4, device="meta"),
            "b": {"c": torch.empty(5, device="meta")}}
    got, _ = restore(str(tmp_path), like, device="cpu")
    assert got["a"].device.type == "cpu" and got["a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# tests/test_chaos.py::TestMidCommitKill, the child inlined
# ---------------------------------------------------------------------------

#: commits step 0, then starts a step-1 commit whose leaf writes crawl and
#: prints a marker once the first is underway; the parent SIGKILLs it there
KILL_CHILD = (
    "import os, sys, time\n"
    "sys.path.insert(0, os.environ['SRC'])\n"
    "import torch\n"
    "from repro_torch.checkpoint import save_sync\n"
    "from repro_torch.checkpoint import store\n"
    "ckpt = sys.argv[1]\n"
    "tree = {'w': torch.arange(64, dtype=torch.float64),\n"
    "        'step': torch.zeros((), dtype=torch.int64)}\n"
    "save_sync(ckpt, 0, tree, meta={'next_step': 1})\n"
    "real_write = store._write_leaf\n"
    "def slow_write(tmp, name, arr):\n"
    "    print('COMMITTING', flush=True)\n"
    "    time.sleep(5.0)\n"
    "    return real_write(tmp, name, arr)\n"
    "store._write_leaf = slow_write\n"
    "tree['step'] = torch.ones((), dtype=torch.int64)\n"
    "save_sync(ckpt, 1, tree, meta={'next_step': 2})\n"
    "print('COMMITTED-1', flush=True)\n")


def test_kill_during_commit_keeps_prior_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, SRC=SRC)
    proc = subprocess.Popen([sys.executable, "-c", KILL_CHILD, ckpt],
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        marker = proc.stdout.readline()
        assert "COMMITTING" in marker, marker
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    assert proc.returncode == -signal.SIGKILL
    assert latest_step(ckpt) == 0
    like = {"w": torch.zeros(64, dtype=torch.float64),
            "step": torch.zeros((), dtype=torch.int64)}
    got, manifest = restore(ckpt, like, device="cpu")
    assert manifest["step"] == 0
    assert torch.equal(got["w"], torch.arange(64, dtype=torch.float64))
    assert not os.path.exists(os.path.join(ckpt, "step_00000001"))


# ---------------------------------------------------------------------------
# byte compatibility with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_files_byte_identical_to_the_reference(tmp_path, seed):
    np_tree, tree = _pair_trees(seed)
    meta = {"next_step": 4, "world": 2}
    r_save_sync(str(tmp_path / "ref"), 3, np_tree, meta=meta)
    save_sync(str(tmp_path / "port"), 3, tree, meta=meta)
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert "step_00000003/bias.npy" in got and "LATEST" in got
    for name in want:
        assert got[name] == want[name], name
    assert b"'descr': '<V2'" in got["step_00000003/bias.npy"]
    assert b'"dtype": "bfloat16"' in got["step_00000003/manifest.json"]


def test_port_restores_a_reference_checkpoint(tmp_path):
    np_tree, tree = _pair_trees(2)
    r_save_sync(str(tmp_path), 6, np_tree, meta={"next_step": 7})
    got, manifest = restore(str(tmp_path), tree, device="cpu")
    assert manifest["meta"] == {"next_step": 7}
    assert got["bias"].dtype == torch.bfloat16
    for (_, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_reference_restores_a_port_checkpoint(tmp_path):
    np_tree, tree = _pair_trees(3)
    save_sync(str(tmp_path), 2, tree, meta={"next_step": 3})
    got, manifest = r_restore(str(tmp_path), np_tree)
    assert manifest["step"] == 2
    for k in ("w", "ids"):
        np.testing.assert_array_equal(got[k], np_tree[k])
    np.testing.assert_array_equal(got["opt"]["mu"], np_tree["opt"]["mu"])
    assert got["opt"]["count"] == np_tree["opt"]["count"]
    np.testing.assert_array_equal(got["pos"][0], np_tree["pos"][0])
    # the reference hands bf16 back as V2: compare its bits
    assert got["bias"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(got["bias"].view(np.uint16),
                                  np_tree["bias"].view(np.uint16))


def test_async_snapshot_survives_an_in_place_write(tmp_path):
    t = _tree()
    want = {"a": t["a"].clone(), "c": t["b"]["c"].clone()}
    sync = save_async(str(tmp_path), 1, t)
    t["a"].add_(100.0)                   # right after the call returns
    t["b"]["c"].zero_()
    sync.wait()
    got, _ = restore(str(tmp_path), t, device="cpu")
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["b"]["c"], want["c"])


# ---------------------------------------------------------------------------
# the reference's gemma3 SMOKE params, resharded onto a (1, 2) mesh
# ---------------------------------------------------------------------------

def _pspecs(specs):
    if isinstance(specs, dict):
        return {k: _pspecs(v) for k, v in specs.items()}
    return specs.pspec()


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def test_reference_smoke_params_restore_resharded(tmp_path):
    params, _ = r_build_model(R_SMOKE).init(jax.random.PRNGKey(0))
    r_save_sync(str(tmp_path), 0, params, meta={"next_step": 1})
    port_params, specs = build_model(SMOKE, device="cpu").init(0)
    pspecs = _pspecs(specs)
    with Mesh((1, 2), ("data", "model"), device="cpu") as mesh:
        trees, manifest = restore_resharded(str(tmp_path),
                                            _to_meta(port_params), pspecs,
                                            mesh)
        assert manifest["step"] == 0 and len(trees) == 2
        ref_flat = dict(
            ("/".join(str(k.key) for k in kp), np.asarray(v))
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0])

        def check(tree, spec_tree, rank, path=()):
            if isinstance(tree, dict):
                for k in tree:
                    check(tree[k], spec_tree[k], rank, path + (k,))
                return
            want = ref_flat["/".join(path)]
            full = torch.from_numpy(want.view(np.int16).copy()).view(
                torch.bfloat16)
            assert tree.dtype == torch.bfloat16
            assert torch.equal(tree.view(torch.int16),
                               shard(full, spec_tree, mesh, rank).view(
                                   torch.int16)), path
        for r in range(2):
            check(trees[r], pspecs, r)

        # tp = 2 forward in float32 on the restored shards against the
        # reference's forward on the same (bf16 -> float32) params
        pcfg = dataclasses.replace(SMOKE, dtype=torch.float32)
        tok = np.random.default_rng(4).integers(0, SMOKE.vocab, size=(16, 2))

        def rank_fn(comm, trees, tokens):
            mine = trees[comm.data_index() * 2 + comm.model_index()]
            x, _ = build_model(pcfg, device="cpu").forward(
                jax.tree_util.tree_map(lambda t: t.float(), mine),
                {"tokens": tokens}, comm)
            return x
        got = spmd_map(rank_fn, mesh, (None, P("model")), P())(
            trees, torch.from_numpy(tok.astype(np.int32)))
    rcfg = dataclasses.replace(R_SMOKE, dtype=jnp.float32)
    want, _ = jax.jit(lambda p, t: r_build_model(rcfg).forward(
        p, {"tokens": t}, remat=False))(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params),
        jnp.asarray(tok, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# resume through the train loop
# ---------------------------------------------------------------------------

def _train_cfgs():
    from repro.models.common import ModelConfig as RConfig
    fields = dict(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=64, tp_target=4)
    from repro_torch.models.common import ModelConfig as PConfig
    return (RConfig(dtype=jnp.float32, **fields),
            PConfig(dtype=torch.float32, **fields))


@pytest.mark.usefixtures("one_torch_thread")
def test_resume_exactness(tmp_path):
    """tests/test_checkpoint.py::test_resume_exactness on the port: 10
    steps straight equal 6 steps checkpointed every 3 then a resume to
    10 (fresh states from the same seed each run: the port's step
    donates its state)."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.train.loop import LoopConfig, train_loop
    _, pcfg = _train_cfgs()
    model = build_model(pcfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    pipe = SyntheticPipeline(vocab=64, seq_len=16, global_batch=4)

    def fresh():
        state, specs = train_state_init(model, 0, opt)
        return state, make_train_step(model, specs, opt)

    state, step = fresh()
    s_straight, _ = train_loop(state, step, pipe,
                               LoopConfig(total_steps=10, log_every=0))
    state, step = fresh()
    train_loop(state, step, pipe, LoopConfig(
        total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3, log_every=0))
    assert latest_step(str(tmp_path)) == 5
    state, step = fresh()
    s_resumed, hist = train_loop(state, step, pipe, LoopConfig(
        total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=100,
        log_every=0))
    assert [r["step"] for r in hist] == [6, 7, 8, 9]
    assert int(s_resumed.opt.step) == 10
    for k, v in s_straight.params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert torch.equal(vv, s_resumed.params[k][kk])
        else:
            assert torch.equal(v, s_resumed.params[k])


@pytest.mark.usefixtures("one_torch_thread")
def test_port_resumes_a_reference_train_state(tmp_path):
    """The reference's loop trains 3 steps and checkpoints its
    ``TrainState`` (params, step, mu, nu, master); the port's loop
    resumes that checkpoint (same leaf names) and runs to step 6; the
    reference resumes a copy of it and runs to 6 as well.  The params
    agree within 3e-4 (lr 1e-3; float32 differences in tiny gradients
    move a param by a fraction of an Adam step), the losses at 1e-5."""
    import shutil
    from repro.data import SyntheticPipeline as RPipe
    from repro.optim import AdamWConfig as RAdamW
    from repro.train import make_train_step as r_step
    from repro.train import train_state_init as r_init
    from repro.train.loop import LoopConfig as RLoop
    from repro.train.loop import train_loop as r_loop
    from repro_torch.data import SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.train.loop import LoopConfig, train_loop
    rcfg, pcfg = _train_cfgs()
    rmodel = r_build_model(rcfg)
    ropt = RAdamW(lr=1e-3)
    rstate, rspecs = r_init(rmodel, jax.random.PRNGKey(0), ropt)
    rstep = jax.jit(r_step(rmodel, rspecs, ropt))
    wrap = lambda b, s: {k: jnp.asarray(v) for k, v in b.items()}  # noqa
    rpipe = RPipe(vocab=64, seq_len=16, global_batch=4)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    r_loop(rstate, rstep, rpipe, RLoop(total_steps=3, ckpt_dir=ref_dir,
                                        ckpt_every=100, log_every=0),
           batch_transform=wrap)
    shutil.copytree(ref_dir, port_dir)
    want, whist = r_loop(rstate, rstep, rpipe, RLoop(
        total_steps=6, ckpt_dir=ref_dir, ckpt_every=100, log_every=0),
        batch_transform=wrap)

    model = build_model(pcfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    like, specs = train_state_init(model, 1, opt)     # shapes only
    got, ghist = train_loop(like, make_train_step(model, specs, opt),
                            SyntheticPipeline(vocab=64, seq_len=16,
                                              global_batch=4),
                            LoopConfig(total_steps=6, ckpt_dir=port_dir,
                                       ckpt_every=100, log_every=0))
    assert [r["step"] for r in ghist] == [r["step"] for r in whist] == \
        [3, 4, 5]
    np.testing.assert_allclose([r["loss"] for r in ghist],
                               [r["loss"] for r in whist], rtol=1e-5)
    assert int(got.opt.step) == int(want.opt.step) == 6
    for w, (_, g) in zip(jax.tree_util.tree_leaves(want.params),
                         leaves_with_paths(got.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-4)
