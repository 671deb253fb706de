"""The port's 1F1B schedule and comm graph, ``PipelinedModel``, straggler
detection, elastic mesh choice, gradient compression and data-parallel
training (``repro_torch/distributed/{pipeline,straggler,elastic,
compression}.py``, ``optim/grad_sync.py``) on the CPU, held against the
reference.

Mirrors ``TestCompression``, ``TestPipeline``, ``TestStraggler``
and ``TestElastic`` of ``tests/test_distributed_features.py`` and
``TestStragglerWindow`` and ``TestShrinkMeshCfg`` of
``tests/test_chaos.py``, each on the same parameter cells run through the
reference too: the schedules' node names, edges and fire orders equal,
``build_1f1b_comm_graph``'s landing buffers equal to the reference's byte
for byte, the monitors' reports and the meshes equal; ``PipelinedModel``'s
grads equal the monolithic ones and the reference's; int8 quantization
bitwise the reference's.  Data parallel (:class:`TestDataParallel`): dp =
2 ``LciAxis`` rank threads on a (2, 1) mesh against the reference's
``make_train_step`` under ``shard_map`` on 2 fake devices
(``tests/helpers/torch_train_ref.py``, a child process) and against dp =
1 on the global batch; compressed dp = 2 training converges as
``tests/helpers/compressed_training.py`` requires; ``psum_model_ge``'s
backward is the identity.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gemma3_1b import SMOKE as R_SMOKE
from repro.distributed import compression as r_compression
from repro.models.registry import build_model as r_build_model
from repro.core import CommConfig as RCommConfig
from repro.core import LocalCluster as RCluster
from repro.distributed import elastic as r_elastic
from repro.distributed import pipeline as r_pipeline
from repro.distributed import straggler as r_straggler
from repro.models.common import ModelConfig as RConfig

from repro_torch.configs.gemma3_1b import SMOKE
from repro_torch.core import CommConfig, LocalCluster
from repro_torch.distributed import (HostWatchdog, Mesh, P, PipelinedModel,
                                     StepTimeMonitor, bubble_fraction,
                                     build_1f1b_comm_graph,
                                     compatible_meshes, reshard_state, shard,
                                     schedule_1f1b, shrink_mesh)
from repro_torch.distributed import elastic, spmd_map
from repro_torch.distributed.compression import (compress_grad,
                                                 dequantize_int8,
                                                 grad_sync_compressed,
                                                 init_error_state,
                                                 quantize_int8)
from repro_torch.core.modes import CommMode
from repro_torch.data import SyntheticPipeline
from repro_torch.launch.mesh import batch_pspecs
from repro_torch.launch.train import mesh_step, shard_state
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model, params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    grad_sync
from repro_torch.core.tree import leaves_with_paths
from repro_torch.train import TrainState, loss_and_grads, make_train_step
from test_torch_train import one_torch_thread  # noqa: F401  (a fixture)


def _shape(g):
    return ([n.name for n in g._nodes], [n.deps for n in g._nodes])


class TestPipeline:
    @pytest.mark.parametrize("s,m", [(2, 4), (4, 8), (3, 3)])
    def test_schedule_valid(self, s, m):
        g, ids = schedule_1f1b(s, m)
        g.execute()
        g.assert_partial_order()
        assert len(g) == 2 * s * m
        rg, rids = r_pipeline.schedule_1f1b(s, m)
        rg.execute()
        assert _shape(g) == _shape(rg)
        assert g.fire_order == rg.fire_order
        assert {(n.stage, n.micro, n.is_fwd): i for n, i in ids.items()} == \
            {(n.stage, n.micro, n.is_fwd): i for n, i in rids.items()}

    def test_critical_path_matches_bubble(self):
        s, m = 4, 8
        g, _ = schedule_1f1b(s, m)
        g.execute()
        assert g.critical_path_len() == 2 * (s - 1) + 2 * m
        assert bubble_fraction(s, m) == pytest.approx((s - 1) / (s - 1 + m))
        assert bubble_fraction(s, m) == r_pipeline.bubble_fraction(s, m)

    @pytest.mark.parametrize("s,m", [(2, 3), (3, 4)])
    def test_async_comm_graph_completes_over_the_wire(self, s, m):
        cl = LocalCluster(s, CommConfig(inject_max_bytes=64),
                          fabric_depth=1 << 14, device="cpu")
        eps = cl.alloc_endpoint(n_devices=2, name="pp")
        pg = build_1f1b_comm_graph(cl, n_micro=m, payload_bytes=16,
                                   endpoints=eps)
        g = pg.graph
        g.start()
        assert not g.test()[0]                   # async: not done at start
        while not g.test()[0]:
            cl.progress_all()
        g.assert_partial_order()
        for micro in range(m):
            exp = micro % 251
            for s_ in range(s - 1):
                exp = (exp + s_ + 1) % 251
                assert torch.all(pg.act_in[(s_, micro)] == exp)
        vals = g.execute()
        g.assert_partial_order()
        assert len(vals) == len(g)
        cl.close()

    @pytest.mark.parametrize("s,m,nbytes", [(2, 3, 16), (3, 4, 16),
                                            (4, 8, 32), (3, 2, 100)])
    def test_landing_buffers_equal_the_reference(self, s, m, nbytes):
        """The same graph on both packages: the same nodes and edges, and
        every activation and gradient landing byte for byte the
        reference's."""
        cl = LocalCluster(s, CommConfig(inject_max_bytes=64),
                          fabric_depth=1 << 14, device="cpu")
        rcl = RCluster(s, RCommConfig(inject_max_bytes=64),
                       fabric_depth=1 << 14)
        pg = build_1f1b_comm_graph(cl, n_micro=m, payload_bytes=nbytes,
                                   endpoints=cl.alloc_endpoint(
                                       n_devices=2, name="pp"))
        rpg = r_pipeline.build_1f1b_comm_graph(
            rcl, n_micro=m, payload_bytes=nbytes,
            endpoints=rcl.alloc_endpoint(n_devices=2, name="pp"))
        assert _shape(pg.graph) == _shape(rpg.graph)
        assert pg.comm_ids == rpg.comm_ids
        pg.graph.execute()
        rpg.graph.execute()
        pg.graph.assert_partial_order()
        for mine, ref in ((pg.act_in, rpg.act_in),
                          (pg.grad_in, rpg.grad_in)):
            assert sorted(mine) == sorted(ref)
            for k in ref:
                assert mine[k].dtype == torch.uint8
                assert mine[k].numpy().tobytes() == ref[k].tobytes(), k
        assert pg.graph.critical_path_len() == rpg.graph.critical_path_len()
        cl.close()
        rcl.close()

    def test_one_stage_refused(self):
        cl = LocalCluster(1, device="cpu")
        with pytest.raises(ValueError, match="2 stages"):
            build_1f1b_comm_graph(cl, n_micro=2)
        cl.close()

    def test_pipelined_model_waits_for_training(self):
        """``PipelinedModel`` is ported: a two-stage identity pipeline
        hands each microbatch's activation forward and its cotangent
        back (the loss y.sum() gives a ones gradient to a scale)."""
        xs = [torch.full((2,), float(m)) for m in range(3)]
        loss, (g0, g1) = PipelinedModel(
            [lambda p, x: x * p, lambda p, x: x + p], n_micro=3
        ).forward_backward([torch.tensor(2.0), torch.tensor(0.5)], xs,
                           lambda y, m: y.sum())
        assert float(loss) == pytest.approx((0 + 4 + 8 + 3) / 3)
        assert float(g0) == pytest.approx(2 * (0 + 1 + 2))
        assert float(g1) == pytest.approx(2 * 3)

    @staticmethod
    def _two_stage_case():
        rng = np.random.default_rng(0)
        w1 = (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
        w2 = (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
        xs = [rng.standard_normal((4, 8)).astype(np.float32)
              for _ in range(4)]
        ts = [rng.standard_normal((4, 8)).astype(np.float32)
              for _ in range(4)]
        return w1, w2, xs, ts

    def test_pipelined_grads_match_monolithic(self):
        """tests/test_distributed_features.py's case on the port (inputs
        from numpy): the pipeline sums microbatch grads as one autograd
        pass over the whole batch does."""
        w1, w2, xs, ts = (self._two_stage_case())
        t = torch.from_numpy
        txs, tts = [t(x) for x in xs], [t(y) for y in ts]

        def s0(p, x):
            return torch.tanh(x @ p)

        def s1(p, x):
            return x @ p

        def loss_fn(y, m):
            return ((y - tts[m]) ** 2).mean()

        loss_pp, (g1p, g2p) = PipelinedModel([s0, s1], n_micro=4) \
            .forward_backward([t(w1), t(w2)], txs, loss_fn)
        a, b = t(w1).requires_grad_(), t(w2).requires_grad_()
        total = torch.stack([loss_fn(s1(b, s0(a, txs[m])), m)
                             for m in range(4)])
        g1, g2 = torch.autograd.grad(total.sum(), [a, b])
        torch.testing.assert_close(g1p, g1, atol=1e-5, rtol=0)
        torch.testing.assert_close(g2p, g2, atol=1e-5, rtol=0)
        assert float(loss_pp) == pytest.approx(float(total.detach().mean()))

    def test_pipelined_grads_equal_the_reference(self):
        """The same case through the reference's ``PipelinedModel``: the
        mean loss and both stages' grads within 1e-6."""
        w1, w2, xs, ts = self._two_stage_case()

        def loss_r(y, m):
            return ((y - jnp.asarray(ts[m])) ** 2).mean()

        want_l, (w_g1, w_g2) = r_pipeline.PipelinedModel(
            [lambda p, x: jnp.tanh(x @ p), lambda p, x: x @ p], n_micro=4
        ).forward_backward([jnp.asarray(w1), jnp.asarray(w2)],
                           [jnp.asarray(x) for x in xs], loss_r)
        t = torch.from_numpy
        got_l, (g1, g2) = PipelinedModel(
            [lambda p, x: torch.tanh(x @ p), lambda p, x: x @ p], n_micro=4
        ).forward_backward([t(w1), t(w2)], [t(x) for x in xs],
                           lambda y, m: ((y - t(ts[m])) ** 2).mean())
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
        np.testing.assert_allclose(g1.numpy(), np.asarray(w_g1), atol=1e-6)
        np.testing.assert_allclose(g2.numpy(), np.asarray(w_g2), atol=1e-6)


def _reports(mon):
    return [(r.step, r.dt, r.mean, r.std, r.zscore) for r in mon.reports], \
        [r.step for r in mon.flagged], mon.summary()


class TestStraggler:
    def test_zscore_flags_outlier(self):
        mons = [M(window=20, z_threshold=3.0, warmup=5)
                for M in (StepTimeMonitor, r_straggler.StepTimeMonitor)]
        for mon in mons:
            for i in range(20):
                mon.record(i, 0.1 + 0.001 * (i % 3))
            rep = mon.record(20, 1.5)
            assert rep is not None and rep.zscore > 3.0
            assert mon.summary()["flagged"] == 1
        assert _reports(mons[0]) == _reports(mons[1])

    def test_steady_state_quiet(self):
        mon = StepTimeMonitor()
        for i in range(100):
            assert mon.record(i, 0.1) is None

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reports_equal_the_reference(self, seed):
        dts = np.random.default_rng(seed).lognormal(-2.0, 0.6, 120)
        dts[[30, 31, 77]] *= 20                  # stragglers, two in a row
        mons = [M(window=25, z_threshold=2.5, warmup=6)
                for M in (StepTimeMonitor, r_straggler.StepTimeMonitor)]
        for mon in mons:
            for i, dt in enumerate(dts):
                mon.record(i, float(dt))
        assert _reports(mons[0]) == _reports(mons[1])

    def test_watchdog(self):
        for W in (HostWatchdog, r_straggler.HostWatchdog):
            wd = W(n_hosts=4, grace=5)
            for h in range(4):
                wd.beat(h, 100 if h != 2 else 80)
            assert wd.dead_hosts() == [2]


class TestStragglerWindow:
    def test_consecutive_stragglers_both_flagged(self):
        mon = StepTimeMonitor(window=20, z_threshold=3.0, warmup=5)
        for i in range(10):
            mon.record(i, 1.0 + 0.001 * (i % 3))
        assert mon.record(10, 5.0) is not None
        assert mon.record(11, 5.0) is not None    # second one still seen
        assert len(mon.flagged) == 2
        assert mon.record(12, 1.001) is None


#: ModelConfig fields for compatible_meshes' cells
MESH_CFGS = {
    "dense8": dict(family="dense", n_layers=2, d_model=64, n_heads=8,
                   n_kv_heads=8, d_ff=128, vocab=256, tp_target=4),
    "heads3": dict(family="dense", n_layers=2, d_model=48, n_heads=3,
                   n_kv_heads=3, d_ff=96, vocab=300, tp_target=4),
    "moe": dict(family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=96, vocab=256, n_experts=6, top_k=2,
                tp_target=2),
    "ssm": dict(family="ssm", n_layers=2, d_model=64, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16,
                ssm_headdim=16, tp_target=4),
}


class TestElastic:
    def test_compatible_meshes(self):
        cfg = ModelConfig(name="t", **MESH_CFGS["dense8"])
        meshes = compatible_meshes(cfg, 16)
        assert (4, 4) in meshes and (16, 1) in meshes
        assert (1, 16) not in meshes

    @pytest.mark.parametrize("name", sorted(MESH_CFGS))
    @pytest.mark.parametrize("n", [1, 4, 6, 12, 16])
    def test_compatible_meshes_equal_the_reference(self, name, n):
        cfg = ModelConfig(name=name, **MESH_CFGS[name])
        rcfg = RConfig(name=name, **MESH_CFGS[name])
        assert compatible_meshes(cfg, n) == \
            r_elastic.compatible_meshes(rcfg, n)

    def test_shrink_mesh(self):
        assert shrink_mesh((16, 16), dead_fraction=0.5) == (8, 16)

    @pytest.mark.parametrize("old,dead", [((2, 1), 0.5), ((4, 2), 0.25),
                                          ((2, 2), 0.0), ((4, 4), 0.5),
                                          ((8, 1), 0.375)])
    def test_shrink_mesh_equals_the_reference(self, old, dead):
        assert shrink_mesh(old, dead) == r_elastic.shrink_mesh(old, dead)
        assert shrink_mesh(old, dead, SMOKE) == \
            r_elastic.shrink_mesh(old, dead, R_SMOKE)

    def test_reshard_state_cuts_each_rank(self):
        rng = np.random.default_rng(5)
        state = {"w": torch.from_numpy(rng.standard_normal((4, 6))),
                 "b": torch.from_numpy(rng.standard_normal(6)),
                 "step": torch.tensor(3)}
        specs = {"w": P(None, "model"), "b": P("model"), "step": None}
        with Mesh((2, 2), ("data", "model"), device="cpu") as mesh:
            trees = reshard_state(state, specs, mesh)
            assert len(trees) == 4
            for r, tree in enumerate(trees):
                for k in ("w", "b"):
                    assert torch.equal(tree[k],
                                       shard(state[k], specs[k], mesh, r))
                assert tree["w"].shape == (4, 3)
                assert tree["step"] is trees[0]["step"]


class TestShrinkMeshCfg:
    def test_cfg_snaps_to_compatible(self):
        shape = shrink_mesh((4, 2), 0.25, SMOKE)   # 8 -> target 6
        n = shape[0] * shape[1]
        assert n <= 6
        assert tuple(shape) in {(d, m) for d, m in
                                compatible_meshes(SMOKE, n)}

    def test_cfg_none_keeps_model_axis(self):
        assert shrink_mesh((4, 2), 0.5) == (2, 2)

    def test_prefers_old_model_width(self):
        shape = shrink_mesh((2, 2), 0.0, SMOKE)    # nothing died
        assert shape[0] * shape[1] == 4
        if (2, 2) in compatible_meshes(SMOKE, 4):
            assert shape == (2, 2)

    def test_incompatible_raises(self, monkeypatch):
        monkeypatch.setattr(elastic, "compatible_meshes",
                            lambda cfg, n: [])
        with pytest.raises(ValueError, match="no mesh"):
            elastic.shrink_mesh((4, 2), 0.5, SMOKE)


@pytest.mark.usefixtures("one_torch_thread")
class TestCompression:
    def test_quantize_bitwise_equal_the_reference(self):
        """int8 codes, scale, dequantized values and the new error of
        ``compress_grad`` bitwise the reference's (numpy inputs, several
        magnitudes and a zero tensor)."""
        rng = np.random.default_rng(5)
        for scale in (3.0, 1e-3, 0.0):
            g = (rng.standard_normal((257,)) * scale).astype(np.float32)
            e = (rng.standard_normal((257,)) * 1e-3 * scale).astype(
                np.float32)
            q, sc = quantize_int8(torch.from_numpy(g))
            rq, rsc = r_compression.quantize_int8(jnp.asarray(g))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            assert float(sc) == float(rsc)
            np.testing.assert_array_equal(
                dequantize_int8(q, sc).numpy(),
                np.asarray(r_compression.dequantize_int8(rq, rsc)))
            got = compress_grad(torch.from_numpy(g), torch.from_numpy(e))
            want = r_compression.compress_grad(jnp.asarray(g),
                                               jnp.asarray(e))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_quant_roundtrip_error_bounded(self):
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            128).astype(np.float32) * 3)
        q, scale = quantize_int8(g)
        assert float((dequantize_int8(q, scale) - g).abs().max()) <= \
            float(scale) * 0.5 + 1e-6

    def test_error_feedback_accumulates(self):
        """The running sum of dequantized grads tracks the running sum of
        the true grads within one quantization step, not O(steps)."""
        rng = np.random.default_rng(1)
        err = torch.zeros(64)
        true_sum, sent_sum = torch.zeros(64), torch.zeros(64)
        for _ in range(50):
            g = torch.from_numpy(rng.standard_normal(64).astype(
                np.float32) * 0.01)
            q, scale, err = compress_grad(g, err)
            true_sum += g
            sent_sum += dequantize_int8(q, scale)
        assert float((true_sum - sent_sum).abs().max()) < 0.01


#: tests/helpers/compressed_training.py's config, on a (2, 1) mesh
DP_FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=4, d_ff=128, vocab=64, tp_target=4)
DP_LR = 1e-3
HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _dp_case(n_batches=3, seq=16, batch=4):
    """The reference's params (its own draw) carried to the port, the
    port's specs and numpy batches."""
    rcfg = RConfig(dtype=jnp.float32, **DP_FIELDS)
    params, _ = r_build_model(rcfg).init(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)
    pcfg = ModelConfig(dtype=torch.float32, **DP_FIELDS)
    _, specs = build_model(pcfg, device="cpu").init(0)
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, 64, size=(seq, batch)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(n_batches)]
    return host, pcfg, specs, batches


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.usefixtures("one_torch_thread")
class TestDataParallel:
    def _reference(self, tmp_path, host, batches):
        data = _flat(host, "params")
        for i, b in enumerate(batches):
            data[f"tokens/{i}"], data[f"labels/{i}"] = b["tokens"], \
                b["labels"]
        np.savez(tmp_path / "in.npz", **data)
        (tmp_path / "cfg.json").write_text(json.dumps(
            {**DP_FIELDS, "lr": DP_LR}))
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        r = subprocess.run(
            [sys.executable, os.path.join(HELPERS, "torch_train_ref.py"),
             str(tmp_path / "in.npz"), str(tmp_path / "cfg.json"),
             str(tmp_path / "out.npz")], capture_output=True, text=True,
            timeout=600, env=env)
        assert r.returncode == 0 and "HELPER-OK" in r.stdout, r.stderr
        return dict(np.load(tmp_path / "out.npz"))

    def test_dp2_matches_reference_and_dp1(self, tmp_path):
        """dp = 2 rank threads: the synced grads bitwise equal on both
        ranks, within 1e-4 of each leaf's largest element of the
        reference's (under ``shard_map``, FSDP on) and of dp = 1 on the
        global batch; three launcher steps (``mesh_step``, lr 1e-3, on
        the state cut over the mesh, FSDP on, put together after) leave
        the params within 3e-4 of the reference's and of dp = 1's (Adam
        divides by sqrt(nu), so float32 differences in tiny gradients
        move a param by a fraction of a step), the losses at 1e-5."""
        host, pcfg, specs, batches = _dp_case()
        want = self._reference(tmp_path, host, batches)
        model = build_model(pcfg, device="cpu")
        by_rank = {}

        def rank_grads(comm, params, batch):
            comm = dataclasses.replace(comm, fsdp=False)
            _, _, grads = loss_and_grads(model, params, batch, comm)
            by_rank[comm.data_index()] = grad_sync(grads, specs, comm)
            return 0

        with Mesh((2, 1), ("data", "model"), device="cpu") as mesh:
            bspec = batch_pspecs(pcfg, "train", mesh, batch=4)
            spmd_map(rank_grads, mesh, (P(), bspec), None)(
                params_from_numpy(pcfg, host, device="cpu"),
                _tensors(batches[0]))
            opt = AdamWConfig(lr=DP_LR)
            state = TrainState(params_from_numpy(pcfg, host, device="cpu"),
                               None)
            state.opt = adamw_init(state.params, opt)
            state = shard_state(state, specs, mesh)
            step = mesh_step(model, specs, opt, mesh, CommConfig(), batch=4)
            losses = []
            for b in batches:
                state, m = step(state, _tensors(b))
                losses.append(float(m["loss"]))
            state = state.gather()
        # dp = 1 on the global batch
        _, _, one = loss_and_grads(model, params_from_numpy(
            pcfg, host, device="cpu"), _tensors(batches[0]),
            _local_comm())
        state1 = TrainState(params_from_numpy(pcfg, host, device="cpu"),
                            None)
        state1.opt = adamw_init(state1.params, opt)
        step1 = make_train_step(model, specs, opt)
        losses1 = []
        for b in batches:
            state1, m = step1(state1, _tensors(b))
            losses1.append(float(m["loss"]))

        g0, g1 = (dict(leaves_with_paths(by_rank[r])) for r in (0, 1))
        for name, g in g0.items():
            assert torch.equal(g, g1[name]), name
            w = want[f"grads/{name}"]
            tol = 1e-4 * max(np.abs(w).max(), 1e-12)
            assert np.abs(g.numpy() - w).max() <= tol, name
            o = dict(leaves_with_paths(one))[name].numpy()
            assert np.abs(g.numpy() - o).max() <= tol, name
        np.testing.assert_allclose(losses, want["loss"], rtol=1e-5)
        np.testing.assert_allclose(losses, losses1, rtol=1e-5)
        p1 = dict(leaves_with_paths(state1.params))
        for name, p in leaves_with_paths(state.params):
            np.testing.assert_allclose(p.numpy(), want[f"params/{name}"],
                                       atol=3e-4)
            np.testing.assert_allclose(p.numpy(), p1[name].numpy(),
                                       atol=3e-4)

    def test_compressed_training_converges(self):
        """tests/helpers/compressed_training.py's check on dp = 2 rank
        threads: 30 steps with ``grad_sync_compressed`` learn (the last 5
        losses' mean at least 0.3 under the first) and stay within 0.4 of
        the uncompressed run."""
        pcfg = ModelConfig(dtype=torch.float32, **DP_FIELDS)
        model = build_model(pcfg, device="cpu")
        params, specs = model.init(0)
        opt = AdamWConfig(lr=3e-3, weight_decay=0.0, max_grad_norm=0.0)
        pipe = SyntheticPipeline(vocab=64, seq_len=32, global_batch=8)

        def run(compressed, mesh, steps=30):
            p0 = jax.tree_util.tree_map(torch.clone, params)
            st = [p0, adamw_init(p0, opt), init_error_state(p0)]
            bspec = batch_pspecs(pcfg, "train", mesh, batch=8)

            def rank_step(comm, p, o, e, batch):
                comm = dataclasses.replace(comm, fsdp=False)
                loss, _, grads = loss_and_grads(model, p, batch, comm)
                if compressed:
                    grads, e = grad_sync_compressed(grads, specs, e, comm)
                else:
                    grads = grad_sync(grads, specs, comm)
                p, o = adamw_update(grads, o, p, opt)
                return p, o, e, comm.pmean_all(loss)

            step = spmd_map(rank_step, mesh, (P(), P(), P(), bspec),
                            (P(), P(), P(), P()),
                            config=CommConfig(mode=CommMode.LCI_DEDICATED))
            losses = []
            for i in range(steps):
                *st, loss = step(*st, pipe.get_batch(i, device="cpu"))
                losses.append(float(loss))
            return losses

        with Mesh((2, 1), ("data", "model"), device="cpu") as mesh:
            base = run(False, mesh)
            comp = run(True, mesh)
        assert np.mean(comp[-5:]) < comp[0] - 0.3
        assert abs(np.mean(comp[-5:]) - np.mean(base[-5:])) < 0.4


def test_launch_mesh_helpers():
    """``launch/mesh.py``: the data axes of a mesh, the step Comm bound to
    a rank's axes, a tree cut for one rank, the batch's specs."""
    from repro_torch.launch.mesh import data_axes, make_comm, shard as cut
    with Mesh((2, 1), ("data", "model"), device="cpu") as mesh:
        assert data_axes(mesh) == ("data",)
        comm = make_comm(mesh, mesh.lci_axes(1), fsdp=False)
        assert (comm.dp, comm.tp, comm.data_index(), comm.fsdp) == \
            (2, 1, 1, False)
        tree = {"a": torch.arange(8).reshape(4, 2), "b": torch.ones(3)}
        got = cut(mesh, tree, {"a": P("data"), "b": P()}, 1)
        assert torch.equal(got["a"], tree["a"][2:])
        assert torch.equal(got["b"], tree["b"])
        assert batch_pspecs(None, "train", mesh, batch=4) == {
            "tokens": P("model", ("data",)),
            "labels": P("model", ("data",))}


@pytest.mark.usefixtures("one_torch_thread")
class TestPsumModelGradExact:
    def test_backward_is_the_identity(self):
        """On a (1, 2) mesh: the forward is the psum over the model axis,
        the cotangent passes through untouched (not summed again)."""
        x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
        c = torch.tensor([[1.0, -2.0, 0.5, 3.0], [0.0, 1.0, 2.0, -1.0]])

        def fn(comm, x, c):
            xr = x.clone().requires_grad_()
            y = comm.psum_model_ge(xr)
            (g,) = torch.autograd.grad((y * c).sum(), xr)
            return y.detach(), g

        with Mesh((1, 2), ("data", "model"), device="cpu") as mesh:
            y, g = spmd_map(fn, mesh, (P("model"), P("model")),
                            (P("model"), P("model")))(x, c)
        torch.testing.assert_close(y, (x[0] + x[1]).repeat(2, 1))
        torch.testing.assert_close(g, c)


def _local_comm():
    from repro_torch.distributed import local_comm
    return local_comm()
