"""The port's 1F1B schedule and comm graph, straggler detection and
elastic mesh choice (``repro_torch/distributed/{pipeline,straggler,
elastic}.py``) on the CPU, held against the reference.

Mirrors ``TestPipeline`` (but ``test_pipelined_grads_match_monolithic``,
whose ``PipelinedModel`` waits for the training slice), ``TestStraggler``
and ``TestElastic`` of ``tests/test_distributed_features.py`` and
``TestStragglerWindow`` and ``TestShrinkMeshCfg`` of
``tests/test_chaos.py``, each on the same parameter cells run through the
reference too: the schedules' node names, edges and fire orders equal,
``build_1f1b_comm_graph``'s landing buffers equal to the reference's byte
for byte, the monitors' reports and the meshes equal.
"""
import numpy as np
import pytest
import torch

from repro.configs.gemma3_1b import SMOKE as R_SMOKE
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
from repro_torch.distributed import elastic
from repro_torch.models.common import ModelConfig


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
        with pytest.raises(NotImplementedError, match="A6b"):
            PipelinedModel([lambda p, x: x], n_micro=2)


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
