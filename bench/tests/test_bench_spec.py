"""A cell, a configuration with its reference, a traffic mix, a limit and
a per-layer metric dropped in as new files and new entries run without
an edit to any file the benchmark has."""
import json
import shutil
from pathlib import Path

import pytest

from bench.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark with one more of everything."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "bench/configs/mamba2-370m.json").read_text())
    cfg["name"] = "mamba2-narrow"
    cfg["reference"] = "bench/reference/narrow.py"
    (tmp_path / "bench/configs/mamba2-narrow.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench/reference/narrow.py").write_text(
        "from .lm import Model, no_tf32, prefill_last, train_steps\n"
        "MARK = 'narrow'\n")
    mix = {"kind": "prefill", "block": [{"batch": 2, "seq": 16,
                                         "count": 2}],
           "tokens": {"dist": "uniform"}, "check_tokens": 4,
           "trace_blocks": 1}
    (tmp_path / "bench/traffic/tiny-pair.json").write_text(json.dumps(mix))
    (tmp_path / "bench/limits/narrow-tiny.json").write_text(json.dumps(
        {"checks": {"hidden_rel": {"limit": 1e-4},
                    "token_gap": {"limit": 1e-4}}}))
    (tmp_path / "bench/metrics/calls_seen.prefill.py").write_text(
        "def read(ctx):\n    return float(len(ctx.work))\n")
    bench["configs"].append({"name": "mamba2-narrow", "source": "x",
                             "file": "bench/configs/mamba2-narrow.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "narrow-tiny",
                               "config": "mamba2-narrow",
                               "traffic": "tiny-pair", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "prefill_tok_s" in (m["name"], m.get("moves")) or \
                m["name"] == "prefill_p95_ms":
            m.setdefault("workloads", []).append("narrow-tiny")
    bench["per_layer"].append({"name": "calls_seen.prefill", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving engine",
                               "moves": "prefill_tok_s",
                               "workloads": ["narrow-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    yield tmp_path
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), \
        "a file the benchmark had was edited"


def test_new_cell_found_by_name(grown):
    c = spec.cell("narrow-tiny", grown)
    assert c.config["name"] == "mamba2-narrow"
    assert c.ref.MARK == "narrow"
    assert c.traffic["block"][0]["seq"] == 16
    assert c.limits["checks"]["hidden_rel"]["limit"] == 1e-4
    assert [m["name"] for m in c.end_to_end] == [
        "setup_s", "prefill_tok_s", "prefill_p95_ms"]
    assert "calls_seen.prefill" in [m["name"] for m in c.per_layer]
    assert spec.reader("calls_seen.prefill", grown)(
        runner.Context("prefill", {}, "cpu", 1.0, [(2, 16)] * 3, [])) == 3


def test_new_cell_runs(grown):
    cfg = json.loads((grown / "bench/configs/mamba2-narrow.json").read_text())
    cfg["dtype"] = "float32"
    (grown / "bench/configs/mamba2-narrow.json").write_text(json.dumps(cfg))
    r = runner.run("narrow-tiny", 3, 0.05, True, device="cpu", smoke=True,
                   root=grown)
    assert r["correct"] is True
    assert r["metrics"]["calls_seen.prefill"]["value"] >= 2
    assert "device_idle.prefill" not in r["metrics"]    # no device here


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.limits.get("checks"), f"{w['name']} has no limits"
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
