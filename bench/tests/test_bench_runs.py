"""Tiny runs of each cell's path through the program's CPU paths (the
configurations' ``smoke`` sizes), checked against the reference; the
result line's keys; the run refusing a machine without a card or without
the program."""
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def float32(monkeypatch):
    """The cells' configurations in float32: the program's plain path
    then computes what the reference computes."""
    orig = spec.cell

    def cell(name, root=None):
        c = orig(name, root)
        c.config = dict(c.config, dtype="float32")
        return c
    monkeypatch.setattr(spec, "cell", cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_path_matches_reference(name, float32):
    r = runner.run(name, 2 ** 31 + 77, 0.05, False, device="cpu",
                   smoke=True)
    for check, c in r["checks"].items():
        assert c["value"] <= 1e-4, (check, c)
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    for trace in (False, True):
        r = runner.run(name, 5, 0.05, trace, device="cpu", smoke=True)
        assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
        line = json.loads(json.dumps(r))
        c = spec.cell(name)
        want = c.per_layer if trace else c.end_to_end
        names = {m["name"] for m in want}
        assert set(line["metrics"]) <= names
        if not trace:
            assert set(line["metrics"]) == names
            for m in want:
                v = line["metrics"][m["name"]]
                assert v["unit"] == m["unit"] and math.isfinite(v["value"])
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for check in line["checks"].values():
            assert set(check) == {"value", "limit"}


def test_refuses_without_a_card(capsys, monkeypatch):
    from bench import run
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
