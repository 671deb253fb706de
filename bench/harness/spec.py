"""What a cell is, read from ``BENCHMARK.json`` and the data files beside it.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs[].file``: the configuration's sizes (``bench/configs/``),
  whose ``reference`` key names its plain reference, a module under
  ``bench/reference/`` with ``Model``, ``no_tf32``, ``prefill_last`` and
  ``train_steps``;
- ``bench/traffic/<traffic>.json``: the traffic mix;
- ``bench/limits/<workload>.json``: the limits of the cell's correctness
  comparison;
- ``bench/metrics/<metric>.py``: the reader of one per-layer metric.

Adding any of them takes new files and new entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path
    ref: Any                           # the configuration's reference


def load_benchmark(root: Optional[Path] = None) -> Dict[str, Any]:
    root = Path(root or ROOT)
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    root = Path(root or ROOT)
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"pick from {sorted(by_name)}")
    w = by_name[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    lim_path = root / "bench" / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic_name=w["traffic"], traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root, ref=reference(config, root))


def reference(config: Dict[str, Any], root: Optional[Path] = None):
    """The module that the configuration's ``reference`` names, a file
    under ``bench/reference/``, imported as ``bench.reference.<stem>``."""
    root = Path(root or ROOT)
    rel = Path(config["reference"])
    if rel.parts[:2] != ("bench", "reference") or len(rel.parts) != 3 \
            or rel.suffix != ".py":
        raise ValueError(f"reference {rel} is not a file of bench/reference")
    name = "bench.reference." + rel.stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, root / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def reader(metric: str, root: Optional[Path] = None) -> Callable:
    """``read(ctx)`` of ``bench/metrics/<metric>.py``: the metric's value,
    or None where the run gave it nothing to read."""
    root = Path(root or ROOT)
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
