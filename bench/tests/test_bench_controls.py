"""The comparison fails what it must: the control (the reference in the
program's place with float8 products) and each fault a cell can have,
planted in the program, drive a run whose ``correct`` comes out false.

On the CPU at the configurations' ``smoke`` sizes; the card-only cases
run the control at each cell's own size.
"""
import pytest
import torch

from bench.harness import correct, faults, runner, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 313


@pytest.fixture
def control_size(monkeypatch):
    """A cell's configuration at its ``control_test`` size for the cell's
    kind where it gives one (a depth at which rounding has grown as it
    does at full size), else at its ``smoke`` size."""
    orig = spec.cell

    def cell(name, root=None):
        c = orig(name, root)
        size = c.config.get("control_test", {}).get(c.traffic["kind"])
        if size:
            c.config = dict(c.config, smoke=size)
        return c
    monkeypatch.setattr(spec, "cell", cell)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, control_size):
    numbers = faults.control(name, SEED, 0.05, device="cpu", smoke=True)
    ok, rows = correct.judge(numbers, spec.cell(name).limits)
    assert not ok, rows


FAULTS = [(c, f) for c in CELLS for f in faults.names(c)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_fails(name, fault):
    r = runner.run(name, SEED, 0.05, False, device="cpu", smoke=True,
                   entries=faults.entries(fault))
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for k in range(3):
        numbers = faults.control(name, SEED + k, 3.0)
        ok, rows = correct.judge(numbers, spec.cell(name).limits)
        assert not ok, rows
