"""Shared fixtures.  NOTE: no XLA_FLAGS here — the main pytest process
sees exactly 1 device; multi-device tests run subprocess helpers from
tests/helpers/ with the flag set in the child's environment only."""
import os
import subprocess
import sys

import pytest

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_helper(name: str, *args: str, devices: int = 8,
               timeout: int = 900) -> str:
    """Run tests/helpers/<name>.py in a child with N fake devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.abspath(SRC)
    r = subprocess.run(
        [sys.executable, os.path.join(HELPERS, name + ".py"), *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, (
        f"helper {name} failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}")
    return r.stdout


@pytest.fixture(scope="session")
def helper_runner():
    return run_helper


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (the "
        "port's kernels are held on the card by chip_smoke.py)")
