"""The port's examples (``examples/torch_*.py``) on the CPU, each in a
subprocess at its small setting, against the reference's examples.

* each prints the reference example's OK line with ``--device cpu``;
* the k-mer histogram equals the reference example's at the same reads;
* the serve demo parks the same backlog and returns the same tokens as
  the reference's.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script), *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, f"{script}:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def _line(out, prefix):
    return next(line for line in out.splitlines() if line.startswith(prefix))


def test_quickstart_on_the_cpu():
    out = _run("torch_quickstart.py", "--device", "cpu")
    assert out.splitlines()[-1] == "quickstart OK"
    assert "chaos: 200/200 delivered in order" in out
    assert "serving: 12/12 streams exactly-once" in out
    assert "the same on a (1, 4) mesh of rank threads" in out


def test_kmer_histogram_equals_the_reference_example():
    args = ("--reads", "400", "--ranks", "3")
    port = _run("torch_kmer_counting.py", *args, "--device", "cpu")
    ref = _run("kmer_counting.py", *args)
    assert port.splitlines()[-1] == ref.splitlines()[-1] == \
        "kmer example OK"
    for prefix in ("oracle:", "exactness:", "histogram"):
        got, want = _line(port, prefix), _line(ref, prefix)
        if prefix == "oracle:":                 # the timing differs
            got, want = got.split(" (")[0], want.split(" (")[0]
        assert got == want


def test_serve_demo_backlog_equals_the_reference_example():
    port = _run("torch_serve_demo.py", "--device", "cpu")
    ref = _run("serve_demo.py")
    assert port.splitlines()[-1] == ref.splitlines()[-1] == "serve demo OK"
    assert _line(port, "submitted") == _line(ref, "submitted")
    parked = int(re.search(r"\((\d+) parked", _line(port, "submitted"))[1])
    assert parked > 0
    tokens = [re.search(r"done: (\d+) tokens", _line(o, "done:"))[1]
              for o in (port, ref)]
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("steps", [12])
def test_train_100m_tiny_learns(tmp_path, steps):
    out = _run("torch_train_100m.py", "--tiny", "--steps", str(steps),
               "--seq", "32", "--batch", "4", "--lr", "3e-3",
               "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu")
    assert out.splitlines()[-1] == "train_100m OK"
    assert (tmp_path / "ckpt" / "metrics.csv").exists()
