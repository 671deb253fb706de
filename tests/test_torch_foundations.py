"""The PyTorch port's foundations held against the JAX package.

* the attribute registry and status codes are the reference's, row for
  row (one config means the same thing to both packages);
* the LCQ no-lost/no-dup MPMC stress passes on the port;
* ``repro_torch`` imports neither ``jax``, ``repro`` nor ``ml_dtypes``
  (checked in a fresh interpreter and by an AST walk of every file);
* every ``repro_torch`` package ``__init__`` exports exactly what it
  imports (the drift guard ``tests/test_public_api.py`` keeps for the
  reference).
"""
import ast
import glob
import os
import subprocess
import sys
import threading
import time

import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import LCQ, AtomicFlag

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
PORT = os.path.join(SRC, "repro_torch")
JOIN_TIMEOUT = 60.0


def test_registry_table_equal_row_for_row():
    ours = port.registry_table().splitlines()
    theirs = ref.registry_table().splitlines()
    assert ours == theirs
    assert sorted(port.REGISTRY) == sorted(ref.REGISTRY)


@pytest.mark.parametrize("enum_name", ["ErrorKind", "ErrorCode"])
def test_status_codes_equal(enum_name):
    ours = {m.name: int(m) for m in getattr(port, enum_name)}
    theirs = {m.name: int(m) for m in getattr(ref, enum_name)}
    assert ours == theirs


def test_resolution_chain_matches_reference():
    layer = {"eager_max_bytes": 128, "wire_bf16": True}
    env = {"REPRO_ATTR_PACKET_BYTES": "4096"}
    a = port.resolve(runtime=layer, env=env)
    b = ref.resolve(runtime=layer, env=env)
    assert a.as_dict() == b.as_dict()
    assert {n: a.source(n) for n in a} == {n: b.source(n) for n in b}


def test_lcq_no_lost_no_dup_mpmc():
    """N producers, M consumers: every pushed item popped exactly once
    (the reference's ``TestLCQ.test_no_lost_no_dup_mpmc`` on the port)."""
    q = LCQ(64)                          # small: forces full/empty races
    NP, NC, PER = 4, 4, 3000
    popped = [[] for _ in range(NC)]
    done_flag = AtomicFlag()
    errors = []

    def producer(base):
        try:
            for i in range(PER):
                while not q.push(base * PER + i):
                    time.sleep(1e-6)     # full: back off, never drop
        except BaseException as e:       # surfaced below
            errors.append(e)

    def consumer(out):
        while True:
            item, ok = q.pop()
            if ok:
                out.append(item)
            elif done_flag.is_set() and not len(q):
                item, ok = q.pop()       # final race-free sweep
                if ok:
                    out.append(item)
                else:
                    return
            else:
                time.sleep(1e-6)

    consumers = [threading.Thread(target=consumer, args=(o,), daemon=True)
                 for o in popped]
    producers = [threading.Thread(target=producer, args=(b,), daemon=True)
                 for b in range(NP)]
    for t in consumers + producers:
        t.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    for t in producers:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in producers), "producer stuck"
    done_flag.test_and_set()
    for t in consumers:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in consumers), "consumer stuck"
    assert not errors
    flat = sorted(x for chunk in popped for x in chunk)
    assert flat == list(range(NP * PER)), (
        f"lost={NP * PER - len(flat)} or duplicated")


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.doorbell; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')); print(bad)")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


_FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
_FILES = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))


def _top_imports(path):
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", _FILES,
                         ids=lambda p: os.path.relpath(p, PORT))
def test_no_file_imports_jax_or_reference(path):
    bad = [m for m in _top_imports(path) if m in _FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, SRC)} imports {bad}"


def test_chip_smoke_imports_nothing_of_the_reference():
    root = os.path.dirname(SRC)
    bad = [m for m in _top_imports(os.path.join(root, "chip_smoke.py"))
           if m in _FORBIDDEN]
    assert not bad


_INITS = sorted(p for p in glob.glob(os.path.join(PORT, "**", "__init__.py"),
                                     recursive=True)
                if "from ." in open(p).read())


def _init_names(path):
    tree = ast.parse(open(path).read())
    imported, exported = set(), None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            imported |= {a.asname or a.name for a in node.names}
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "__all__" for t in node.targets):
            exported = {ast.literal_eval(e) for e in node.value.elts}
    return imported, exported


@pytest.mark.parametrize("path", _INITS,
                         ids=lambda p: os.path.relpath(p, SRC))
def test_all_matches_imports(path):
    import importlib
    imported, exported = _init_names(path)
    assert exported is not None, f"{path} has no __all__"
    assert imported <= exported, sorted(imported - exported)
    mod = importlib.import_module(
        os.path.relpath(os.path.dirname(path), SRC).replace(os.sep, "."))
    assert all(hasattr(mod, n) for n in exported)
