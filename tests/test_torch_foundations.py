"""The PyTorch port's foundations held against the JAX package.

* the attribute registry and status codes are the reference's, row for
  row (one config means the same thing to both packages);
* the LCQ no-lost/no-dup MPMC stress passes on the port;
* ``repro_torch`` (and ``examples/torch_*.py``) imports neither ``jax``,
  ``repro`` nor ``ml_dtypes``
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
            "repro_torch.kernels.doorbell, repro_torch.kernels.rmsnorm, "
            "repro_torch.kernels.flash_attention, repro_torch.models, "
            "repro_torch.models.registry, repro_torch.configs, "
            "repro_torch.serving, repro_torch.serving.batching, "
            "repro_torch.apps.kmer, repro_torch.launch.serve, "
            "repro_torch.core.axis, repro_torch.core.collectives, "
            "repro_torch.distributed, repro_torch.distributed.comm, "
            "repro_torch.distributed.spmd_map, repro_torch.checkpoint, "
            "repro_torch.data, repro_torch.distributed.pipeline, "
            "repro_torch.distributed.elastic; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')); print(bad)")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_serving_exports_the_batching_surface():
    """The port's counterpart of ``tests/test_public_api.py``'s check: the
    continuous-batching surface is public API of ``repro_torch.serving``
    too."""
    import importlib
    serving = importlib.import_module("repro_torch.serving")
    for name in ("ContinuousBatcher", "ServePlane", "TokenClient",
                 "SyntheticModel", "ResultTokens", "SlotData",
                 "SlotAllocator", "SERVING_ATTRS", "ResultDrain",
                 "encode_token_row", "decode_token_row"):
        assert name in serving.__all__, name
        assert hasattr(serving, name), name


#: the reference's public names the port does not export yet: none of
#: these packages' (the in-graph collectives and ``cache_pspecs`` are
#: ported)
NOT_PORTED = {"repro.core": set(), "repro.serving": set()}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_port_exports_the_reference_names(name):
    import importlib
    ref_mod = importlib.import_module(name)
    port_mod = importlib.import_module(name.replace("repro", "repro_torch",
                                                    1))
    missing = set(ref_mod.__all__) - set(port_mod.__all__)
    assert missing == NOT_PORTED[name]


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


_EXAMPLES = sorted(glob.glob(os.path.join(os.path.dirname(SRC), "examples",
                                          "torch_*.py")))


@pytest.mark.parametrize("path", _EXAMPLES, ids=os.path.basename)
def test_no_torch_example_imports_jax_or_reference(path):
    bad = [m for m in _top_imports(path) if m in _FORBIDDEN]
    assert not bad, f"{os.path.basename(path)} imports {bad}"


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


def test_kernel_library_is_stale_when_a_header_is_newer(tmp_path,
                                                        monkeypatch):
    """A library is rebuilt when its source or any header under csrc/ is
    newer than it: the tensor-core kernels share sm90_common.cuh."""
    from repro_torch.kernels import _build
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    src, header = csrc / "flash_attention.cu", csrc / "sm90_common.cuh"
    lib = build / "libflash_attention.so"
    assert _build._stale("flash_attention")            # no library yet
    for path, mtime in ((src, 100), (header, 100), (lib, 200)):
        path.write_text("")
        os.utime(path, (mtime, mtime))
    assert not _build._stale("flash_attention")
    os.utime(header, (300, 300))
    assert _build._stale("flash_attention")
    os.utime(lib, (400, 400))
    assert not _build._stale("flash_attention")
    os.utime(src, (500, 500))
    assert _build._stale("flash_attention")


def test_kernel_launches_are_counted_by_thread():
    """Every kernel wrapper counts its launches where it launches, in
    total and by the launching thread's name (``spmd_map``'s rank threads
    are ``spmd-rank<r>``)."""
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_push,
                                              stage_copy_rows)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    for fn in (stage_copy, stage_copy_rows, stage_copy_push,
               flash_attention_bhsd, moe_gmm, rmsnorm, ssd_scan_bhsp):
        assert isinstance(fn.launches, int), fn
        assert isinstance(fn.launches_by_thread, dict), fn

    def fn():
        pass
    fn.launches, fn.launches_by_thread = 0, {}

    def rank(n):
        for _ in range(n):
            count_launch(fn)
    threads = [threading.Thread(target=rank, args=(r + 1,),
                                name=f"spmd-rank{r}") for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    count_launch(fn, 4)
    assert fn.launches == 1 + 2 + 3 + 4
    assert fn.launches_by_thread == {
        "spmd-rank0": 1, "spmd-rank1": 2, "spmd-rank2": 3,
        threading.current_thread().name: 4}
