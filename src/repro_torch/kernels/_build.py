"""Build and load the port's CUDA kernel libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by hand
with ``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>.so`` at the
repository root, then loaded with :mod:`ctypes`.  This takes seconds,
where ``torch.utils.cpp_extension.load`` (whose sources include
PyTorch's headers) takes minutes.  A library is rebuilt when it is
missing or older than its source; nothing is built at import time, only
at first use on the card.

``--use_fast_math`` is deliberately absent: it would flush subnormals in
the doorbell's float32 -> bfloat16 conversion.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
#: build output: ``build/`` at the repository root (listed in .gitignore)
BUILD = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build")

#: kernel library name -> CUDA source under csrc/
SOURCES = {"doorbell": "doorbell.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = os.path.join(CSRC, SOURCES[name])
    return not os.path.exists(lib) or \
        os.path.getmtime(lib) < os.path.getmtime(src)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (default: all) that are stale, one
    ``nvcc`` per source, all started together.  Returns ``{name:
    {"seconds": wall time, "ptxas": nvcc's resource report}}`` for each
    library built; raises with nvcc's output if one fails."""
    names = [n for n in (SOURCES if names is None else names) if _stale(n)]
    if not names:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in names:
        tmp = library_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    out = {}
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc {SOURCES[n]} failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))       # atomic: readers never see
        out[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
