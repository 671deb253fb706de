"""Launch-geometry variants of B1 (the doorbell stage copy) and B3
(RMSNorm), timed against each other and their library calls.

    python3 tools/probe_stage_rms.py [--parent ROOT]   # on the card,
                                                       # from the repo root

Compiles copies of ``csrc/doorbell.cu`` and ``csrc/rmsnorm.cu`` with their
constants swapped by text (B1: threads a block, 16-byte vectors a thread
a unit, blocks an SM; B3: a register cap through the row kernel's
``__launch_bounds__`` minimum of blocks an SM) into ``build/variants/``,
all nvcc runs started together, and prints each variant's registers and
spills.  ``--parent ROOT`` adds the two sources of another checkout
(unpacked with ``git archive`` into a git-ignored directory) as variant
``parent``, so that an older kernel is timed in turns with this one on
one card; a source without the gather entry is timed dense only.
Then, by ``chip_smoke.py``'s CUDA-graph timing (inputs past the L2
cache): B1's dense and gather calls of each variant at the main
path's doorbells, beside ``clone`` / ``to(bfloat16)``; B3 of each
variant at the served paths' prefill shapes, beside ``F.rms_norm``, a
``clone`` of x (the same bytes moved, no arithmetic) and the bytes bound.
Variant ``A`` is the source as it stands.  Every output is checked.
"""
import argparse
import array
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch                                     # noqa: E402
import torch.nn.functional as F                  # noqa: E402

import chip_smoke as cs                          # noqa: E402
from repro_torch.kernels import _build           # noqa: E402
from repro_torch.kernels.doorbell import ops as db_ops    # noqa: E402
from repro_torch.kernels.doorbell import stage_copy_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops    # noqa: E402

OUT = os.path.join(_build.BUILD, "variants")
ROW = "__global__ void __launch_bounds__(kThreads)\nrmsnorm_row_kernel("


def _cap(expr):
    return [(ROW, "__global__ void __launch_bounds__(kThreads, " + expr +
             ")\nrmsnorm_row_kernel(")]


DOORBELL = {
    "A_256x4_b4": [],
    "B_128x4_b8": [("kThreads = 256", "kThreads = 128"),
                   ("kBlocksPerSm = 4", "kBlocksPerSm = 8")],
    "C_256x2_b4": [("kUnroll = 4", "kUnroll = 2")],
    "D_256x8_b4": [("kUnroll = 4", "kUnroll = 8")],
    "E_256x4_b8": [("kBlocksPerSm = 4", "kBlocksPerSm = 8")],
    "F_512x4_b4": [("kThreads = 256", "kThreads = 512")],
}
RMSNORM = {
    "A_default": [],
    "B_min3_2": _cap("(kVecs >= 13 ? 2 : 3)"),
    "C_min4_3": _cap("(kVecs >= 13 ? 3 : 4)"),
}


def compile_variant(src, name, subs, csrc=_build.CSRC):
    text = open(os.path.join(csrc, src)).read()
    for a, b in subs:
        if a not in text:
            raise ValueError(f"{name}: {a!r} is not in {src}")
        text = text.replace(a, b)
    path = os.path.join(OUT, name + ".cu")
    lib = os.path.join(OUT, f"lib{name}.so")
    with open(path, "w") as f:
        f.write(text)
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
    rep = cs.ptxas_report(p.stdout + p.stderr)
    print(json.dumps({"variant": name,
                      "registers": sorted({r["registers"] for r in rep}),
                      "spilling_kernels": sum(
                          1 for r in rep
                          if r["spill_stores"] + r["spill_loads"])}),
          flush=True)
    return name, ctypes.CDLL(lib)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def dense(lib, t, bf16):
    cast = bf16 and t.dtype == torch.float32
    k, e = t.shape
    out = torch.empty((k, e * (2 if cast else t.element_size())),
                      dtype=torch.uint8, device="cuda")
    rc = db_ops._bind(lib, "repro_stage_copy")(
        t.data_ptr(), out.data_ptr(), None, 1, 1, t.nbytes, out.numel(),
        out.numel(), int(cast), _stream())
    if rc:
        raise RuntimeError(f"stage_copy: CUDA error {rc}")
    return out


def gather(lib, rows, bf16):
    cast = bf16 and rows[0].dtype == torch.float32
    e = rows[0].numel()
    out = torch.empty((len(rows), e * (2 if cast else rows[0].element_size())),
                      dtype=torch.uint8, device="cuda")
    table = array.array("q", [r.data_ptr() for r in rows])
    rc = db_ops._bind(lib, "repro_stage_copy_rows")(
        table.buffer_info()[0], len(rows), out.data_ptr(), out.shape[1],
        int(cast), _stream())
    if rc:
        raise RuntimeError(f"stage_copy_rows: CUDA error {rc}")
    return out


def rmsnorm(lib, x, w):
    y = torch.empty_like(x)
    rc = rms_ops._bind(lib)(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                            x.shape[0], x.shape[1], 1, 2, 1e-6, _stream())
    if rc:
        raise RuntimeError(f"rmsnorm: CUDA error {rc}")
    return y


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout whose two kernel "
                    "sources are timed as variant 'parent'")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    jobs = [("doorbell.cu", "db_" + n, s) for n, s in DOORBELL.items()] + \
        [("rmsnorm.cu", "rm_" + n, s) for n, s in RMSNORM.items()]
    if args.parent:
        csrc = os.path.join(args.parent, "src", "repro_torch", "csrc")
        jobs += [("doorbell.cu", "db_parent", [], csrc),
                 ("rmsnorm.cu", "rm_parent", [], csrc)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(ex.map(lambda j: compile_variant(*j), jobs))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for k, e, dtype, bf16 in ((64, 16384, torch.float32, False),
                              (64, 16384, torch.float32, True),
                              (64, 2048, torch.float32, False),
                              (64, 8, torch.uint8, False)):
        x = (torch.randint(0, 256, (k, e), generator=g, device="cuda",
                           dtype=dtype) if dtype == torch.uint8 else
             torch.randn(k, e, generator=g, device="cuda"))
        n = max(1, min(256, cs.COLD_BYTES // x.nbytes))
        sets = [[r.clone() for r in x] for _ in range(n)]
        stacked = [torch.stack(s) for s in sets]
        lib_call = ((lambda t: t.to(torch.bfloat16)) if bf16 else
                    (lambda t: t.clone()))
        want = stage_copy_ref(x, wire_bf16=bf16)
        rec = {"shape": [k, e], "dtype": str(dtype), "wire_bf16": bf16,
               "library_ms": cs.device_ms(lib_call, stacked),
               "bound_ms": cs.bound_ms(x.nbytes, want.nbytes)}
        for name, lib in libs.items():
            if not name.startswith("db_"):
                continue
            if not torch.equal(dense(lib, x, bf16), want):
                raise AssertionError(f"{name}: dense copy differs")
            rec[name] = {"dense_ms": cs.device_ms(
                lambda t: dense(lib, t, bf16), stacked)}
            if hasattr(lib, "repro_stage_copy_rows"):
                if not torch.equal(gather(lib, list(x), bf16), want):
                    raise AssertionError(f"{name}: gather differs")
                rec[name]["gather_ms"] = cs.device_ms(
                    lambda s: gather(lib, s, bf16), sets)
        rec["library_again_ms"] = cs.device_ms(lib_call, stacked)
        print(json.dumps(rec), flush=True)
    for rows, d in ((8192, 1152), (32768, 256), (8192, 256), (8192, 1024),
                    (8192, 2048), (8192, 1600), (8192, 3200), (4096, 2048),
                    (65536, 128)):
        x = (torch.randn(rows, d, generator=g, device="cuda") * 3).to(
            torch.bfloat16)
        w = torch.randn(d, generator=g, device="cuda").to(torch.bfloat16)
        xs = cs.cold_copies(x)
        ref = F.rms_norm(x.float(), (d,), w.float(), eps=1e-6)
        rec = {"shape": [rows, d],
               "bound_ms": cs.bound_ms(2 * x.nbytes + w.nbytes, 0),
               "library_ms": cs.device_ms(
                   lambda t: F.rms_norm(t, (d,), w, eps=1e-6), xs),
               "clone_ms": cs.device_ms(lambda t: t.clone(), xs)}
        for name, lib in libs.items():
            if name.startswith("rm_"):
                err = float((rmsnorm(lib, x, w).float() - ref).abs().max())
                if err > 2e-2 + 2e-2 * float(ref.abs().max()):
                    raise AssertionError(f"{name}: {rows}x{d} off by {err}")
                rec[name] = cs.device_ms(lambda t: rmsnorm(lib, t, w), xs)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
