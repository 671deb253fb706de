"""A probe of B4's wgmma prefill tile.

    python3 tools/probe_moe_gmm_wgmma.py   # from the repository root, on the card

Builds ``csrc/moe_gmm.cu`` and prints ptxas' report for its kernels.  It
also builds two more libraries with the same C interface: a copy of the
source whose B-operand descriptor has its leading and stride byte
offsets swapped (a check of the MN-major layout the kernel assumes; the
copy must come out wrong), and ``build/moe_gmm_mma.cu`` when that file
holds an earlier version of the kernel to compare with (skipped when it
is missing).  Each is held against the plain version with h rounded to
bf16 at small and olmoe-1b-7b shapes, and the prefill shape x (64, 640,
2048) is timed by CUDA-graph replay beside ``chip_smoke.py``'s ``bmm``
yardstick, with and without ``rows``.
"""
import ctypes, json, os, subprocess, sys, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref, ops
from repro_torch.kernels.moe_gmm.ref import activation_f32
import chip_smoke as cs

t0 = time.perf_counter()
out = _build.build(["moe_gmm"])
print("build s", round(time.perf_counter() - t0, 1), flush=True)
for ln in out["moe_gmm"]["ptxas"].splitlines():
    if "wgmma" in ln or "registers" in ln or "spill" in ln or "arning" in ln:
        print(ln.strip()[:200])
src = open("src/repro_torch/csrc/moe_gmm.cu").read()
swapped = src.replace("smem_desc(sb + kk * 2048, PANEL, 1024)",
                      "smem_desc(sb + kk * 2048, 1024, PANEL)")
assert swapped != src
open("build/moe_gmm_swap.cu", "w").write(swapped)
libs = {}
procs = {}
for name, path in (("swap", "build/moe_gmm_swap.cu"), ("mma", "build/moe_gmm_mma.cu")):
    if not os.path.exists(path):
        continue
    so = f"build/lib{name}.so"
    procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
for name, (so, p) in procs.items():
    log, _ = p.communicate()
    print(name, "nvcc rc", p.returncode, log[-300:] if p.returncode else "")
    if p.returncode == 0:
        libs[name] = ctypes.CDLL(so)

def call(lib, x, w1, w2, act="swiglu", rows=None):
    e, c, d = x.shape; f = w2.shape[1]
    out = torch.empty_like(x)
    h = torch.empty((e, c, f), device=x.device, dtype=torch.bfloat16)
    fn = lib.repro_moe_gmm
    fn.restype = ctypes.c_int
    st = torch.cuda.current_stream().cuda_stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), e, c, d, f, ops._ACT[act], 1, 1, st)
    assert rc == 0, rc
    return out

def oracle(x, w1, w2, act):
    h = activation_f32(act, torch.einsum("ecd,edf->ecf", x.float(), w1.float()))
    return torch.einsum("ecf,efd->ecd", h.to(torch.bfloat16).float(), w2.float()).to(x.dtype)

g = torch.Generator(device="cuda").manual_seed(0)
def inputs(e, c, d, f, act):
    mult = 2 if act in ("swiglu", "geglu") else 1
    x = torch.randn(e, c, d, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(e, d, mult * f, generator=g, device="cuda") * d ** -0.5).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * f ** -0.5).bfloat16()
    return x, w1, w2

for (e, c, d, f) in ((2, 128, 128, 128), (2, 100, 72, 40), (2, 640, 256, 128), (64, 640, 2048, 1024)):
    for act in ("swiglu", "gelu"):
        x, w1, w2 = inputs(e, c, d, f, act)
        ref = oracle(x, w1, w2, act)
        res = {"shape": [e, c, d, f], "act": act}
        for name, fn in (("main", lambda: moe_gmm(x, w1, w2, act=act)),
                         ("swap", lambda: call(libs["swap"], x, w1, w2, act)) if "swap" in libs else (None, None),
                         ("mma", lambda: call(libs["mma"], x, w1, w2, act)) if "mma" in libs else (None, None)):
            if name is None: continue
            o = fn(); torch.cuda.synchronize()
            err = (o.double() - ref.double()).abs()
            res[name] = [float(err.max()), int((err > 3e-2 + 3e-2 * ref.double().abs()).sum())]
        print(json.dumps(res), flush=True)
        del x, w1, w2, ref

E, D, F = 64, 2048, 1024
x, w1, w2 = inputs(E, 640, D, F, "swiglu")
xs = cs.cold_copies(x, limit=4)
lib = cs._library_ffn("swiglu")
rows = torch.full((E,), 509, dtype=torch.int32, device="cuda")
t = {"wgmma": cs.device_ms(lambda a: moe_gmm(a, w1, w2), xs),
     "library": cs.device_ms(lambda a: lib(a, w1, w2), xs)}
if "mma" in libs:
    t["mma"] = cs.device_ms(lambda a: call(libs["mma"], a, w1, w2), xs)
t["wgmma_again"] = cs.device_ms(lambda a: moe_gmm(a, w1, w2), xs)
t["wgmma_rows509"] = cs.device_ms(lambda a: moe_gmm(a, w1, w2, rows=rows), xs)
print(json.dumps({"prefill_ms": t}), flush=True)
