"""A short probe of B4's bf16 tensor-core variant at olmoe-1b-7b's shapes.

    python3 tools/probe_moe_gmm.py      # from the repository root, on the card

Builds ``csrc/moe_gmm.cu`` alone and prints ptxas' register and spill
report, then for capacities 8, 16, 640 and 100 (64 experts, d 2048,
f 1024, swiglu) holds the kernel against its plain version (3e-2) and
times it and ``chip_smoke.py``'s ``bmm`` yardstick by CUDA-graph replay.
A quicker check than ``chip_smoke.py`` after a change to the kernel.
"""
import json, os, sys, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
from repro_torch.kernels import _build
t0 = time.perf_counter()
out = _build.build(["moe_gmm"])
print("build s", time.perf_counter() - t0, flush=True)
for n, b in out.items():
    for ln in b["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(ln.strip())
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
import chip_smoke as cs
g = torch.Generator(device="cuda").manual_seed(0)
E, D, F = 64, 2048, 1024
for c in (8, 16, 640, 100):
    for dtype in (torch.bfloat16,):
        x = torch.randn(E, c, D, generator=g, device="cuda").to(dtype)
        w1 = (torch.randn(E, D, 2 * F, generator=g, device="cuda") * D ** -0.5).to(dtype)
        w2 = (torch.randn(E, F, D, generator=g, device="cuda") * F ** -0.5).to(dtype)
        o = moe_gmm(x, w1, w2)
        r = moe_gmm_ref(x, w1, w2)
        torch.cuda.synchronize()
        err = (o.double() - r.double()).abs()
        bad = (err > 3e-2 + 3e-2 * r.double().abs()).sum().item()
        print(json.dumps({"C": c, "variant": moe_gmm.launches_by_variant, "max_err": err.max().item(), "bad": bad,
                          "finite": bool(torch.isfinite(o.float()).all())}), flush=True)
        xs = cs.cold_copies(x, limit=4)
        lib = cs._library_ffn("swiglu")
        k = cs.device_ms(lambda t: moe_gmm(t, w1, w2), xs)
        l = cs.device_ms(lambda t: lib(t, w1, w2), xs)
        print(json.dumps({"C": c, "kernel_ms": k, "library_ms": l}), flush=True)
        del x, w1, w2, o, r, xs
        torch.cuda.empty_cache()
