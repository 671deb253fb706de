"""Ablations of B5's tensor-core variant, each stage timed on its own.

    python3 tools/probe_ssd_scan.py [--only NAME,...]   # on the card,
                                                         # from the repo root

Compiles copies of ``csrc/ssd_scan.cu`` with one piece of work switched
off by a text swap (stage 3's C.B^T loads, exps, C . H_in or M . x
products, tile loads or y stores; stage 1's hi/lo split, S product, tile
loads or C.B^T; the dt loads of both) or a launch setting changed (the
shared-memory carveout) into
``build/variants/``, all nvcc runs started together, and prints each
variant's registers and spills.  Then, at mamba2-370m's and hymba-1.5b's
bf16 prefill shapes, it times every variant's three kernels by
torch.profiler over calls cycling through inputs larger than the L2
cache, and the whole call by ``chip_smoke.py``'s CUDA-graph timing.  An
ablation computes a wrong result on purpose: only variant ``A`` (the
source as it stands) is checked, against the plain version of its
rounding.  The stage a piece of work lives in loses about the time that
work costs.
"""
import argparse
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
from repro_torch.kernels.ssd_scan import ops     # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_tc_ref  # noqa: E402

OUT = os.path.join(_build.BUILD, "variants")

VARIANTS = {
    "A_as_is": [],
    "B_no_cb_loads": [(
        "    cbv[i] = __ldg(reinterpret_cast<const float4*>(\n"
        "        cbb + (mt * 16 + (q >> 2)) * kL + jt * 16 + (q & 3) * 4));",
        "    cbv[i] = make_float4(float(mt), float(jt), 1.f, 1.f);")],
    "C_no_m_exp": [("v[k] * expf(cl - cum[j + k]) * dts[j + k]",
                    "v[k] * dts[j + k]")],
    "D_no_ch": [("  for (int kk = 0; kk < N / 16; ++kk) {\n"
                 "    uint32_t a[4];\n    frag_a(a, sC, ld(N)",
                 "  for (int kk = 0; kk < 0; ++kk) {\n"
                 "    uint32_t a[4];\n    frag_a(a, sC, ld(N)")],
    "E_no_mx": [("  for (int kk = 0; kk <= warp; ++kk) {",
                 "  for (int kk = 0; kk < 0; ++kk) {")],
    "F_no_hilo": [("  for (int j = rw.r0; j < kL && rw.k < rw.chunks; ",
                   "  for (int j = rw.r0; j < 0 && rw.k < rw.chunks; ")],
    "G_no_stage1_cb": [("  if (hi % r != 0) return;", "  return;")],
    "H_no_dt_loads": [("dts[tid] = tid < lc ? dtb[(t0 + tid) * sdt] : 0.f;",
                       "dts[tid] = tid < lc ? 0.5f : 0.f;")],
    "J_no_y_stores": [("  for (int l = rw.r0; l < lc && rw.k < rw.chunks; ",
                       "  for (int l = rw.r0; l < lc && D == 1234.5f; ")],
    "K_no_stage3_tile_loads": [
        ("  load_tile(sX, kL, P, x + bi",
         "  if (D_SKIP_LOADS) load_tile(sX, kL, P, x + bi"),
        ("  load_tile(sC, kL, N, cm + bi * st.c[0] + gi * st.c[1], st.c[2], "
         "t0, lc);\n  load_tile(sH,",
         "  if (D_SKIP_LOADS) load_tile(sC, kL, N, cm + bi * st.c[0] + gi * "
         "st.c[1], st.c[2], t0, lc);\n  if (D_SKIP_LOADS) load_tile(sH,"),
        ("namespace tc {", "#define D_SKIP_LOADS (S < 0)\nnamespace tc {")],
    "L_no_stage1_mma": [("  for (int u = warp; u < (N / 16) * split; "
                         "u += kWarps) {",
                         "  for (int u = warp; u < 0; u += kWarps) {")],
    "M_no_stage1_tile_loads": [
        ("  load_tile(sHi, kL, P,", "  if (S < 0) load_tile(sHi, kL, P,"),
        ("  load_tile(sB, kL, N,", "  if (S < 0) load_tile(sB, kL, N,")],
    "I_carveout_max": [
        ("    auto k1 = ssd_scan_chunk_kernel<NT>;",
         "    auto k1 = ssd_scan_chunk_kernel<NT>;\n"
         "    cudaFuncSetAttribute(k1, "
         "cudaFuncAttributePreferredSharedMemoryCarveout, 100);"),
        ("  auto k3 = ssd_scan_out_kernel<NT>;",
         "  auto k3 = ssd_scan_out_kernel<NT>;\n"
         "  cudaFuncSetAttribute(k3, "
         "cudaFuncAttributePreferredSharedMemoryCarveout, 100);")],
}
SHAPES = {"mamba2": (4, 32, 2048, 64, 1, 128), "hymba": (4, 50, 2048, 64, 1,
                                                          16)}


def compile_variant(name, subs):
    text = open(os.path.join(_build.CSRC, "ssd_scan.cu")).read()
    for a, b in subs:
        if a not in text:
            raise ValueError(f"{name}: {a!r} is not in ssd_scan.cu")
        text = text.replace(a, b)
    path = os.path.join(OUT, name + ".cu")
    lib = os.path.join(OUT, f"lib{name}.so")
    with open(path, "w") as f:
        f.write(text)
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
    return name, lib, cs.ptxas_report(p.stdout + p.stderr)


def bind(lib):
    import ctypes
    fn = ctypes.CDLL(lib).repro_ssd_scan_tc
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int64] * 7 +
                   [ctypes.c_void_p, ctypes.c_void_p])
    return fn


def inputs(shape, gen):
    bs, h, s, p, g, n = shape
    dev = "cuda"
    x = torch.randn(bs, h, s, p, generator=gen, device=dev).bfloat16()
    dt = F.softplus(torch.randn(bs, h, s, generator=gen, device=dev))
    a_log = torch.randn(h, generator=gen, device=dev) * 0.5
    b = (torch.randn(bs, g, s, n, generator=gen, device=dev) * 0.3).bfloat16()
    c = (torch.randn(bs, g, s, n, generator=gen, device=dev) * 0.3).bfloat16()
    d = torch.randn(h, generator=gen, device=dev)
    return x, dt, a_log, b, c, d


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    names = [n for n in VARIANTS if not args.only or n in args.only.split(",")]
    os.makedirs(OUT, exist_ok=True)
    _build.build(["ssd_scan"])
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda n: compile_variant(n, VARIANTS[n]),
                              names))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "ptxas": {
        n: [(k["kernel"][-40:], k["registers"], k["spill_stores"])
            for k in rep if "ssd_scan_" in k["kernel"] and
            "ssd_scan_kernel" not in k["kernel"]]
        for n, _, rep in built}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    real = ops._tc_kernel
    rows = []
    for label, shape in SHAPES.items():
        x, dt, a_log, b, c, d = inputs(shape, gen)
        sets = cs.cold_sets((x, dt, b, c))
        want_y, want_h = ssd_scan_tc_ref(x, dt, a_log, b, c, d)
        for name, lib, _ in built:
            fn = bind(lib)
            ops._tc_kernel = lambda fn=fn: fn
            try:
                y, h_final = ops.ssd_scan_bhsp(x, dt, a_log, b, c, d)
                if name == "A_as_is":
                    cs._close(f"{label} {name} y", y, want_y, torch.bfloat16,
                              cs.SSD_TC_Y_ATOL, cs.SSD_TC_Y_RTOL)
                    cs._close(f"{label} {name} h_final", h_final, want_h,
                              torch.float32, cs.SSD_TC_H_TOL,
                              cs.SSD_TC_H_TOL)

                def call(t):
                    return ops.ssd_scan_bhsp(t[0], t[1], a_log, t[2], t[3], d)
                ms = cs.device_ms(call, sets)
                st = cs.ssd_stages(torch, call, sets)
            finally:
                ops._tc_kernel = real
            row = {"shape": label, "variant": name, "ms": ms,
                   "stages_ms": {k: v["device_ms_per_call"]
                                 for k, v in st.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()
    for r in rows:
        print(f"{r['shape']:7s} {r['variant']:16s} {r['ms'] * 1e3:8.1f} us  " +
              "  ".join(f"{k.split('_')[2]} {v * 1e3:7.1f}"
                        for k, v in sorted(r["stages_ms"].items())))


if __name__ == "__main__":
    main()
