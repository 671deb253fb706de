"""A probe of B2's tensor-core ("tc") variant.

    python3 tools/probe_flash_wgmma.py   # from the repository root, on a card

Builds ``csrc/flash_attention.cu`` and prints ptxas' report for the tc
kernels (registers, spills, wgmma serialisation).  It also builds two
copies of the source with the same C interface, each with one deliberate
fault, which must come out wrong where the kernel comes out right:

* ``swap``: V's shared-memory descriptor with its leading and stride
  byte offsets swapped (a check of the MN-major layout that O += P V
  assumes, tnspB = 1);
* ``frag``: the bf16 P fragment built from the S accumulator with its
  two k8 halves swapped (a check that the f32 S fragment of a k16 slice
  is, pair by pair, the register A fragment of that slice).

Each library is held against the plain version with P rounded to bf16
(``flash_attention_ref(..., p_dtype=torch.bfloat16)``) at chip_smoke's
limit for it (``TC_ATOL + TC_RTOL |ref|``) at dh 64, 128 and 256 (BK 128,
128 and 64), GQA 1, 4 and 5, causal, window, ragged and no-key-row cases.
A case prints its max abs error, the count of elements beyond the limit
and the largest share of the limit an element uses.  Each broken copy
runs in a child process of its own (``--lib NAME``), since a fault ends
the process's CUDA context.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import ctypes  # noqa: E402

import torch  # noqa: E402

from chip_smoke import TC_ATOL, TC_RTOL  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bhsd, flash_attention_ref, ops, variant_of)

MUTANTS = {
    "swap": ("smem_desc(vs + kk * 2048, C::KV_PANEL, 1024)",
             "smem_desc(vs + kk * 2048, 1024, C::KV_PANEL)"),
    "frag": ("pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1])",
             "pack_bf16(sc[8 * kk + 2 * (j ^ 2)], "
             "sc[8 * kk + 2 * (j ^ 2) + 1])"),
}
CASES = [  # b, hq, hkv, sq, skv, dh, causal, window, q_offset
    (2, 4, 4, 256, 256, 64, True, 0, 0),
    (2, 8, 2, 200, 200, 128, True, 0, 0),
    (2, 5, 1, 300, 300, 256, True, 0, 0),
    (1, 10, 2, 129, 129, 64, True, 65, 0),
    (1, 4, 1, 1000, 1000, 256, True, 512, 0),
    (1, 16, 16, 1000, 1000, 128, True, 0, 0),
    (1, 4, 1, 256, 128, 256, True, 64, 100),    # rows that see no key
    (1, 2, 2, 65, 127, 128, False, 0, 0),
    (1, 2, 1, 1, 63, 64, True, 0, 62),
]
g = torch.Generator(device="cuda").manual_seed(0)


def inputs(b, hq, hkv, sq, skv, dh):
    return tuple(torch.randn(shape, generator=g, device="cuda").bfloat16()
                 for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                               (b, hkv, skv, dh)))


def err(o, ref):
    """[max abs error, elements beyond the limit, largest share of the
    limit, all finite]"""
    d = (o.double() - ref.double()).abs()
    limit = TC_ATOL + TC_RTOL * ref.double().abs()
    return [float(d.max()), int((d > limit).sum()), float((d / limit).max()),
            bool(torch.isfinite(o).all())]


def mutant_call(lib, q, k, v, kw):
    fn = lib.repro_flash_attention_tc
    fn.restype = ctypes.c_int
    fn.argtypes = ops._tc_kernel().argtypes
    o = torch.empty_like(q)
    rc = fn(q.data_ptr(), ops._geom(ops.tma_geometry(q)), k.data_ptr(),
            ops._geom(ops.tma_geometry(k)), v.data_ptr(),
            ops._geom(ops.tma_geometry(v)), o.data_ptr(),
            ops._geom(o.stride()[:3]), int(kw["causal"]), int(kw["window"]),
            int(kw["q_offset"]), q.shape[-1] ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return o


def run_cases(lib=None):
    for case in CASES:
        b, hq, hkv, sq, skv, dh, causal, window, qo = case
        q, k, v = inputs(b, hq, hkv, sq, skv, dh)
        kw = dict(causal=causal, window=window, q_offset=qo)
        ref = flash_attention_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
        if lib is not None:
            try:
                o = mutant_call(lib, q, k, v, kw)
                res = err(o, ref)
            except Exception as e:            # a fault ends the context
                print(json.dumps({"case": list(case), "fault": str(e)[:80]}))
                return
            print(json.dumps({"case": list(case), "err": res}), flush=True)
            continue
        ref32 = flash_attention_ref(q, k, v, **kw)
        o, ran = variant_of(lambda: flash_attention_bhsd(q, k, v, **kw))
        torch.cuda.synchronize()
        print(json.dumps({"case": list(case), "variant": ran,
                          "tc": err(o, ref), "tc_vs_f32_p": err(o, ref32)}),
              flush=True)


if len(sys.argv) == 3 and sys.argv[1] == "--lib":
    run_cases(ctypes.CDLL(os.path.join(_build.BUILD,
                                       f"libflash_{sys.argv[2]}.so")))
    sys.exit(0)

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
src = open("src/repro_torch/csrc/flash_attention.cu").read()
os.makedirs(_build.BUILD, exist_ok=True)
sources = {}
for name, (a, b) in MUTANTS.items():
    assert src.count(a) == 1, name
    sources[name] = os.path.join(_build.BUILD, f"flash_{name}.cu")
    with open(sources[name], "w") as f:
        f.write(src.replace(a, b))
procs = {name: subprocess.Popen(
    [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
     os.path.join(_build.BUILD, f"libflash_{name}.so"), path],
    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, path in sources.items()}
t0 = time.perf_counter()
out = _build.build(["flash_attention"])
print("build s", round(time.perf_counter() - t0, 1), flush=True)
for ln in out.get("flash_attention", {}).get("ptxas", "").splitlines():
    if "tc_kernel" in ln or "registers" in ln or "spill" in ln or \
            "wgmma" in ln or "arning" in ln or "setmaxnreg" in ln:
        print(ln.strip()[:220])
run_cases()
for name, p in procs.items():
    log, _ = p.communicate()
    print(name, "nvcc rc", p.returncode, log[-400:] if p.returncode else "",
          flush=True)
    if p.returncode == 0:
        r = subprocess.run([sys.executable, __file__, "--lib", name],
                           capture_output=True, text=True, timeout=300)
        print(name, r.stdout, r.stderr[-300:], flush=True)
