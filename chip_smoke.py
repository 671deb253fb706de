#!/usr/bin/env python3
"""Drive the PyTorch port's fused-doorbell message path on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/`` at first use), holds each kernel against its plain PyTorch
version on the card, then runs the message path end to end through the
entry points a user calls (``LocalCluster`` -> ``Endpoint.post_am_many``
/ ``post_send_many`` -> progress -> completion queues) with CUDA tensor
payloads, at the library's default geometry: 64-row doorbells, eager
messages up to ``eager_max_bytes`` (64 KiB), and a window of 16
doorbells (64 MiB of 64 KiB payloads) in flight before each progress
sweep.

Every phase raises on failure.  Each phase prints one JSON record; the
line before the last is the card's name and power limit, then the
``kernels`` record, and the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device the script exits
non-zero and prints no result.  Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM HBM3 rate (NVIDIA data sheet), for the bandwidth bound
HBM_BYTES_PER_S = 3.35e12
#: bytes of distinct inputs each timing cycles through, so repeated
#: launches do not run out of the 50 MB L2 cache
COLD_BYTES = 96 << 20
SEED = 0
DEVICE = "cuda"
SOURCE = "src/repro_torch/csrc/doorbell.cu"
REPLACES = "src/repro/kernels/doorbell/kernel.py:22"


def record(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def device_ms(fn, inputs, reps: int = 10) -> float:
    """Device time of one call: one CUDA graph captures a call on each
    of ``inputs`` (distinct tensors, so the L2 cache is cold for each),
    and the median CUDA-event time of a replay is divided by the calls
    in it.  Host overhead is left out; :func:`call_ms` includes it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs[:3]:
            fn(x)                                # warm-up, outside capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    del graph
    return statistics.median(times)


def call_ms(fn, inputs, reps: int = 15, inner: int = 10) -> float:
    """Median CUDA-event time of one call, host overhead included: over
    ``reps`` batches of ``inner`` back-to-back calls cycling through
    ``inputs``, after a warm-up."""
    import torch
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    times = []
    j = 0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(inputs[j % len(inputs)])
            j += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_copies(x, limit: int = 256):
    """Distinct copies of ``x`` adding up to about COLD_BYTES."""
    n = max(1, min(limit, math.ceil(COLD_BYTES / max(1, x.nbytes))))
    return [x.clone() for _ in range(n)]


def bound_ms(read: int, written: int) -> float:
    return (read + written) / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def compare(name, out, ref, dtype, cast, nan_ok=False):
    """Hold the kernel's wire rows against the plain version's: equal
    bytes, except that with ``nan_ok`` NaN elements are compared by
    isnan (NaN bit patterns may legitimately differ) and every other
    element bit for bit.  Returns the max abs error of the decoded
    values (0.0 when exact)."""
    import torch
    wd = torch.bfloat16 if cast else dtype
    a, b = out.view(wd), ref.view(wd)
    an, bn = torch.isnan(a.double()), torch.isnan(b.double())
    if nan_ok:
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        exact = torch.equal(an, bn) and torch.equal(
            a.view(bits)[~an], b.view(bits)[~an])
    else:
        exact = torch.equal(out, ref)
    if not exact:
        raise AssertionError(f"{name}: kernel output differs from the "
                             "plain version")
    d = (a.double() - b.double()).abs()[~(an | bn)]
    return float(d.max()) if d.numel() else 0.0


def special_values(k: int, e: int, nan: bool):
    """Subnormals, +-inf, -0.0, the largest finite floats, bf16 rounding
    ties (both directions) and, when ``nan``, NaNs of both signs."""
    import torch
    vals = np.array([1e-40, -1e-40, 1e-45, -1e-45, 1.1754942e-38,
                     np.inf, -np.inf, -0.0, 0.0, 3.4028235e38,
                     -3.4028235e38, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                     -(1.0 + 2.0 ** -8), 65504.0, 2.0 ** -126],
                    np.float32)
    if nan:
        vals = np.concatenate([vals, np.array([np.nan, -np.nan],
                                              np.float32)])
    rng = np.random.default_rng(SEED + 7)
    x = rng.choice(vals, size=(k, e)).astype(np.float32)
    return torch.from_numpy(x).to(DEVICE)


def kernel_phase(torch):
    from repro_torch.core.packet_pool import init_buffers, init_pool
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_push,
                                              stage_copy_push_ref,
                                              stage_copy_ref)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = []

    def dense(label, x, bf16, nan_ok=False):
        cast = bf16 and x.dtype == torch.float32
        out = stage_copy(x, wire_bf16=bf16)
        ref = stage_copy_ref(x, wire_bf16=bf16)
        torch.cuda.synchronize()
        err = compare(label, out, ref, x.dtype, cast, nan_ok)
        xs = cold_copies(x)
        if cast:
            lib = lambda t: t.to(torch.bfloat16).view(torch.uint8)  # noqa
        else:
            lib = lambda t: t.view(torch.uint8).clone()             # noqa
        case = {"case": label, "wrapper": "stage_copy",
                "shape": list(x.shape), "dtype": str(x.dtype).split(".")[1],
                "wire_bf16": bf16, "ok": True, "byte_exact": not nan_ok,
                "max_abs_err": err,
                "kernel_ms": device_ms(
                    lambda t: stage_copy(t, wire_bf16=bf16), xs),
                "plain_ms": device_ms(
                    lambda t: stage_copy_ref(t, wire_bf16=bf16), xs),
                "library_ms": device_ms(lib, xs),
                "kernel_call_ms": call_ms(
                    lambda t: stage_copy(t, wire_bf16=bf16), xs),
                "bound_ms": bound_ms(x.nbytes, out.nbytes)}
        cases.append(case)
        return case

    for k, e in ((64, 2), (64, 2048), (64, 16384)):
        x = torch.randn(k, e, generator=g, device=DEVICE)
        for bf16 in (False, True):
            dense(f"f32_{k}x{e}_bf16{int(bf16)}", x, bf16)
    x = torch.randint(0, 256, (64, 8), generator=g, device=DEVICE,
                      dtype=torch.uint8)
    dense("u8_64x8", x, False)
    # byte tails: the staged image is not a multiple of 16 bytes
    x = torch.randint(0, 256, (63, 8), generator=g, device=DEVICE,
                      dtype=torch.uint8)
    dense("u8_63x8_tail", x, False)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (63, 1027), generator=g,
                      device=DEVICE, dtype=torch.int32)
    dense("i32_63x1027_tail", x, False)
    x = torch.randn(63, 1027, generator=g, device=DEVICE)
    dense("f32_63x1027_tail_bf16", x, True)
    for bf16 in (False, True):
        dense(f"special_64x2048_bf16{int(bf16)}",
              special_values(64, 2048, nan=False), bf16)
    dense("nan_64x2048_bf16", special_values(64, 2048, nan=True), True,
          nan_ok=True)

    # stage_copy_push on a device SlotPool and packet table: a full grab,
    # then a short grab (lane 0 empty, one steal of half of lane 1)
    # (4108-byte rows: a byte tail, then zero fill from an odd offset)
    for e, bf16 in ((16384, False), (16384, True), (2048, True),
                    (1027, False)):
        x = torch.randn(64, e, generator=g, device=DEVICE)
        cast = bf16
        pool = init_pool(2, 64, device=DEVICE)
        buf = init_buffers(128, 65536, device=DEVICE)
        buf.random_(0, 256, generator=g)       # untouched rows must stay
        got_all = []
        kbuf, pbuf = buf.clone(), buf.clone()
        kpool = ppool = pool
        for grab in ("full", "short"):
            kpool, kbuf, kids, kgot, kst = stage_copy_push(
                kpool, kbuf, 0, x, 1, wire_bf16=bf16)
            ppool, pbuf, pids, pgot, pst = stage_copy_push_ref(
                ppool, pbuf, 0, x, 1, wire_bf16=bf16)
            torch.cuda.synchronize()
            same = (torch.equal(kbuf, pbuf) and torch.equal(kids, pids)
                    and torch.equal(kpool.slots, ppool.slots)
                    and torch.equal(kpool.count, ppool.count)
                    and int(kgot) == int(pgot) and int(kst) == int(pst))
            if not same:
                raise AssertionError(f"stage_copy_push {grab} e={e} "
                                     f"bf16={bf16}: kernel differs")
            got_all.append(int(kgot))
        if got_all != [64, 32]:
            raise AssertionError(f"stage_copy_push grabs {got_all}")
        # timing: one full grab from a fresh pool per call, host overhead
        # included (the plain version's mask indexing syncs, so neither
        # is captured in a graph)
        row_bytes = e * (2 if cast else 4)
        xs = cold_copies(x, limit=16)
        tbuf = init_buffers(128, 65536, device=DEVICE)
        fresh = init_pool(2, 64, device=DEVICE)
        cases.append({
            "case": f"push_64x{e}_bf16{int(bf16)}",
            "wrapper": "stage_copy_push", "shape": [64, e],
            "dtype": "float32", "wire_bf16": bf16, "ok": True,
            "byte_exact": True, "grabs": got_all, "max_abs_err": 0.0,
            "kernel_call_ms": call_ms(lambda t: stage_copy_push(
                fresh, tbuf, 0, t, 1, wire_bf16=bf16), xs),
            "plain_call_ms": call_ms(lambda t: stage_copy_push_ref(
                fresh, tbuf, 0, t, 1, wire_bf16=bf16), xs),
            "library_ms": None,
            "bound_ms": bound_ms(x.nbytes, 64 * 65536),
            "payload_bytes_written": 64 * row_bytes})
    return cases


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

K = 64                  # rows per doorbell (worker_burst default)
WINDOW = 16             # doorbells in flight before each progress sweep
WINDOWS = 6


def _post_all(post, progress, bufs, tags):
    """Post one doorbell, re-posting a retried suffix after progress;
    returns the number of doorbells that staged at least one row."""
    rung = 0
    while bufs:
        sts = post(bufs, tags)
        ok = sum(1 for s in sts if not s.is_retry())
        rung += bool(ok)
        bufs, tags = bufs[ok:], tags[ok:]
        if bufs:
            progress()
    return rung


def main_path_case(torch, label, kind, dtype, nbytes, wire_bf16):
    from repro_torch.core import LocalCluster
    from repro_torch.kernels.doorbell import stage_copy, stage_copy_ref
    cl = LocalCluster(2, device=DEVICE,
                      attrs={"wire_bf16": True} if wire_bf16 else None)
    ep0, ep1 = cl.alloc_endpoint(n_devices=4, stripe="round_robin",
                                 name=label)
    free0 = [rt.get_attr("free_packets") for rt in cl.runtimes]
    cq = cl[1].alloc_cq()
    rcomp = cl[1].register_rcomp(cq)
    e = nbytes // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    per_window = K * WINDOW

    def progress():
        while ep0.progress() + ep1.progress():
            pass

    if kind == "am":
        def post(bufs, tags):
            return ep0.post_am_many(1, bufs, rcomp, tags=tags)
    else:
        def post(bufs, tags):
            return ep0.post_send_many(1, bufs, tags=tags)

    launches0 = stage_copy.launches
    doorbells = delivered = 0
    elapsed = 0.0
    split = {"post_s": 0.0, "progress_s": 0.0, "pop_s": 0.0}
    for w in range(WINDOWS):
        if dtype == torch.uint8:
            src = torch.randint(0, 256, (per_window, e), generator=g,
                                device=DEVICE, dtype=dtype)
        else:
            src = torch.randn(per_window, e, generator=g, device=DEVICE)
        rows = list(src)                     # one tensor per message
        tags = list(range(w * per_window, (w + 1) * per_window))
        rbuf = None
        if kind == "send":
            rbuf = torch.zeros_like(src)
            for i, t in enumerate(tags):      # pre-posted CUDA recv bufs
                st = ep1.post_recv(0, rbuf[i], nbytes, tag=t, local_comp=cq)
                if st.is_retry():
                    raise AssertionError(f"{label}: recv post retried")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in range(WINDOW):
            sl = slice(d * K, (d + 1) * K)
            doorbells += _post_all(post, progress, rows[sl], tags[sl])
        t1 = time.perf_counter()
        progress()
        t2 = time.perf_counter()
        got = []
        while True:
            st = cq.pop()
            if st.is_retry():
                break
            got.append(st)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        elapsed += t3 - t0
        split["post_s"] += t1 - t0
        split["progress_s"] += t2 - t1
        split["pop_s"] += t3 - t2
        # checks (outside the timed region)
        seen = sorted(st.tag for st in got)
        if seen != tags:
            lost = len(set(tags) - set(seen))
            raise AssertionError(f"{label} window {w}: {len(got)} "
                                 f"completions, {lost} lost, "
                                 f"{len(seen) - len(set(seen))} duplicated")
        delivered += len(got)
        want = src.view(torch.uint8).reshape(per_window, -1)
        if wire_bf16:
            want = (stage_copy_ref(src, wire_bf16=True).view(torch.bfloat16)
                    .float().view(torch.uint8))
        if kind == "am":
            by_tag = {st.tag: st.get_buffer() for st in got}
            have = torch.stack([by_tag[t] for t in tags])
        else:
            have = rbuf.view(torch.uint8).reshape(per_window, -1)
        if not torch.equal(have, want):
            raise AssertionError(f"{label} window {w}: delivered bytes "
                                 "differ from the source")
    progress()
    cl.quiesce()
    free1 = [rt.get_attr("free_packets") for rt in cl.runtimes]
    if free1 != free0:
        raise AssertionError(f"{label}: packets leaked {free0} -> {free1}")
    launches = stage_copy.launches - launches0
    if launches != doorbells:
        raise AssertionError(f"{label}: {launches} kernel launches for "
                             f"{doorbells} fused doorbells")
    n = WINDOWS * per_window
    return {"case": label, "posted_with": f"post_{kind}_many",
            "payload": f"{str(dtype).split('.')[1]} {nbytes} B",
            "wire_bf16": wire_bf16, "messages": n, "delivered": delivered,
            "lost": 0, "duplicated": 0, "leaked_packets": 0,
            "doorbells": doorbells, "kernel_launches": launches,
            "launches_per_doorbell": launches / doorbells,
            "byte_exact": True,
            "us_per_msg": elapsed / n * 1e6,
            "GB_per_s": n * nbytes / elapsed / 1e9,
            "host_split_s": split, "elapsed_s": elapsed,
            "window_payload_MiB": per_window * nbytes / 2 ** 20}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.doorbell import stage_copy, stage_copy_push

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    record("device", card=card, torch=torch.__version__,
           cuda=torch.version.cuda, python=sys.version.split()[0],
           name=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    record("build", seconds=time.perf_counter() - t0,
           built=sorted(built), libraries=[
               os.path.relpath(_build.library_path(n), ROOT)
               for n in _build.SOURCES],
           ptxas={n: [ln.strip() for ln in b["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]
                  for n, b in built.items()})

    # 3. every kernel against its plain version
    cases = kernel_phase(torch)
    record("kernel_cases", cases=cases)

    # 4. the main path: counts set to 0 just before, read just after
    stage_copy.launches = stage_copy_push.launches = 0
    runs = [main_path_case(torch, "a", "am", torch.float32, 65536, False),
            main_path_case(torch, "b", "am", torch.float32, 65536, True),
            main_path_case(torch, "c", "send", torch.float32, 8192, False),
            main_path_case(torch, "d", "am", torch.uint8, 8, False)]
    launches = stage_copy.launches + stage_copy_push.launches
    for r in runs:
        record("main_path", **r)
    if launches == 0:
        raise AssertionError("the main path launched no doorbell kernel")

    # the kernel entry: headline numbers at case a's doorbell shape
    head = next(c for c in cases if c["case"] == "f32_64x16384_bf160")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "doorbell.stage_copy", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": head["library_ms"], "shape": head["shape"],
        "call_ms": head["kernel_call_ms"],
        "cases": [{k: c.get(k) for k in (
            "case", "wrapper", "ok", "byte_exact", "kernel_ms", "plain_ms",
            "library_ms", "kernel_call_ms", "plain_call_ms", "bound_ms")}
            for c in cases]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
