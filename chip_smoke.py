#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one GPU: the fused-doorbell
message path (over the sim, shm and socket transports, under chaos and
across two processes), gemma3-1b serving, olmoe-1b-7b (MoE) serving,
mamba2-370m (SSM) serving and hymba-1.5b (hybrid) serving at full width.

    python3 chip_smoke.py            # from the repository root; one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown
                                     # and the float32 -> bf16 casts of
                                     # a prefill by call site

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/`` at first use, one ``nvcc`` per source, all started together),
holds each kernel against its plain PyTorch version on the card, then
runs each main path end to end through the entry points a user calls.
The phases:

1. the card's name, power limit and software versions;
2. the build, with ptxas' register and spill report (no B1 or B3
   kernel and no tensor-core B2 or B5 kernel may spill);
3. the doorbell stage copy (B1) against its plain version, byte for
   byte: the dense ``stage_copy`` of a (K, E) tensor, the gather
   ``stage_copy_rows`` of K row tensors (the main path's call; rows in
   their own allocations, at odd byte offsets, 8-byte rows, 257 rows in
   two launches, NaN under ``wire_bf16``) and ``stage_copy_push``; at the
   main path's doorbells ((64, 16384) f32 with ``wire_bf16`` off and on,
   (64, 2048) f32, (64, 8) u8) the gather is timed beside today's pair
   (``torch.stack`` + the dense kernel), the dense kernel alone, the
   library call (``clone``, or ``to(torch.bfloat16)``) and the bound;
4. the message path (``LocalCluster`` -> ``Endpoint.post_am_many`` /
   ``post_send_many`` -> progress -> completion queues) with CUDA tensor
   payloads, at the library's default geometry: 64-row doorbells, eager
   messages up to ``eager_max_bytes`` (64 KiB), and a window of 16
   doorbells in flight before each progress sweep; every fused doorbell
   is one ``stage_copy_rows`` launch, with no dense stage copy and no
   ``torch.stack``;
5. flash attention (B2) and RMSNorm (B3) against their plain versions:
   the sweeps of ``tests/test_kernels.py``, gemma3-1b's prefill shapes
   (window 512 and global, bf16 and float32), a ragged s = 1000, a q
   offset whose later rows see no key, and the serving path's RMSNorm
   shapes (gemma3's norms at 8192 x 1152, its q/k norms at 32768 and
   8192 x 256, olmoe's at 4096 x 2048 and 65536 x 128, each timed beside
   ``F.rms_norm``, a ``clone`` of x and the bound); each B2 case reports
   the variant it launched (bf16 at dh
   64/128/256: "tc", the tensor cores; float32 and dh 16/32: "simt"), and
   a "tc" case is also held against the plain version with P rounded to
   bf16, as the variant computes it, at the tighter 4e-3 + 8e-3 |ref|;
   the seq-major wrapper that the model path calls, on (s, b, h, dh)
   operands, must give bitwise the kernel layout's output; each timed
   case times both wrappers (``kernel_ms`` is the seq-major call), the
   plain version and one PyTorch call (``F.scaled_dot_product_attention`` with
   an explicit mask, and for a plain causal mask also with
   ``is_causal=True``; ``F.rms_norm``) as a yardstick;
6. gemma3-1b's full config in float32 with seeded random weights:
   teacher-forced ``make_serve_step`` over 32 positions agrees with
   ``forward``'s greedy tokens on more than 0.95 of them, and
   ``make_prefill_step``'s token equals forward's last position;
7. gemma3-1b's full config in bf16: ``make_prefill_step`` on 4 prompts of
   2048 tokens (exactly 26 flash-attention launches a call, every one
   on the "tc" variant, and 105 RMSNorm launches), then the serve
   launcher's loop (``ServeScheduler`` + ``make_serve_step``, 16 requests
   of 8-token prompts, 16 new tokens each, 8 slots, a 256-position cache;
   105 RMSNorm launches a step);
8. the MoE grouped matmul (B4) against its plain version: the sweep of
   ``tests/test_kernels.py`` (4 activations x 2 shapes x f32/bf16),
   olmoe-1b-7b's decode shape (64 experts x 8 slots) and prefill shape (64
   x 640) at d 2048, f 1024 in both variants (bf16: the tensor cores,
   float32: the CUDA cores; each case asserts the variant it launched), the
   tensor-core tiles' edges (C = 1, 9, 16, 17, 63, 65), a ragged capacity
   and an all-zero expert; ``rows`` (each expert's filled slots) at the
   decode and prefill shapes, bitwise equal to the call without it on
   inputs zeroed past each fill; a served-path decode case whose operands
   and ``rows`` come from ``moe_block``'s routing of 8 tokens; each timed
   case also times the plain version and one PyTorch yardstick
   (``torch.bmm`` -> activation -> ``torch.bmm``, which rounds h to x's
   dtype); flash attention at olmoe's prefill shape (dh 128) and at a
   padded head dim (24);
9. olmoe-1b-7b's full config in float32 (seeded random weights): decode
   against forward as in phase 6, gated at a capacity where forward
   drops nothing, and reported (agreement, forward's dropped fraction) at
   the config's own capacity factor 1.25;
10. olmoe-1b-7b's full config in bf16: ``make_prefill_step`` on 4 prompts
   of 1024 tokens (exactly 16 flash-attention, 65 RMSNorm and 16 MoE
   grouped-matmul launches a call, every B2 and B4 one on its
   tensor-core variant),
   then the serve launcher's loop as in phase 7 (65 RMSNorm and 16
   tensor-core grouped-matmul launches a step), with the experts' mean
   fill and the share of empty experts at prefill and decode;
11. the SSD scan (B5) against its plain recurrence: the cases of
   ``tests/test_kernels.py::test_ssd_sweep`` (float32 and bf16),
   mamba2-370m's prefill shape (x (4, 32, 2048, 64), N 128) and
   hymba-1.5b's (x (4, 50, 2048, 64), N 16) in bf16 and float32, a ragged
   s = 1000 with an initial state in and the final state out, s = 1, and
   a large dt (exp(cum) underflows) in float32 and bf16; each case
   reports the variant it launched (bf16 with P and N multiples of 16:
   "tc", the chunk-parallel stages on the tensor cores; otherwise
   "simt"), and a "tc" case is also held against the plain version of
   its own rounding (``ssd_scan_tc_ref``) at the tighter 4e-2 + 1e-2
   |ref| (y) and 1e-4 (the final state); at the two prefill shapes in
   bf16 it records the chunk length, the scratch bytes and each stage's
   launches and device time (torch.profiler), one launch of each of the
   three stages a call or it fails; each timed case also times the
   chunked plain version (``models/ssm.py::ssd_chunked``; no single
   PyTorch call computes the scan); flash attention (B2) at hymba's
   prefill shape (GQA 25:5, dh 64, window 1024 and global) and RMSNorm
   (B3) at the two models' shapes (mamba2 8192 x 1024 and its gated norm
   8192 x 2048, hymba 8192 x 1600 and its gated norm 8192 x 3200);
12. mamba2-370m's full config in float32 (seeded random weights): decode
   against forward as in phase 6;
13. mamba2-370m's full config in bf16: ``make_prefill_step`` on 4 prompts
   of 2048 tokens (exactly 48 SSD-scan launches a call, every one on the
   "tc" variant, and 97 RMSNorm launches:
   norm1 and the gated norm a layer, plus the final norm), then the serve
   launcher's loop as in phase 7 (97 RMSNorm and no SSD-scan launch a
   step);
14. hymba-1.5b's full config in bf16: prefill of 4 x 2048 tokens (exactly
   32 flash-attention and 32 SSD-scan launches, all "tc", and 161
   RMSNorm launches a call: norm1,
   the gated norm, the two mix norms and norm2 a layer, plus the final
   norm), then the same launcher loop (161 RMSNorm launches a step);
15. the message path over the ``shm`` and ``socket`` transports: a)
   phase 4's cases a-d on ``LocalCluster(2, device="cuda",
   fabric_backend=...)``, 2 windows each, every row byte-exact, nothing
   lost, duplicated or leaked, one gather a fused doorbell, exactly one
   copy to the host a frame that carries a CUDA image (counted by
   ``transport/wire.py::to_host`` against the frames the transports
   encode) and, for sends into pre-posted CUDA recv buffers, one copy
   back a frame (an AM arrives as host bytes); ``us_per_msg`` and GB/s
   beside phase 4's ``sim`` numbers; b) ``reliability="on"`` under the
   reference's chaos faults (5% drop, dup, reorder) on ``sim`` and
   ``shm``, one device stream, every tag once and in order, byte-exact,
   retransmits recorded (each one a copy to the host again); c) two OS
   processes on the one card through the port's SPMD launcher, on
   ``shm`` and on ``socket``: each rank (this script with
   ``--spmd-rank``) posts fused doorbells of CUDA rows to its neighbour,
   AMs and then sends into its pre-posted CUDA recv buffers, checks every
   byte it receives and reports its counts; then the launcher's
   chaos-kill demo with a 5 s heartbeat timeout, whose survivor must
   drain every outstanding post as ERR_PEER_DEAD and exit 0.  Every child
   runs under a wall-clock limit.

The launch counts are set to 0 just before phases 4, 7, 10, 13, 14 and
15 and read just after; the serving phases also record B3's launches by (rows,
d) a prefill call and a decode step.  Every phase raises on failure;
nothing is caught.  Each phase
prints one JSON record; the line before the last is the card's name and
power limit, then the ``kernels`` record, and the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device the script exits
non-zero and prints no result.  Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import re
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


def ptxas_report(log: str) -> list:
    """Each kernel's registers and spill bytes from nvcc's -Xptxas -v
    output, by mangled name."""
    return [{"kernel": m.group(1),
             "registers": int(m.group(4)), "spill_stores": int(m.group(2)),
             "spill_loads": int(m.group(3))}
            for m in re.finditer(
                r"Compiling entry function '([^']+)'.*?(\d+) bytes spill "
                r"stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                log, re.S)]


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
                                              stage_copy_ref, stage_copy_rows,
                                              stage_copy_rows_ref,
                                              uniform_rows)
    from repro_torch.core.progress.fabric import pack_payloads
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

    def gather(label, rows, bf16, nan_ok=False, launches=1, time_it=False):
        """stage_copy_rows (the main path's call) on K row tensors, byte
        for byte against its plain version; timed, also today's pair
        (torch.stack, then the dense kernel), the dense kernel alone on
        the stacked rows, the library call and the bytes bound."""
        k, x0 = len(rows), rows[0]
        cast = bf16 and x0.dtype == torch.float32
        n0 = stage_copy_rows.launches
        out = stage_copy_rows(rows, wire_bf16=bf16)
        got = stage_copy_rows.launches - n0
        ref = stage_copy_rows_ref(rows, wire_bf16=bf16)
        torch.cuda.synchronize()
        if got != launches:
            raise AssertionError(f"{label}: {got} gather launches for {k} "
                                 f"rows (want {launches})")
        err = compare(label, out, ref, x0.dtype, cast, nan_ok)
        case = {"case": label, "wrapper": "stage_copy_rows",
                "shape": [k, *x0.shape],
                "dtype": str(x0.dtype).split(".")[1], "wire_bf16": bf16,
                "ok": True, "byte_exact": not nan_ok, "max_abs_err": err,
                "launches": got}
        if time_it:
            n = max(1, min(256, math.ceil(COLD_BYTES / (k * x0.nbytes))))
            sets = [[r.clone() for r in rows] for _ in range(n)]
            stacked = [torch.stack(rs).reshape(k, -1) for rs in sets]
            if cast:
                lib = lambda t: t.to(torch.bfloat16).view(torch.uint8)  # noqa
            else:
                lib = lambda t: t.view(torch.uint8).clone()             # noqa

            def rows_fn(rs):
                return stage_copy_rows(rs, wire_bf16=bf16)

            def pair_fn(rs):
                # the PR 16 path, with the same row check as rows_fn
                if not uniform_rows(rs):
                    raise ValueError(label)
                return stage_copy(torch.stack(rs).reshape(k, -1),
                                  wire_bf16=bf16)
            case.update({
                "kernel_ms": device_ms(rows_fn, sets),
                "pair_ms": device_ms(pair_fn, sets),
                "dense_ms": device_ms(
                    lambda t: stage_copy(t, wire_bf16=bf16), stacked),
                "plain_ms": device_ms(
                    lambda rs: stage_copy_rows_ref(rs, wire_bf16=bf16),
                    sets),
                "library_ms": device_ms(lib, stacked),
                "kernel_call_ms": call_ms(rows_fn, sets),
                "pair_call_ms": call_ms(pair_fn, sets),
                # the main path's staging call around the gather
                "pack_call_ms": call_ms(
                    lambda rs: pack_payloads(rs, bf16), sets),
                "bound_ms": bound_ms(k * x0.nbytes, out.nbytes)})
            case["gather_over_pair"] = case["kernel_ms"] / case["pair_ms"]
            case["dense_over_library"] = (case["dense_ms"] /
                                          case["library_ms"])
            case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
            del sets, stacked
        cases.append(case)
        return case

    def separate(k, e, dtype):
        """k rows in k allocations of their own"""
        if dtype == torch.uint8:
            return [torch.randint(0, 256, (e,), generator=g, device=DEVICE,
                                  dtype=dtype) for _ in range(k)]
        return [torch.randn(e, generator=g, device=DEVICE).to(dtype)
                for _ in range(k)]

    def offset(k, e, dtype):
        """k rows as views into one buffer, one element past every
        16-byte boundary (odd byte offsets for uint8)"""
        buf = separate(1, k * (e + 1) + 1, dtype)[0]
        return [buf[1 + i * (e + 1):1 + i * (e + 1) + e] for i in range(k)]

    # the yardstick shapes: the main path's 64 KiB and 8 KiB f32 rows
    # (wire_bf16 off and on) and its 8-byte u8 rows
    for e in (16384, 2048):
        rows = separate(64, e, torch.float32)
        for bf16 in (False, True):
            gather(f"rows_f32_64x{e}_bf16{int(bf16)}", rows, bf16,
                   time_it=True)
    gather("rows_u8_64x8", separate(64, 8, torch.uint8), False, time_it=True)
    # rows at odd byte offsets, tails, more rows than one launch takes
    gather("rows_u8_64x8_odd_offsets", offset(64, 8, torch.uint8), False)
    gather("rows_u8_7x4099_odd_offsets", offset(7, 4099, torch.uint8), False)
    for bf16 in (False, True):
        gather(f"rows_f32_9x1027_offsets_bf16{int(bf16)}",
               offset(9, 1027, torch.float32), bf16)
        gather(f"rows_f32_257x300_bf16{int(bf16)}",
               separate(257, 300, torch.float32), bf16, launches=2)
        gather(f"rows_special_64x2048_bf16{int(bf16)}",
               list(special_values(64, 2048, nan=False)), bf16)
    gather("rows_nan_64x2048_bf16", list(special_values(64, 2048, nan=True)),
           True, nan_ok=True)

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
CASE_TIMEOUT = 60.0     # seconds a window's completions may take
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


class _StackCount:
    """Counts ``torch.stack`` calls while installed: the uniform-row path
    of a fused doorbell must make none (the gather reads each row where
    it lies)."""

    def __init__(self, torch):
        self.torch, self.real, self.calls = torch, torch.stack, 0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)
        self.torch.stack = counted
        return self

    def __exit__(self, *exc):
        self.torch.stack = self.real


def _wire_counts():
    """(frames encoded, CUDA frames encoded, copies to the host, copies to
    the card): the codec counts the frames the ``shm`` and ``socket``
    transports encode, and ``wire.to_host`` / ``to_card`` the copies."""
    from repro_torch.core.transport.codec import encode_msg
    from repro_torch.core.transport.wire import to_card, to_host
    return (encode_msg.frames, encode_msg.cuda_frames, to_host.copies,
            to_card.copies)


def _since(before):
    return tuple(a - b for a, b in zip(_wire_counts(), before))


def main_path_case(torch, label, kind, dtype, nbytes, wire_bf16,
                   backend="sim", windows=WINDOWS, n_devices=4,
                   attrs=None, ordered=False):
    """One message-path case: ``windows`` windows of WINDOW doorbells of K
    CUDA rows through ``LocalCluster(2, device="cuda", fabric_backend=
    backend)``; ``attrs`` add to the cluster's (the chaos and
    reliability ones); ``ordered`` also requires the completions in tag
    order (one device stream)."""
    from repro_torch.core import LocalCluster
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_ref,
                                              stage_copy_rows)
    cattrs = {"fabric_backend": backend, **(attrs or {})}
    if wire_bf16:
        cattrs["wire_bf16"] = True
    cl = LocalCluster(2, device=DEVICE, attrs=cattrs)
    ep0, ep1 = cl.alloc_endpoint(n_devices=n_devices, stripe="round_robin",
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

    launches0, dense0 = stage_copy_rows.launches, stage_copy.launches
    wire0 = _wire_counts()
    stacks = 0
    doorbells = delivered = 0
    elapsed = 0.0
    split = {"post_s": 0.0, "progress_s": 0.0, "pop_s": 0.0}
    for w in range(windows):
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
        with _StackCount(torch) as stack:
            t0 = time.perf_counter()
            for d in range(WINDOW):
                sl = slice(d * K, (d + 1) * K)
                doorbells += _post_all(post, progress, rows[sl], tags[sl])
            t1 = time.perf_counter()
            # progress until the window's completions are in: over a
            # socket a large frame takes several passes, and under chaos
            # a retransmit waits out its backoff
            got = []
            deadline = time.monotonic() + CASE_TIMEOUT
            while len(got) < per_window and time.monotonic() < deadline:
                progress()
                while True:
                    st = cq.pop()
                    if st.is_retry():
                        break
                    got.append(st)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        cl.quiesce()                         # a duplicate would land now
        while True:
            st = cq.pop()
            if st.is_retry():
                break
            got.append(st)
        stacks += stack.calls
        elapsed += t3 - t0
        split["post_s"] += t1 - t0
        split["progress_s"] += t2 - t1
        split["pop_s"] += t3 - t2
        # checks (outside the timed region)
        seen = [st.tag for st in got]
        if sorted(seen) != tags or (ordered and seen != tags):
            lost = len(set(tags) - set(seen))
            raise AssertionError(f"{label} window {w}: {len(got)} "
                                 f"completions, {lost} lost, "
                                 f"{len(seen) - len(set(seen))} duplicated"
                                 f", in order: {seen == tags}")
        delivered += len(got)
        want = src.view(torch.uint8).reshape(per_window, -1)
        if wire_bf16:
            want = (stage_copy_ref(src, wire_bf16=True).view(torch.bfloat16)
                    .float().view(torch.uint8))
        if kind == "am":
            # over shm and socket an AM is delivered as host bytes
            by_tag = {st.tag: torch.as_tensor(st.get_buffer()).to(DEVICE)
                      for st in got}
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
    launches = stage_copy_rows.launches - launches0
    dense = stage_copy.launches - dense0
    if launches != doorbells or dense or stacks:
        raise AssertionError(f"{label}: {launches} gather launches for "
                             f"{doorbells} fused doorbells, {dense} dense "
                             f"stage copies and {stacks} torch.stack calls "
                             "(want one gather a doorbell, no dense copy, "
                             "no stack)")
    frames, cuda, to_host, to_card = _since(wire0)
    rel = cl[0].rel
    retransmits = rel.counters()["retransmits"] if rel is not None else 0
    # the copies between host and card, as designed: every fused doorbell
    # is one frame, encoded once, and its CUDA image crosses to the host
    # once (a retransmit encodes it again); a frame delivered into
    # pre-posted CUDA recv buffers crosses back once (under chaos a frame
    # can be delivered in parts, one copy each, or dropped); an AM is
    # delivered in host memory; sim encodes nothing
    if backend == "sim":
        want = {"frames": 0, "to_host": 0}
    else:
        want = {"cuda_frames": doorbells + retransmits,
                "to_host": doorbells + retransmits}
    have = {"frames": frames, "cuda_frames": cuda, "to_host": to_host}
    wrong = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if kind == "am" or backend == "sim":
        card_ok = to_card == 0
    elif attrs:
        card_ok = doorbells <= to_card <= cuda
    else:
        card_ok = to_card == doorbells
    if wrong or not card_ok:
        raise AssertionError(f"{label} ({backend}): (counted, wanted) "
                             f"{wrong}; {to_card} copies to the card for "
                             f"{doorbells} doorbells, {retransmits} "
                             "retransmits (want one frame and one copy to "
                             "the host a doorbell and a retransmit, one "
                             "copy to the card a doorbell into CUDA recv "
                             "buffers)")
    n = windows * per_window
    rec = {"case": label, "backend": backend,
           "posted_with": f"post_{kind}_many",
           "payload": f"{str(dtype).split('.')[1]} {nbytes} B",
           "wire_bf16": wire_bf16, "messages": n, "delivered": delivered,
           "lost": 0, "duplicated": 0, "leaked_packets": 0,
           "doorbells": doorbells, "kernel_launches": launches,
           "launches_per_doorbell": launches / doorbells,
           "dense_stage_copy_launches": dense, "torch_stack_calls": stacks,
           "frames_encoded": frames, "cuda_frames_encoded": cuda,
           "copies_to_host": to_host, "copies_to_card": to_card,
           "byte_exact": True,
           "us_per_msg": elapsed / n * 1e6,
           "GB_per_s": n * nbytes / elapsed / 1e9,
           "host_split_s": split, "elapsed_s": elapsed,
           "window_payload_MiB": per_window * nbytes / 2 ** 20}
    if rel is not None:
        rec["reliability"] = rel.counters()
        rec["chaos"] = cl.fabric.fault_counters()
        rec["in_order"] = True
    cl.close()
    return rec


#: phase 4's four cases: (label, kind, dtype name, payload bytes, wire_bf16)
MAIN_CASES = (("a", "am", "float32", 65536, False),
              ("b", "am", "float32", 65536, True),
              ("c", "send", "float32", 8192, False),
              ("d", "am", "uint8", 8, False))


# ---------------------------------------------------------------------------
# phase 15: the message path over the shm and socket transports
# ---------------------------------------------------------------------------

TRANSPORT_WINDOWS = 2   # windows a case on each of shm and socket
#: the reference's chaos faults (tests/test_chaos.py FAULTS)
FAULTS = {"chaos_drop": 0.05, "chaos_dup": 0.05, "chaos_reorder": 0.05}
#: a child's wall-clock limit, seconds (CUDA start-up included)
CHILD_TIMEOUT = 120.0
HB_TIMEOUT = 5.0        # the chaos-kill demo's heartbeat timeout


def transports_phase(torch, sim_runs):
    """a) phase 4's cases over shm and socket in one process; b) the
    reliability protocol under the reference's chaos faults on sim and
    shm, in order; c) two OS processes on the one card through the SPMD
    launcher, and the launcher's chaos-kill demo."""
    out = {"in_process": [], "chaos": [], "processes": []}
    t0 = time.perf_counter()
    for backend in ("shm", "socket"):
        for label, kind, dt, nbytes, bf16 in MAIN_CASES:
            out["in_process"].append(main_path_case(
                torch, label, kind, getattr(torch, dt), nbytes, bf16,
                backend=backend, windows=TRANSPORT_WINDOWS))
    out["in_process_s"] = time.perf_counter() - t0
    out["us_per_msg"] = {
        b: {r["case"]: r["us_per_msg"] for r in runs}
        for b, runs in (("sim", sim_runs),
                        ("shm", out["in_process"][:4]),
                        ("socket", out["in_process"][4:]))}
    out["GB_per_s"] = {
        b: {r["case"]: r["GB_per_s"] for r in runs}
        for b, runs in (("sim", sim_runs),
                        ("shm", out["in_process"][:4]),
                        ("socket", out["in_process"][4:]))}
    t0 = time.perf_counter()
    for backend in ("sim", "shm"):
        for label, kind, nbytes in (("chaos_am", "am", 8192),
                                    ("chaos_send", "send", 8192)):
            out["chaos"].append(main_path_case(
                torch, label, kind, torch.float32, nbytes, False,
                backend=backend, windows=TRANSPORT_WINDOWS, n_devices=1,
                attrs={"reliability": "on", "chaos_seed": SEED + 7,
                       **FAULTS}, ordered=True))
    out["chaos_s"] = time.perf_counter() - t0
    if not any(r["reliability"]["retransmits"] for r in out["chaos"]):
        raise AssertionError("the chaos runs retransmitted nothing: the "
                             "faults did not fire")
    t0 = time.perf_counter()
    for backend in ("shm", "socket"):
        out["processes"].append(spmd_case(backend))
    out["chaos_kill"] = chaos_kill_case()
    out["processes_s"] = time.perf_counter() - t0
    return out


#: the two-process rank program: doorbells a window and windows per kind
SPMD_DOORBELLS, SPMD_WINDOWS = 4, 2
#: (kind, payload bytes) of the rank program's windows, in turn
SPMD_KINDS = (("am", 65536), ("send", 8192))


def _src_path():
    """PYTHONPATH for a child: the checkout's ``src`` first."""
    old = os.environ.get("PYTHONPATH")
    return os.path.join(ROOT, "src") + (os.pathsep + old if old else "")


def spmd_case(backend):
    """Two ranks of ``chip_smoke.py --spmd-rank`` through the port's SPMD
    launcher on ``backend``; every rank reports what it sent, received
    and launched, and any failure or a child past its limit raises."""
    import shutil
    import tempfile
    from repro_torch.launch import spmd
    outdir = tempfile.mkdtemp(prefix="chip-smoke-spmd-")
    t0 = time.perf_counter()
    try:
        code = spmd.launch([sys.executable, os.path.abspath(__file__),
                            "--spmd-rank", outdir], 2, backend=backend,
                           timeout=CHILD_TIMEOUT,
                           env={"PYTHONPATH": _src_path()})
        ranks = []
        for r in range(2):
            path = os.path.join(outdir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if code != 0 or len(ranks) != 2:
        raise AssertionError(f"the two-process {backend} run exited {code} "
                             f"with {len(ranks)} rank reports")
    for r, rep in enumerate(ranks):
        sends = ranks[(r - 1) % 2]["doorbells"]["send"]
        if rep["copies_to_card"] != sends:
            raise AssertionError(f"rank {r} ({backend}): "
                                 f"{rep['copies_to_card']} copies to the "
                                 f"card for the peer's {sends} send "
                                 "doorbells into its CUDA recv buffers")
    return {"backend": backend, "seconds": time.perf_counter() - t0,
            "ranks": ranks}


def spmd_rank(outdir) -> int:
    """One rank of the two-process run: fused doorbells of CUDA rows to
    the neighbour (AMs, then sends into its pre-posted CUDA recv
    buffers), every received row checked byte for byte against the
    sender's seeded rows; writes its report to ``outdir``.  Exits
    non-zero on any loss, duplicate or wrong byte."""
    import torch
    from repro_torch.core import ProcessCluster
    from repro_torch.kernels.doorbell import stage_copy_rows
    from repro_torch.launch.spmd import bootstrap
    ctx = bootstrap()
    backend = os.environ["REPRO_ATTR_FABRIC_BACKEND"]
    cl = ProcessCluster(ctx.n_ranks, ctx.rank, session=ctx.session,
                        device=DEVICE)
    rt = cl.runtime
    ep = rt.alloc_endpoint(n_devices=1, name="spmd")
    cq = rt.alloc_cq()
    rt.register_rcomp(cq)            # symmetric: rcomp 0 on every rank
    peer = (ctx.rank + 1) % ctx.n_ranks
    src_rank = (ctx.rank - 1) % ctx.n_ranks
    deadline = time.monotonic() + CHILD_TIMEOUT

    def rows_of(rank, kind_i, w, e):
        g = torch.Generator(device=DEVICE).manual_seed(
            1000 * rank + 10 * kind_i + w)
        return torch.randn(SPMD_DOORBELLS * K, e, generator=g,
                           device=DEVICE)

    def settle(what):
        """Progress until nothing of mine is left on the wire: a socket
        sends only when progress is called, and the peer may still wait
        for my rows while I wait at a barrier."""
        while rt.pending_ops or cl.fabric.in_flight():
            if time.monotonic() > deadline:
                raise AssertionError(f"rank {ctx.rank}: {what} never "
                                     "drained")
            ep.progress()

    launches0 = stage_copy_rows.launches
    wire0 = _wire_counts()
    doorbells = {"am": 0, "send": 0}
    received = 0
    got = {}                         # tag -> the delivered buffer
    t0 = time.perf_counter()
    ctx.barrier(timeout=60)
    for kind_i, (kind, nbytes) in enumerate(SPMD_KINDS):
        e = nbytes // 4
        for w in range(SPMD_WINDOWS):
            base = (kind_i * SPMD_WINDOWS + w) * SPMD_DOORBELLS * K
            tags = list(range(base, base + SPMD_DOORBELLS * K))
            mine = list(rows_of(ctx.rank, kind_i, w, e))
            want = rows_of(src_rank, kind_i, w, e).view(torch.uint8)
            rbuf = None
            if kind == "send":
                rbuf = torch.zeros_like(want)
                for i, t in enumerate(tags):
                    if ep.post_recv(src_rank, rbuf[i], nbytes, tag=t,
                                    local_comp=cq).is_retry():
                        raise AssertionError("recv post retried")
                settle(f"the window before {base}")
                ctx.barrier(timeout=60)  # the peer's recvs are posted
            for d in range(SPMD_DOORBELLS):
                sl = slice(d * K, (d + 1) * K)
                if kind == "am":
                    doorbells[kind] += _post_all(
                        lambda b, t: ep.post_am_many(peer, b, 0, tags=t),
                        ep.progress, mine[sl], tags[sl])
                else:
                    doorbells[kind] += _post_all(
                        lambda b, t: ep.post_send_many(peer, b, tags=t),
                        ep.progress, mine[sl], tags[sl])
            # the peer may be a window ahead: its rows land in ``got``
            # for the window they belong to
            while any(t not in got for t in tags):
                if time.monotonic() > deadline:
                    lost = sum(t not in got for t in tags)
                    raise AssertionError(f"rank {ctx.rank}: {lost} of "
                                         f"window {base} lost")
                ep.progress()
                while True:
                    st = cq.pop()
                    if not st.is_done():
                        break
                    if st.tag in got:
                        raise AssertionError(f"rank {ctx.rank}: tag "
                                             f"{st.tag} duplicated")
                    got[st.tag] = st.get_buffer()
            if kind == "am":
                have = torch.stack([torch.as_tensor(got[t]).to(DEVICE)
                                    for t in tags])
            else:
                have = rbuf
            if not torch.equal(have, want):
                raise AssertionError(f"rank {ctx.rank}: window {base} "
                                     "bytes differ from the sender's")
            received += len(tags)
    settle("the last window")
    if len(got) != received:
        raise AssertionError(f"rank {ctx.rank}: {len(got) - received} "
                             "rows beyond the windows sent")
    ctx.barrier(timeout=60)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = stage_copy_rows.launches - launches0
    frames, cuda, to_host, to_card = _since(wire0)
    sent = sum(doorbells.values())
    report = {"rank": ctx.rank, "backend": backend,
              "doorbells": doorbells, "kernel_launches": launches,
              "received": received, "lost": 0, "duplicated": 0,
              "byte_exact": True, "frames_encoded": frames,
              "cuda_frames_encoded": cuda, "copies_to_host": to_host,
              "copies_to_card": to_card, "seconds": elapsed,
              "device": torch.cuda.get_device_name(0)}
    cl.close()
    ctx.close()
    # one gather, one CUDA frame and one copy to the host a doorbell sent;
    # the copies to the card (one a send frame received) are held against
    # the peer's send doorbells by the launching process
    if launches != sent or cuda != sent or to_host != sent:
        raise AssertionError(f"rank {ctx.rank}: {report}")
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def chaos_kill_case():
    """The launcher's chaos-kill demo on the card: rank 1 is SIGKILLed
    mid-stream; the survivor must detect it, drain every outstanding post
    as ERR_PEER_DEAD and exit 0 (the launcher's own exit code)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.spmd", "--ranks", "2",
         "--backend", "shm", "--chaos-kill", "1", "--kill-after", "1",
         "--hb-timeout", str(HB_TIMEOUT), "--timeout", str(CHILD_TIMEOUT)],
        env={**os.environ, "PYTHONPATH": _src_path()},
        capture_output=True, text=True,
        timeout=CHILD_TIMEOUT + 30)
    text = r.stdout + r.stderr
    lines = [ln for ln in text.splitlines() if "spmd-chaos rank 0: drained"
             in ln]
    if r.returncode != 0 or not lines or "other=0 hung=0" not in lines[0] \
            or "peer_dead=0 " in lines[0]:
        raise AssertionError(f"the chaos-kill demo failed ({r.returncode}):"
                             f"\n{text}")
    return {"backend": "shm", "hb_timeout_s": HB_TIMEOUT,
            "seconds": time.perf_counter() - t0, "survivor": lines[0]}


# ---------------------------------------------------------------------------
# phase 5: flash attention (B2) and RMSNorm (B3) against their plain versions
# ---------------------------------------------------------------------------

#: dense peak rates of one H100 SXM (NVIDIA data sheet; on-chip guide):
#: bf16 on the tensor cores, float32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:85"
#: the variants of csrc/flash_attention.cu, for the kernels line
FLASH_DESIGN = {"tc": "bf16, dh 64/128/256: wgmma (S = Q K^T from shared "
                      "memory; O += P V with P in bf16 from registers, V "
                      "MN-major) + TMA (2-stage K/V ring, mbarriers), 128 "
                      "q rows a block in 2 consumer warpgroups + a loader "
                      "warpgroup (setmaxnreg 240/24), online softmax in "
                      "registers, masked-band tiles skipped, seq-major "
                      "views read and written in place",
                "simt": "float32 and dh 16/32: CUDA-core register tiles, "
                        "softmax through shared memory"}
RMS_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:25"
GEMMA_GLOBAL = 1 << 30                  # blocks.py: a global layer's window


def cold_sets(tensors, limit: int = 64):
    """Distinct copies of a tuple of tensors adding up to about
    COLD_BYTES, for timings that must not run out of the L2 cache."""
    nbytes = sum(t.nbytes for t in tensors)
    n = max(1, min(limit, math.ceil(COLD_BYTES / max(1, nbytes))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _tol(dtype) -> float:
    """tests/test_kernels.py's tolerance: bf16 2e-2, float32 5e-5."""
    import torch
    return 2e-2 if dtype == torch.bfloat16 else 5e-5


#: B2's tensor-core variant against the plain version of its own
#: arithmetic (P in bf16): what rounding the output to bf16 and a
#: different order of the float32 sums leave (tests/test_torch_cuda.py)
TC_ATOL, TC_RTOL = 4e-3, 8e-3


def _close(name, out, ref, dtype, atol=None, rtol=None):
    """Hold ``out`` against ``ref`` within atol + rtol |ref| (by default
    :func:`_tol` for both).  Returns (the max abs error, the largest
    share of the limit an element uses)."""
    import torch
    a, b = out.double(), ref.double()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    atol = _tol(dtype) if atol is None else atol
    rtol = _tol(dtype) if rtol is None else rtol
    d = (a - b).abs()
    limit = atol + rtol * b.abs()
    bad = d > limit
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements differ "
            f"from the plain version beyond {atol} + {rtol} |ref| (max abs "
            f"{float(d.max())})")
    return float(d.max()), float((d / limit).max())


def flash_case(torch, label, b, hq, hkv, sq, skv, dh, causal, window,
               q_offset, dtype, g, time_it=True):
    """B2 at one shape: the kernel layout's wrapper held against the plain
    version (and, on "tc", against the plain version with P in bf16 at
    TC_ATOL + TC_RTOL |ref|), and the seq-major wrapper that the model
    path calls (its (s, b, h, dh) operands and output read and written
    through their strides) against it bit for bit.  Timed cases
    time both wrappers; ``kernel_ms`` is the seq-major call's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bhsd,
                                                     flash_attention_ref,
                                                     variant, variant_of)
    from repro_torch.kernels.flash_attention.ref import attention_mask
    q = torch.randn(b, hq, sq, dh, generator=g, device=DEVICE).to(dtype)
    k = torch.randn(b, hkv, skv, dh, generator=g, device=DEVICE).to(dtype)
    v = torch.randn(b, hkv, skv, dh, generator=g, device=DEVICE).to(dtype)
    # the model path's operands: contiguous seq-major tensors
    seq = tuple(t.permute(2, 0, 1, 3).contiguous() for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, kind = variant_of(lambda: flash_attention_bhsd(q, k, v, **kw))
    out_seq, kind_seq = variant_of(lambda: flash_attention(*seq, **kw))
    if kind != variant(q, k, v) or kind_seq != kind:
        raise AssertionError(f"{label}: launched {kind} (kernel layout) "
                             f"and {kind_seq} (seq-major), variant() says "
                             f"{variant(q, k, v)}")
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    out_seq = out_seq.permute(1, 2, 0, 3)
    err, _ = _close(label, out, ref, dtype)
    if not torch.equal(out_seq, out):
        raise AssertionError(f"{label}: the seq-major call differs from "
                             "the kernel layout's")
    err_bf16_p = limit_use = None
    if kind == "tc":                    # P in bf16, as the variant rounds it
        ref_p = flash_attention_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
        err_bf16_p, limit_use = _close(f"{label} (bf16 P)", out, ref_p,
                                       dtype, TC_ATOL, TC_RTOL)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=DEVICE)
    pairs = int(mask.sum()) * b * hq
    dname = str(dtype).split(".")[1]
    flops = 4 * dh * pairs
    nbytes = q.nbytes + k.nbytes + v.nbytes + out.nbytes
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": label, "shape_q": [b, hq, sq, dh],
            "shape_kv": [b, hkv, skv, dh], "dtype": dname,
            "causal": causal, "window": window, "q_offset": q_offset,
            "variant": kind, "visible_pairs": pairs, "flops": flops,
            "bytes": nbytes, "ok": True, "max_abs_err": err,
            "seq_major_bitwise": True, "max_abs_err_bf16_p": err_bf16_p,
            "limit_bf16_p": [TC_ATOL, TC_RTOL] if kind == "tc" else None,
            "limit_use_bf16_p": limit_use,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if time_it:
        xs = cold_sets((q, k, v))
        xs_seq = cold_sets(seq)
        mask_ = mask.expand(b, hq, sq, skv)
        case.update({
            "kernel_ms": device_ms(
                lambda t: flash_attention(*t, **kw), xs_seq),
            "kernel_bhsd_ms": device_ms(
                lambda t: flash_attention_bhsd(*t, **kw), xs),
            "plain_ms": device_ms(
                lambda t: flash_attention_ref(*t, **kw), xs[:2]),
            "library_ms": device_ms(
                lambda t: F.scaled_dot_product_attention(
                    t[0], t[1], t[2], attn_mask=mask_, enable_gqa=True),
                xs),
        })
        # a plain causal mask: also the library's causal-only call, which
        # does the visible half of the work, as the kernel does
        if causal and q_offset == 0 and sq == skv and \
                (window == 0 or window >= skv):
            fn, inputs, form = _causal_sdpa(xs)
            case["library_causal_ms"] = device_ms(fn, inputs)
            case["library_causal_form"] = form
        case["achieved_tflops"] = flops / case["kernel_ms"] / 1e9
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
    return case


def _causal_sdpa(xs):
    """``F.scaled_dot_product_attention(..., is_causal=True)`` over the
    (q, k, v) tuples ``xs``: (the call, its inputs, the form).  The form
    is ``enable_gqa`` where the chosen backend takes it, else k and v are
    expanded to q's heads here, outside the timed calls (a GQA shape then
    reads hq / hkv times the kv bytes)."""
    import torch
    import torch.nn.functional as F
    q, k, v = xs[0]
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        torch.cuda.synchronize()
        return (lambda t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], is_causal=True, enable_gqa=True)), xs, \
            "enable_gqa"
    except RuntimeError:
        g = q.shape[1] // k.shape[1]
        return (lambda t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], is_causal=True)), [
            (t[0], t[1].repeat_interleave(g, dim=1),
             t[2].repeat_interleave(g, dim=1)) for t in xs], "expanded"


def rmsnorm_case(torch, label, rows, d, dtype, g, with_w=True,
                 time_it=True):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    x = (torch.randn(rows, d, generator=g, device=DEVICE) * 3).to(dtype)
    w = torch.randn(d, generator=g, device=DEVICE).to(dtype) if with_w \
        else None
    out = rmsnorm(x, w)
    ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err, _ = _close(label, out, ref, dtype)
    nbytes = x.nbytes + out.nbytes + (w.nbytes if with_w else 0)
    case = {"case": label, "shape": [rows, d],
            "dtype": str(dtype).split(".")[1], "weight": with_w, "ok": True,
            "max_abs_err": err, "bytes": nbytes,
            "bound_ms": bound_ms(nbytes, 0), "bound_by": "bytes"}
    if time_it:
        xs = cold_copies(x)
        case.update({
            "kernel_ms": device_ms(lambda t: rmsnorm(t, w), xs),
            "plain_ms": device_ms(lambda t: rmsnorm_ref(t, w), xs),
            "library_ms": device_ms(
                lambda t: F.rms_norm(t, (d,), w, eps=1e-6), xs),
            # the same bytes moved with no arithmetic: what the card's
            # memory gives a plain copy at this size
            "copy_ms": device_ms(lambda t: t.clone(), xs),
        })
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        del xs
    return case


def model_kernel_phase(torch):
    """B2 over the sweep of tests/test_kernels.py, gemma3-1b's prefill
    shapes (window 512 and global, bf16 and float32), a ragged s = 1000
    and a q offset past the keys; B3 over the same file's sweep and the
    serving path's shapes.  Returns (flash cases, rmsnorm cases)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    flash = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for (b, hq, hkv, sq, skv, dh, causal, window, qo) in (
                (2, 4, 2, 64, 64, 16, True, 0, 0),
                (1, 4, 1, 128, 128, 32, True, 32, 0),
                (2, 2, 2, 64, 128, 16, True, 0, 64),
                (1, 6, 3, 96, 96, 16, False, 0, 0),
                (1, 8, 8, 32, 32, 64, True, 8, 0)):
            flash.append(flash_case(
                torch, f"sweep_{dn}_{b}x{hq}x{hkv}x{sq}x{skv}x{dh}_w{window}"
                f"_o{qo}", b, hq, hkv, sq, skv, dh, causal, window, qo,
                dtype, g, time_it=False))
        for window, name in ((512, "local512"), (GEMMA_GLOBAL, "global")):
            flash.append(flash_case(
                torch, f"gemma3_prefill_{name}_{dn}", 4, 4, 1, 2048, 2048,
                256, True, window, 0, dtype, g))
        flash.append(flash_case(torch, f"ragged_s1000_{dn}", 1, 4, 1, 1000,
                                1000, 256, True, 512, 0, dtype, g))
        flash.append(flash_case(torch, f"ragged_s1000_dh128_{dn}", 1, 16, 16,
                                1000, 1000, 128, True, 0, 0, dtype, g,
                                time_it=False))
        # rows 99.. (positions >= 191) see no key: uniform average
        flash.append(flash_case(torch, f"no_key_rows_{dn}", 1, 4, 1, 256,
                                128, 256, True, 64, 100, dtype, g,
                                time_it=False))
    rms = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for rows, d in ((8, 64), (64, 128), (100, 96), (1, 256)):
            rms.append(rmsnorm_case(torch, f"sweep_{dn}_{rows}x{d}", rows, d,
                                    dtype, g, time_it=False))
        # gemma3's norm1/norm2/final norm, q_norm and k_norm at prefill
        # (4 x 2048 tokens), and a decode-sized batch
        for rows, d in ((8192, 1152), (100, 1152), (32768, 256),
                        (8192, 256)):
            rms.append(rmsnorm_case(torch, f"serve_{dn}_{rows}x{d}", rows, d,
                                    dtype, g))
        rms.append(rmsnorm_case(torch, f"no_weight_{dn}_100x1152", 100, 1152,
                                dtype, g, with_w=False, time_it=False))
    # olmoe's prefill (4 x 1024 tokens): norm1/norm2 and its q/k norms
    for rows, d in ((4096, 2048), (65536, 128)):
        rms.append(rmsnorm_case(torch, f"olmoe_prefill_bfloat16_{rows}x{d}",
                                rows, d, torch.bfloat16, g))
    return flash, rms


# ---------------------------------------------------------------------------
# phases 6 and 9: full width, float32: decode against forward
# ---------------------------------------------------------------------------

PARITY_S, PARITY_B = 32, 2


def _decode_vs_forward(torch, cfg, params, tokens):
    """Teacher-forced ``make_serve_step`` over every position against
    ``forward``'s greedy tokens, and ``make_prefill_step``'s token
    against forward's last position."""
    from repro_torch.distributed import local_comm
    from repro_torch.models.layers import greedy_sample, lm_head_logits
    from repro_torch.models.registry import build_model
    from repro_torch.serving import (init_cache, make_prefill_step,
                                     make_serve_step)
    comm = local_comm()
    x, aux = build_model(cfg, device=DEVICE).forward(params,
                                                     {"tokens": tokens})
    head = params.get("lm_head", params["emb"])
    logits = lm_head_logits(x, head, comm, real_vocab=cfg.vocab)
    oracle = greedy_sample(logits, comm)
    top2 = logits.topk(2, dim=-1).values
    step = make_serve_step(cfg)
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device=DEVICE)
    preds = []
    for i in range(tokens.shape[0]):
        nxt, cache = step(params, cache, tokens[i])
        preds.append(nxt)
    preds = torch.stack(preds)
    p_tok, last = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if not torch.isfinite(x).all() or not torch.isfinite(last).all():
        raise AssertionError(f"{cfg.name} f32: non-finite hidden states")
    return {"decode_vs_forward_agreement":
            float((preds == oracle).float().mean()),
            "prefill_token_equals_forward": bool(torch.equal(p_tok,
                                                             oracle[-1])),
            "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min()),
            "mismatches": int((preds != oracle).sum()),
            "forward_aux": {k: float(v) for k, v in aux.items()}}


def model_parity_phase(torch, arch: str = "gemma3-1b"):
    """``arch``'s full config in float32, the port's own seeded init on
    the card: teacher-forced ``make_serve_step`` over 32 positions (plain
    decode attention) against ``forward``'s greedy tokens (the
    flash-attention kernel), and ``make_prefill_step``'s token against
    forward's last position.

    A moe config routes forward's 64 tokens with capacity(64) slots an
    expert and a decode step's 2 tokens with capacity(2): forward may drop
    assignments that decode keeps, and then the two compute different
    functions (the reference's semantics).  So the gate runs with the
    capacity factor E / k, where no expert can overflow (forward's
    dropped fraction must be 0), and the config's own capacity factor is
    run beside it and reported (agreement and dropped fraction), not
    gated."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    params, _ = build_model(cfg, device=DEVICE).init(SEED)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab, (PARITY_S, PARITY_B), generator=g,
                           device=DEVICE, dtype=torch.int32)
    out = {"config": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
           "params": sum(int(t.numel()) for t in _leaves(params)),
           "positions": PARITY_S, "batch": PARITY_B}
    gated = cfg
    if cfg.family == "moe":
        out["own_capacity_factor"] = {"capacity_factor": cfg.capacity_factor,
                                      **_decode_vs_forward(torch, cfg,
                                                           params, tokens)}
        gated = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        out["gated_capacity_factor"] = gated.capacity_factor
    res = _decode_vs_forward(torch, gated, params, tokens)
    out.update(res)
    agree = res["decode_vs_forward_agreement"]
    if agree <= 0.95:
        raise AssertionError(f"{arch} f32: decode agrees with forward on "
                             f"{agree:.3f} of tokens (needs > 0.95)")
    if not res["prefill_token_equals_forward"]:
        raise AssertionError(f"{arch} f32: prefill token differs from "
                             "forward's last position")
    if res["forward_aux"]["dropped_frac"] != 0.0:
        raise AssertionError(f"{arch} f32: forward dropped assignments at "
                             f"capacity factor {gated.capacity_factor}")
    del params
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phases 7 and 10: the slices' main paths: serving at full width, bf16
# ---------------------------------------------------------------------------

PREFILL_CALLS = 3
SERVE_ARGS = dict(requests=16, max_new=16, max_batch=8, cache_len=256)
#: per config: the prefill batch and prompt length, and the kernel launches
#: of one prefill call (a forward) and of one decode step: B2 a forward
#: (a layer each), B3 (gemma3: norm1, q_norm, k_norm, norm2 a layer + the
#: final norm; olmoe the same four), B4 (one a moe layer)
SERVING = {
    "gemma3-1b": dict(batch=4, seq=2048, flash=26, rms=105, moe=0, ssd=0),
    "olmoe-1b-7b": dict(batch=4, seq=1024, flash=16, rms=65, moe=16, ssd=0),
    "mamba2-370m": dict(batch=4, seq=2048, flash=0, rms=97, moe=0, ssd=48),
    "hymba-1.5b": dict(batch=4, seq=2048, flash=32, rms=161, moe=0, ssd=32),
}


def _rms_by_shape(before: dict) -> dict:
    """B3's launches by (rows, d) since the snapshot ``before`` of
    ``rmsnorm.launches_by_shape``, keyed "ROWSxD"."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {f"{r}x{d}": n - before.get((r, d), 0)
            for (r, d), n in sorted(rmsnorm.launches_by_shape.items())
            if n > before.get((r, d), 0)}


def _counts():
    """Launches of B2, B3, B4, B4's tensor-core variant, B5, B2's
    tensor-core variant and B5's tensor-core variant."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    return (flash_attention_bhsd.launches, rmsnorm.launches,
            moe_gmm.launches, moe_gmm.launches_by_variant["tc"],
            ssd_scan_bhsp.launches,
            flash_attention_bhsd.launches_by_variant["tc"],
            ssd_scan_bhsp.launches_by_variant["tc"])


class _FillLog:
    """Wraps ``models/moe.py``'s ``moe_gmm`` while installed, keeping the
    ``rows`` and capacity of each call, for the experts' fill, and the
    operands of the last call."""

    def __init__(self):
        import repro_torch.models.moe as moe_mod
        self.mod, self.real, self.calls = moe_mod, moe_mod.moe_gmm, []
        self.last = None

    def __enter__(self):
        def logged(x, w1, w2, *, act, rows=None, **kw):
            self.calls.append((rows, x.shape[1]))
            self.last = (x, w1, w2, act, rows)
            return self.real(x, w1, w2, act=act, rows=rows, **kw)
        self.mod.moe_gmm = logged
        return self

    def __exit__(self, *exc):
        self.mod.moe_gmm = self.real

    def summary(self):
        """Mean fill (filled slots over capacity) and share of experts
        with no token, over the calls logged."""
        import torch
        if not self.calls:
            return None
        if any(r is None for r, _ in self.calls):
            raise AssertionError("moe_block passed no rows at one rank")
        rows = torch.stack([r.float() for r, _ in self.calls])
        cap = torch.tensor([c for _, c in self.calls], device=rows.device)
        return {"calls": len(self.calls), "capacity": sorted(
                    {c for _, c in self.calls}),
                "mean_fill": float((rows / cap[:, None]).mean()),
                "empty_expert_share": float((rows == 0).float().mean())}


def serving_phase(torch, arch: str, profile: bool):
    """``make_prefill_step`` on the config's prompts, then the serve
    launcher's loop (``ServeScheduler`` + ``make_serve_step``), with
    ``arch``'s full config in bf16.  Launch counts are checked per
    prefill call and per decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.launch.serve import PROMPT_LEN, serve
    from repro_torch.models.registry import build_model
    from repro_torch.serving import make_prefill_step
    want = SERVING[arch]
    pb, ps = want["batch"], want["seq"]
    # every B2, B4 and B5 launch of a bf16 path takes the tensor-core
    # variant
    per_call = (want["flash"], want["rms"], want["moe"], want["moe"],
                want["ssd"], want["flash"], want["ssd"])
    cfg = get_config(arch)
    model = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params, _ = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab, (ps, pb), generator=g,
                           device=DEVICE, dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()

    # prefill: one untimed call, then PREFILL_CALLS timed ones; every call
    # is checked for its launch counts
    times = []
    for i in range(PREFILL_CALLS + 1):
        c0 = _counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i:
            tok, last = prefill(params, {"tokens": tokens})
        else:
            by0 = dict(rmsnorm.launches_by_shape)
            with _FillLog() as prefill_fill:
                tok, last = prefill(params, {"tokens": tokens})
            prefill_by_shape = _rms_by_shape(by0)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
        got = tuple(b - a for a, b in zip(c0, _counts()))
        if got != per_call:
            raise AssertionError(f"{arch} prefill launched (flash, RMSNorm, "
                                 f"MoE GMM, MoE GMM tensor-core, SSD scan, "
                                 f"flash tensor-core, SSD scan tensor-core) "
                                 f"{got} times (want {per_call})")
    if not torch.isfinite(last.float()).all() or tok.shape != (pb,) \
            or not ((tok >= 0) & (tok < cfg.vocab)).all():
        raise AssertionError(f"{arch} prefill: bad tokens or non-finite "
                             "hidden")
    prefill_ms = statistics.median(times) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated()

    # decode: the launcher's loop
    c0 = _counts()
    by0 = dict(rmsnorm.launches_by_shape)
    with _FillLog() as decode_fill:
        out = serve(cfg, params, device=DEVICE, **SERVE_ARGS)
    nf, nr, nm, ntc, ns, _, _ = (b - a for a, b in zip(c0, _counts()))
    decode_by_shape = _rms_by_shape(by0)
    steps = out["decode_calls"]
    if sum(prefill_by_shape.values()) != want["rms"] or \
            sum(decode_by_shape.values()) != nr:
        raise AssertionError(f"{arch}: RMSNorm launches by shape "
                             f"{prefill_by_shape} a prefill and "
                             f"{decode_by_shape} in decode do not add up")
    if steps == 0 or nr != want["rms"] * steps or \
            nm != want["moe"] * steps or ntc != nm:
        raise AssertionError(f"{arch} decode: {nr} RMSNorm and {nm} MoE GMM "
                             f"({ntc} tensor-core) launches in {steps} "
                             f"steps (want {want['rms']} and {want['moe']} "
                             "a step, all tensor-core)")
    if nf or ns:
        raise AssertionError("decode launched the prefill attention or the "
                             "SSD-scan kernel")
    if out["completed"] != SERVE_ARGS["requests"] or any(
            r is None or len(r) != SERVE_ARGS["max_new"] or
            not ((r >= 0) & (r < cfg.vocab)).all() for r in out["results"]):
        raise AssertionError(f"{arch} decode: a request did not complete "
                             "with max_new valid tokens")
    rec = {"config": cfg.name, "dtype": "bfloat16", "layers": cfg.n_layers,
           "params": sum(int(t.numel()) for t in _leaves(params)),
           "init_s": init_s,
           "prefill": {"batch": pb, "seq": ps,
                       "calls_timed": PREFILL_CALLS, "ms": prefill_ms,
                       "ms_each": [t * 1e3 for t in times],
                       "tokens_per_s": pb * ps / (prefill_ms / 1e3),
                       "flash_launches_per_call": want["flash"],
                       "flash_tc_launches_per_call": want["flash"],
                       "rmsnorm_launches_per_call": want["rms"],
                       "rmsnorm_launches_by_shape": prefill_by_shape,
                       "moe_gmm_launches_per_call": want["moe"],
                       "moe_gmm_tc_launches_per_call": want["moe"],
                       "moe_fill": prefill_fill.summary(),
                       "ssd_scan_launches_per_call": want["ssd"],
                       "ssd_scan_tc_launches_per_call": want["ssd"],
                       "peak_memory_bytes": prefill_peak},
           "decode": {**SERVE_ARGS, "prompt_len": PROMPT_LEN,
                      "completed": out["completed"],
                      "tokens": out["tokens"], "seconds": out["seconds"],
                      "decode_steps": steps,
                      "rounds": out["rounds"],
                      "tokens_per_s": out["tokens"] / out["seconds"],
                      "ms_per_step": out["seconds"] / steps * 1e3,
                      "rmsnorm_launches_per_step": nr / steps,
                      "rmsnorm_launches_by_shape_per_step": {
                          k: n / steps for k, n in decode_by_shape.items()},
                      "moe_gmm_launches_per_step": nm / steps,
                      "moe_gmm_tc_launches_per_step": ntc / steps,
                      "moe_fill": decode_fill.summary()}}
    if profile:
        rec["profile"] = profile_phase(torch, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    return rec


#: the device kernel of a float32 -> bf16 cast
CAST_KERNEL = "bfloat16_copy_kernel"


class _CastLog:
    """While installed, counts the ``Tensor.to`` calls that cast a
    float32 CUDA tensor to bf16, by the innermost call site in the port's
    code (``repro_torch/<file>:<line>``)."""

    def __enter__(self):
        import traceback
        import torch
        self.real, self.sites = torch.Tensor.to, {}

        def to(t, *a, **kw):
            out = self.real(t, *a, **kw)
            if t.dtype == torch.float32 and out.dtype == torch.bfloat16 \
                    and out.is_cuda:
                site = next((f"{f.filename[f.filename.index('repro_torch/'):]}"
                             f":{f.lineno}"
                             for f in reversed(traceback.extract_stack()[:-1])
                             if "repro_torch/" in f.filename), "other")
                self.sites[site] = self.sites.get(site, 0) + 1
            return out
        torch.Tensor.to = to
        return self

    def __exit__(self, *exc):
        import torch
        torch.Tensor.to = self.real


def profile_phase(torch, cfg, params, tokens):
    """``--profile`` only: torch.profiler over one prefill call and over
    8 decode steps: device time by kernel, summed, against wall time, and
    the float32 -> bf16 cast kernels' launches; then a second prefill
    with ``Tensor.to`` watched, for where those casts come from."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.serving import (init_cache, make_prefill_step,
                                     make_serve_step)

    def split(prof, wall_s):
        # kernels only: a CPU op (aten::mm) also reports the device time
        # of the kernels it launched, which are listed on their own
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        total = sum(r[1] for r in rows)
        mine = {n: sum(r[1] for r in rows if key in r[0])
                for n, key in (("flash_attention", "flash_fwd"),
                               ("rmsnorm", "rmsnorm_"),
                               ("moe_gmm", "gmm_"),
                               ("ssd_scan", "ssd_scan_"))}
        return {"wall_ms": wall_s * 1e3, "device_ms": total,
                "device_busy_share": total / (wall_s * 1e3),
                "hand_written_ms": mine,
                "cast_launches": sum(c for k, _, c in rows
                                     if CAST_KERNEL in k),
                "top": [{"kernel": k[:90], "ms": ms, "count": c}
                        for k, ms, c in rows[:12]]}

    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    out = {"prefill_call": split(prof, wall)}
    with _CastLog() as casts:
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    out["prefill_cast_sites"] = casts.sites
    step = make_serve_step(cfg)
    b = SERVE_ARGS["max_batch"]
    cache = init_cache(cfg, SERVE_ARGS["cache_len"], b, device=DEVICE)
    tok = tokens[0, :1].repeat(b)
    for _ in range(4):
        tok, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(8):
            tok, cache = step(params, cache, tok)
            tok.cpu()                        # as the launcher reads them
        wall = time.perf_counter() - t
    out["decode_8_steps"] = split(prof, wall)
    return out


# ---------------------------------------------------------------------------
# phase 8: the MoE grouped matmul (B4) against its plain version
# ---------------------------------------------------------------------------

MOE_SOURCE = "src/repro_torch/csrc/moe_gmm.cu"
MOE_REPLACES = "src/repro/kernels/moe_gmm/kernel.py:42"
#: the variants of csrc/moe_gmm.cu, for the kernels line
MOE_DESIGN = {"tc": "prefill (C > 16): wgmma m64n256k16 + TMA, 4 stages "
                    "(mbarrier ring), 128x256 tiles, 2 MMA warpgroups + a "
                    "loader warp; decode (C <= 16): mma.sync m16n8k16 "
                    "transposed (weights on M, tokens on N) + cp.async, 4 "
                    "stages; empty capacity rows skipped",
              "simt": "float32 CUDA-core register tiles (float32 and "
                      "unaligned bf16)"}
#: olmoe-1b-7b's expert shapes: 64 experts, d 2048, f 1024 (swiglu)
OLMOE_E, OLMOE_D, OLMOE_F = 64, 2048, 1024


def _library_ffn(act):
    """One PyTorch yardstick for the same function: ``torch.bmm`` ->
    the activation in x's dtype -> ``torch.bmm`` (h rounded to x's
    dtype, where the kernel keeps it in float32)."""
    import torch
    import torch.nn.functional as F

    def ffn(x, w1, w2):
        h = torch.bmm(x, w1)
        if act in ("swiglu", "geglu"):
            g, u = h.chunk(2, dim=-1)
            g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * u
        elif act == "gelu":
            h = F.gelu(h, approximate="tanh")
        else:
            h = torch.square(F.relu(h))
        return torch.bmm(h, w2)
    return ffn


def _variant_of(call):
    """Run ``call`` (one wrapper call) and return (its result, the variant
    it launched)."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    before = dict(moe_gmm.launches_by_variant)
    out = call()
    ran = [k for k, n in moe_gmm.launches_by_variant.items()
           if n != before[k]]
    if len(ran) != 1:
        raise AssertionError(f"moe_gmm: variants {ran} launched in one call")
    return out, ran[0]


def moe_gmm_case(torch, label, e, c, d, f, act, dtype, g, *, w_scale=None,
                 zero_expert=None, time_it=True, operands=None, rows=None):
    """B4 on x (e, c, d), w1 (e, d, m·f), w2 (e, f, d) against its plain
    version at tests/test_kernels.py's tolerance (1e-4 float32, 3e-2
    bf16); asserts the variant it launched (bf16 with d, f multiples of 8:
    the tensor cores).  Weights are N(0, 1) times ``w_scale`` (default
    1/sqrt(fan in), which keeps h and the output O(1) at olmoe's width);
    ``operands`` (x, w1, w2) replaces the random draw.  With ``rows`` the
    call passes each expert's filled rows, and the bound counts only the
    weights of experts that hold a token (what this data needs)."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
    mult = 2 if act in ("swiglu", "geglu") else 1
    if operands is None:
        x = torch.randn(e, c, d, generator=g, device=DEVICE).to(dtype)
        w1 = torch.randn(e, d, mult * f, generator=g, device=DEVICE)
        w1 = (w1 * (w_scale or d ** -0.5)).to(dtype)
        w2 = torch.randn(e, f, d, generator=g, device=DEVICE)
        w2 = (w2 * (w_scale or f ** -0.5)).to(dtype)
    else:
        x, w1, w2 = operands
    if zero_expert is not None:
        x[zero_expert] = 0
    want = "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"
    out, ran = _variant_of(lambda: moe_gmm(x, w1, w2, act=act, rows=rows))
    if ran != want:
        raise AssertionError(f"{label}: launched the {ran} variant, not "
                             f"{want}")
    ref = moe_gmm_ref(x, w1, w2, act=act, rows=rows)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    a, b = out.double(), ref.double()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    bad = (a - b).abs() > tol + tol * b.abs()
    if bad.any():
        raise AssertionError(
            f"{label}: {int(bad.sum())} of {bad.numel()} elements differ "
            f"from the plain version beyond {tol} (max abs "
            f"{float((a - b).abs().max())})")
    if zero_expert is not None and torch.count_nonzero(out[zero_expert]):
        raise AssertionError(f"{label}: an expert with no token gave "
                             "non-zero rows")
    dname = str(dtype).split(".")[1]
    # experts with a token, and the token rows: all, or what rows says
    busy = e if rows is None else int((rows > 0).sum())
    filled = e * c if rows is None else int(rows.clamp(max=c).sum())
    flops = 2 * filled * d * mult * f + 2 * filled * f * d
    nbytes = x.nbytes + out.nbytes + (w1.nbytes + w2.nbytes) * busy // e
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": label, "shape_x": [e, c, d], "f": f, "act": act,
            "dtype": dname, "variant": ran, "ok": True,
            "max_abs_err": float((a - b).abs().max()),
            "tolerance": tol, "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if rows is not None:
        case.update({"busy_experts": busy, "filled_rows": filled})
    del a, b, ref, bad
    if time_it:
        xs = cold_copies(x, limit=4)
        lib = _library_ffn(act)
        case.update({
            "kernel_ms": device_ms(
                lambda t: moe_gmm(t, w1, w2, act=act, rows=rows), xs),
            "plain_ms": device_ms(
                lambda t: moe_gmm_ref(t, w1, w2, act=act, rows=rows),
                xs[:2]),
            "library_ms": device_ms(lambda t: lib(t, w1, w2), xs)})
        if rows is not None:
            case["kernel_no_rows_ms"] = device_ms(
                lambda t: moe_gmm(t, w1, w2, act=act), xs)
        case["achieved_tflops"] = flops / case["kernel_ms"] / 1e9
        case["achieved_GB_per_s"] = nbytes / case["kernel_ms"] / 1e6
    del x, w1, w2, out
    torch.cuda.empty_cache()
    return case


def moe_rows_case(torch, c, dtype, g):
    """``rows`` at olmoe's width: partial fills, experts at 0 rows, full
    ones.  The call with ``rows`` equals, bit for bit, the call without it
    on x zeroed past each fill, and the call with ``rows`` on x that holds
    tokens past each fill."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    E, D, Fh = OLMOE_E, OLMOE_D, OLMOE_F
    x = torch.randn(E, c, D, generator=g, device=DEVICE).to(dtype)
    w1 = (torch.randn(E, D, 2 * Fh, generator=g, device=DEVICE)
          * D ** -0.5).to(dtype)
    w2 = (torch.randn(E, Fh, D, generator=g, device=DEVICE)
          * Fh ** -0.5).to(dtype)
    rows = torch.randint(0, c + 1, (E,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    rows[::4] = 0                            # a quarter of them empty
    rows[1::8] = c                           # some full
    zeroed = torch.where(torch.arange(c, device=DEVICE)[None, :, None]
                         < rows[:, None, None], x, x.new_zeros(()))
    with_rows = moe_gmm(zeroed, w1, w2, rows=rows)
    without = moe_gmm(zeroed, w1, w2)
    past_fill = moe_gmm(x, w1, w2, rows=rows)
    torch.cuda.synchronize()
    dn = str(dtype).split(".")[1]
    if not (torch.equal(with_rows, without) and
            torch.equal(past_fill, without)):
        raise AssertionError(f"rows C={c} {dn}: the output with rows "
                             "differs from the output without them")
    del with_rows, without, past_fill, x
    case = moe_gmm_case(torch, f"olmoe_rows_c{c}_{dn}", E, c, D, Fh,
                        "swiglu", dtype, g, operands=(zeroed, w1, w2),
                        rows=rows, time_it=dtype == torch.bfloat16)
    case["bitwise_equal_to_no_rows"] = True
    return case


def served_decode_case(torch, g):
    """B4 on a served decode step's operands: ``moe_block`` at olmoe's
    width routes 8 tokens (one a decode slot) through a router drawn as
    the model's init draws it; the dispatch, the weights and ``rows`` are
    taken at the kernel's call, and the kernel is timed on them with and
    without ``rows``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import local_comm
    from repro_torch.models.common import truncated_normal_init
    from repro_torch.models.moe import moe_block
    cfg = get_config("olmoe-1b-7b")
    E, D, Fh = cfg.n_experts, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    cpu = torch.Generator().manual_seed(SEED + 9)
    p = {"router": truncated_normal_init(cpu, (D, E), 0.1, bf16,
                                         "cpu").to(DEVICE),
         "we_in": (torch.randn(E, D, 2 * Fh, generator=g, device=DEVICE)
                   * D ** -0.5).to(bf16),
         "we_out": (torch.randn(E, Fh, D, generator=g, device=DEVICE)
                    * Fh ** -0.5).to(bf16)}
    x = torch.randn(1, 8, D, generator=g, device=DEVICE).to(bf16)
    with _FillLog() as log:
        moe_block(x, p, cfg, local_comm())
    log.summary()                            # raises if rows were not passed
    xe, w1, w2, act, rows = log.last
    case = moe_gmm_case(torch, "olmoe_served_decode_rows_bfloat16", E,
                        xe.shape[1], D, Fh, act, bf16, g,
                        operands=(xe, w1, w2), rows=rows)
    case.update({"mean_fill": float(rows.float().mean() / xe.shape[1]),
                 "empty_expert_share": float((rows == 0).float().mean())})
    return case


def moe_kernel_phase(torch):
    """B4 over tests/test_kernels.py's sweep and at olmoe-1b-7b's shapes;
    B2 at olmoe's prefill shape and at a padded head dim."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    moe = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for act in ("swiglu", "geglu", "gelu", "relu2"):
            for e, c, d, f in ((4, 32, 48, 24), (2, 64, 32, 64)):
                moe.append(moe_gmm_case(
                    torch, f"sweep_{dn}_{act}_{e}x{c}x{d}x{f}", e, c, d, f,
                    act, dtype, g, w_scale=0.2, time_it=False))
        moe.append(moe_gmm_case(torch, f"ragged_{dn}_3x20x40x16", 3, 20, 40,
                                16, "swiglu", dtype, g, zero_expert=1,
                                time_it=False))
    # the tensor-core tiles' edges: the transposed decode tile (C <= 8,
    # C <= 16), the row tile past it, d and f multiples of 8 only
    for act in ("swiglu", "gelu"):
        for e, c, d, f in ((3, 1, 64, 64), (2, 9, 64, 128), (2, 16, 56, 24),
                           (2, 17, 64, 64), (2, 63, 72, 40),
                           (2, 65, 64, 192)):
            moe.append(moe_gmm_case(
                torch, f"edge_bfloat16_{act}_{e}x{c}x{d}x{f}", e, c, d, f,
                act, torch.bfloat16, g, time_it=False))
    E, D, Fh = OLMOE_E, OLMOE_D, OLMOE_F
    bf16 = torch.bfloat16
    moe.append(moe_gmm_case(torch, "olmoe_decode_bfloat16", E, 8, D, Fh,
                            "swiglu", bf16, g))
    moe.append(moe_gmm_case(torch, "olmoe_decode_float32", E, 8, D, Fh,
                            "swiglu", torch.float32, g))
    moe.append(moe_gmm_case(torch, "olmoe_prefill_bfloat16", E, 640, D, Fh,
                            "swiglu", bf16, g))
    moe.append(moe_gmm_case(torch, "olmoe_prefill_float32", E, 640, D, Fh,
                            "swiglu", torch.float32, g))
    for c in (8, 640):
        moe.append(moe_rows_case(torch, c, bf16, g))
    moe.append(moe_rows_case(torch, 8, torch.float32, g))
    moe.append(served_decode_case(torch, g))
    moe.append(moe_gmm_case(torch, "olmoe_ragged_c100_bfloat16", E, 100, D,
                            Fh, "swiglu", bf16, g, time_it=False))
    moe.append(moe_gmm_case(torch, "olmoe_decode_zero_expert_bfloat16", E,
                            8, D, Fh, "swiglu", bf16, g, zero_expert=5,
                            time_it=False))
    flash = [flash_case(torch, "olmoe_prefill_global_bfloat16", 4, 16, 16,
                        1024, 1024, 128, True, 0, 0, bf16, g)]
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[1]
        flash.append(flash_case(torch, f"padded_dh24_{dn}", 2, 4, 4, 100,
                                100, 24, True, 0, 0, dtype, g,
                                time_it=False))
    return moe, flash


# ---------------------------------------------------------------------------
# phase 11: the SSD scan (B5) against its plain version
# ---------------------------------------------------------------------------

SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:68"
#: the chunk length the operation count is taken at: fixed, so that B5's
#: bound does not move with a variant's own chunk (simt 64, tc 128)
SSD_FLOPS_CHUNK = 64
#: the variants of csrc/ssd_scan.cu, for the kernels line
SSD_DESIGN = {"tc": "bf16, P and N multiples of 16: chunk-parallel, L = "
                    "128, three launches: chunk states (B^T (w x) as a "
                    "bf16 hi + lo pair) with C.B^T once a group, the "
                    "float32 carry over the chunks, chunk outputs (C H_in "
                    "with H_in in bf16, M x with M in bf16); mma.sync "
                    "m16n8k16 on cp.async tiles",
              "simt": "float32 CUDA cores, L = 64, one block a (batch, "
                      "head, 32 columns of P) walking the chunks (float32 "
                      "and other bf16 shapes)"}
#: the tensor-core variant's three stages, one launch each a call
SSD_TC_STAGES = ("ssd_scan_chunk_kernel", "ssd_scan_carry_kernel",
                 "ssd_scan_out_kernel")
#: "tc" against the plain version of its own rounding (ssd_scan_tc_ref):
#: y within 4e-2 + 1e-2 |ref| (y's own bf16 rounding tipped the other
#: way, and one bf16 ulp of an M element tipped by the float32 sums' order
#: times x, which does not scale with y), the final state within 1e-4 +
#: 1e-4 |ref| (not rounded); tests/test_torch_cuda.py holds the same
SSD_TC_Y_ATOL, SSD_TC_Y_RTOL, SSD_TC_H_TOL = 4e-2, 1e-2, 1e-4


def ssd_flops(bs, h, s, p, g, n) -> int:
    """The chunked algorithm's useful work at :data:`SSD_FLOPS_CHUNK`:
    C.B^T once a (batch, group) over each chunk's causal pairs, the
    intra-chunk product with x, the incoming-state product and the state
    update (each 2 flops a multiply-add)."""
    L = SSD_FLOPS_CHUNK
    pairs = sum(lc * (lc + 1) // 2 for lc in
                (min(L, s - t0) for t0 in range(0, s, L)))
    return 2 * bs * (g * pairs * n + h * pairs * p + 2 * h * s * n * p)


def ssd_stages(torch, fn, sets, calls: int = 6) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` cycling through
    ``sets``: each B5 kernel's launches and device ms a call, by kernel
    name.  A profiler started after another one can miss its first
    kernels, so the calls recorded follow one warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule
    fn(sets[0])
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=calls,
                                    repeat=1)) as prof:
        for i in range(calls + 1):
            fn(sets[i % len(sets)])
            if i == calls:
                torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_scan_\w*?kernel", e.key)
        if m and e.device_type == DeviceType.CUDA:
            k = out.setdefault(m.group(0), {"launches_per_call": 0.0,
                                            "device_ms_per_call": 0.0})
            k["launches_per_call"] += e.count / calls
            k["device_ms_per_call"] += e.self_device_time_total / 1e3 / calls
    return out


def ssd_case(torch, label, bs, h, s, p, g, n, dtype, gen, *, chunk=128,
             with_h0=False, dt_scale=1.0, time_it=True, stages=False):
    """B5 on x (bs, h, s, p), dt (bs, h, s), b/c (bs, g, s, n) against the
    plain per-step recurrence, at tests/test_kernels.py::test_ssd_sweep's
    tolerance (5e-4 float32, 5e-2 bf16) and distributions (dt =
    softplus(N(0, 1)) times ``dt_scale``, x divided by it, so that the
    decays dt·A grow while dt·x, and so y and the rounding of its sums,
    stay at the sweep's scale); the final state at 5e-4.  A "tc" case is
    also held against ``ssd_scan_tc_ref`` at the tighter limits above.
    The timed cases also time the chunked plain version at the config's
    chunk ``chunk``, on the model's seq-major layout; with ``stages``, the
    variant's kernels are profiled one by one."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import (TC_CHUNK, ssd_scan_bhsp,
                                              ssd_scan_ref, ssd_scan_tc_ref,
                                              tc_scratch_bytes, variant_of)
    from repro_torch.models.ssm import ssd_chunked
    x = (torch.randn(bs, h, s, p, generator=gen, device=DEVICE) / dt_scale
         ).to(dtype)
    dt = F.softplus(torch.randn(bs, h, s, generator=gen,
                                device=DEVICE)) * dt_scale
    a_log = torch.randn(h, generator=gen, device=DEVICE) * 0.5
    b = (torch.randn(bs, g, s, n, generator=gen, device=DEVICE) * 0.3
         ).to(dtype)
    c = (torch.randn(bs, g, s, n, generator=gen, device=DEVICE) * 0.3
         ).to(dtype)
    d = torch.randn(h, generator=gen, device=DEVICE)
    h0 = (torch.randn(bs, h, n, p, generator=gen, device=DEVICE)
          if with_h0 else None)
    (y, h_final), kind = variant_of(
        lambda: ssd_scan_bhsp(x, dt, a_log, b, c, d, h0=h0))
    ref_y, ref_h = ssd_scan_ref(x, dt, a_log, b, c, d, h0=h0)
    torch.cuda.synchronize()
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    errs = [_close(f"{label} y", y, ref_y, dtype, tol, tol)[0],
            _close(f"{label} h_final", h_final, ref_h, dtype, 5e-4,
                   5e-4)[0]]
    tc_ref = {}
    if kind == "tc":
        tc_y, tc_h = ssd_scan_tc_ref(x, dt, a_log, b, c, d, h0=h0)
        ey, sy = _close(f"{label} y against the tc plain version", y, tc_y,
                        dtype, SSD_TC_Y_ATOL, SSD_TC_Y_RTOL)
        eh, sh = _close(f"{label} h_final against the tc plain version",
                        h_final, tc_h, dtype, SSD_TC_H_TOL, SSD_TC_H_TOL)
        tc_ref = {"tc_ref_max_abs_err": ey, "tc_ref_limit_share": sy,
                  "tc_ref_h_final_max_abs_err": eh,
                  "tc_ref_h_final_limit_share": sh}
        del tc_y, tc_h
    dname = str(dtype).split(".")[1]
    flops = ssd_flops(bs, h, s, p, g, n)
    nbytes = (x.nbytes + dt.nbytes + b.nbytes + c.nbytes + a_log.nbytes +
              d.nbytes + y.nbytes + h_final.nbytes +
              (h0.nbytes if with_h0 else 0))
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": label, "shape_x": [bs, h, s, p], "groups": g,
            "state": n, "dtype": dname, "h0": with_h0, "dt_scale": dt_scale,
            "ok": True, "variant": kind,
            "chunk": TC_CHUNK if kind == "tc" else 64,
            "scratch_bytes": tc_scratch_bytes(bs, h, s, p, g, n)
            if kind == "tc" else 0,
            "max_abs_err": errs[0], "h_final_max_abs_err": errs[1],
            "tolerance": tol, **tc_ref, "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
    del ref_y, ref_h
    if time_it:
        sets = cold_sets((x, dt, b, c))
        case["kernel_ms"] = device_ms(
            lambda t: ssd_scan_bhsp(t[0], t[1], a_log, t[2], t[3], d), sets)
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        if stages:
            st = ssd_stages(torch, lambda t: ssd_scan_bhsp(
                t[0], t[1], a_log, t[2], t[3], d), sets)
            want = SSD_TC_STAGES if kind == "tc" else ("ssd_scan_kernel",)
            if sorted(st) != sorted(want) or any(
                    v["launches_per_call"] != 1 for v in st.values()):
                raise AssertionError(f"{label}: a {kind} call launched "
                                     f"{st} (want one of each of {want})")
            case["stages"] = st
        # the plain chunked version, on the model's seq-major tensors
        seq = [(t[0].permute(2, 0, 1, 3).contiguous(),
                t[1].permute(2, 0, 1).contiguous(),
                t[2].permute(2, 0, 1, 3).contiguous(),
                t[3].permute(2, 0, 1, 3).contiguous()) for t in sets[:2]]
        case["plain_ms"] = device_ms(
            lambda t: ssd_chunked(t[0], t[1], a_log, t[2], t[3], d,
                                  chunk=chunk), seq)
        case["plain_chunk"] = chunk
        case["achieved_GB_per_s"] = nbytes / case["kernel_ms"] / 1e6
        case["achieved_tflops"] = flops / case["kernel_ms"] / 1e9
        del sets, seq
    del x, dt, b, c, y, h_final
    torch.cuda.empty_cache()
    return case


def ssd_kernel_phase(torch):
    """B5 over tests/test_kernels.py's sweep, at mamba2-370m's and
    hymba-1.5b's prefill shapes, a ragged s with h0 in and h_final out,
    s = 1 and a large dt; B2 at hymba's prefill shape; B3 at the two
    models' shapes.  Returns (ssd cases, flash cases, rmsnorm cases)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    f32, bf16 = torch.float32, torch.bfloat16
    ssd = []
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[1]
        for bs, h, s, p, g, n, chunk in ((2, 4, 64, 16, 2, 8, 16),
                                         (1, 4, 128, 32, 1, 16, 32),
                                         (3, 6, 48, 8, 3, 4, 16)):
            ssd.append(ssd_case(torch, f"sweep_{dn}_{bs}x{h}x{s}x{p}_g{g}"
                                f"_n{n}", bs, h, s, p, g, n, dtype, gen,
                                chunk=chunk, time_it=False))
    for dtype in (bf16, f32):
        dn = str(dtype).split(".")[1]
        ssd.append(ssd_case(torch, f"mamba2_prefill_{dn}", 4, 32, 2048, 64,
                            1, 128, dtype, gen, chunk=256,
                            stages=dtype == bf16))
        ssd.append(ssd_case(torch, f"hymba_prefill_{dn}", 4, 50, 2048, 64,
                            1, 16, dtype, gen, chunk=128,
                            stages=dtype == bf16))
    ssd.append(ssd_case(torch, "ragged_s1000_h0_bfloat16", 1, 32, 1000, 64,
                        1, 128, bf16, gen, with_h0=True, time_it=False))
    ssd.append(ssd_case(torch, "s1_h0_bfloat16", 4, 32, 1, 64, 1, 128, bf16,
                        gen, with_h0=True, time_it=False))
    for dtype in (f32, bf16):
        ssd.append(ssd_case(torch, f"large_dt_{str(dtype).split('.')[1]}",
                            2, 32, 2048, 64, 1, 128, dtype, gen,
                            dt_scale=40.0, time_it=False))
    flash = [flash_case(torch, f"hymba_prefill_{name}_bfloat16", 4, 25, 5,
                        2048, 2048, 64, True, window, 0, bf16, gen)
             for window, name in ((1024, "local1024"),
                                  (GEMMA_GLOBAL, "global"))]
    rms = [rmsnorm_case(torch, f"{name}_bfloat16_{rows}x{d}", rows, d, bf16,
                        gen)
           for name, rows, d in (("mamba2_prefill", 8192, 1024),
                                 ("mamba2_gated", 8192, 2048),
                                 ("hymba_prefill", 8192, 1600),
                                 ("hymba_gated", 8192, 3200),
                                 ("mamba2_decode_gated", 8, 2048))]
    return ssd, flash, rms


def _summary(cases, keys):
    return [{k: c.get(k) for k in keys} for c in cases]


def _rms_shapes(served) -> dict:
    """B3's launches by (rows, d) a prefill call and a decode step."""
    return {"prefill": served["prefill"]["rmsnorm_launches_by_shape"],
            "decode_per_step":
                served["decode"]["rmsnorm_launches_by_shape_per_step"]}


def _zero_counts(counters):
    """Every launch count to 0, B2's and B4's counts by variant and B3's
    by shape too."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "launches_by_variant"):
            c.launches_by_variant = dict.fromkeys(c.launches_by_variant, 0)
        if hasattr(c, "launches_by_shape"):
            c.launches_by_shape = {}


def _all_tc(path, fn, what="flash-attention") -> dict:
    """A kernel's launches by variant since the counts were set to 0;
    raises unless every one took the tensor-core variant."""
    by = dict(fn.launches_by_variant)
    if by["tc"] != fn.launches:
        raise AssertionError(f"the {path} path's {what} launches {by} were "
                             "not all tensor-core")
    return by


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of one prefill "
                         "call and 8 decode steps to phases 7, 10, 13 and "
                         "14")
    ap.add_argument("--spmd-rank", metavar="DIR",
                    help="run as one rank of phase 15's two-process run "
                         "(the SPMD launcher starts it), reporting to DIR")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if args.spmd_rank:
        return spmd_rank(args.spmd_rank)
    from repro_torch.kernels import _build
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_push,
                                              stage_copy_rows)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    counters = (stage_copy, stage_copy_rows, stage_copy_push,
                flash_attention_bhsd, rmsnorm, moe_gmm, ssd_scan_bhsp)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    record("device", card=card, torch=torch.__version__,
           cuda=torch.version.cuda, python=sys.version.split()[0],
           name=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count())

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {n: ptxas_report(b["ptxas"]) for n, b in built.items()}
    record("build", seconds=time.perf_counter() - t0,
           built=sorted(built), libraries=[
               os.path.relpath(_build.library_path(n), ROOT)
               for n in _build.SOURCES], ptxas=ptxas)
    # the tensor-core B2 and B5 kernels and every B1 and B3 instantiation
    tc_only = {"flash_attention": ("tc_kernel",), "ssd_scan": SSD_TC_STAGES}
    spilled = [k for lib in ("flash_attention", "doorbell", "rmsnorm",
                             "ssd_scan")
               for k in ptxas.get(lib, [])
               if (lib not in tc_only or
                   any(n in k["kernel"] for n in tc_only[lib]))
               and k["spill_stores"] + k["spill_loads"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")

    # 3. the doorbell kernel against its plain version
    cases = kernel_phase(torch)
    record("kernel_cases", cases=cases)

    # 4. the message path: counts set to 0 just before, read just after
    _zero_counts(counters)
    runs = [main_path_case(torch, label, kind, getattr(torch, dt), nbytes,
                           bf16)
            for label, kind, dt, nbytes, bf16 in MAIN_CASES]
    launches = stage_copy_rows.launches
    for r in runs:
        record("main_path", **r)
    if launches == 0 or stage_copy.launches or stage_copy_push.launches:
        raise AssertionError(f"the main path launched the gather "
                             f"{launches} times, the dense stage copy "
                             f"{stage_copy.launches} times and the push "
                             f"{stage_copy_push.launches} times (want only "
                             f"the gather)")

    # 5. flash attention (B2) and RMSNorm (B3) against their plain versions
    t0 = time.perf_counter()
    flash, rms = model_kernel_phase(torch)
    record("model_kernel_cases", seconds=time.perf_counter() - t0,
           flash_attention=flash, rmsnorm=rms)

    # 6. gemma3-1b at full width in float32: decode against forward
    t0 = time.perf_counter()
    parity = model_parity_phase(torch)
    record("model_parity", seconds=time.perf_counter() - t0, **parity)

    # 7. the dense serving path: counts set to 0 just before, read after
    rms_by_shape = {}
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "gemma3-1b", args.profile)
    rms_by_shape["gemma3-1b"] = _rms_shapes(served)
    n_flash, n_rms = flash_attention_bhsd.launches, rmsnorm.launches
    flash_by = {"gemma3-1b": _all_tc("serving", flash_attention_bhsd)}
    record("serving_main_path", seconds=time.perf_counter() - t0,
           flash_attention_launches=n_flash,
           flash_attention_launches_by_variant=flash_by["gemma3-1b"],
           rmsnorm_launches=n_rms, moe_gmm_launches=moe_gmm.launches,
           **served)
    if n_flash == 0 or n_rms == 0:
        raise AssertionError("the serving path launched no flash-attention "
                             "or RMSNorm kernel")

    # 8. the MoE grouped matmul (B4) against its plain version
    t0 = time.perf_counter()
    moe, flash_moe = moe_kernel_phase(torch)
    record("moe_kernel_cases", seconds=time.perf_counter() - t0,
           moe_gmm=moe, flash_attention=flash_moe)

    # 9. olmoe-1b-7b at full width in float32: decode against forward
    t0 = time.perf_counter()
    parity = model_parity_phase(torch, "olmoe-1b-7b")
    record("moe_model_parity", seconds=time.perf_counter() - t0, **parity)

    # 10. the moe serving path: counts set to 0 just before, read after
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "olmoe-1b-7b", args.profile)
    rms_by_shape["olmoe-1b-7b"] = _rms_shapes(served)
    m_flash, m_rms, n_moe = (flash_attention_bhsd.launches, rmsnorm.launches,
                             moe_gmm.launches)
    moe_by_variant = dict(moe_gmm.launches_by_variant)
    flash_by["olmoe-1b-7b"] = _all_tc("moe serving", flash_attention_bhsd)
    record("moe_serving_main_path", seconds=time.perf_counter() - t0,
           flash_attention_launches=m_flash,
           flash_attention_launches_by_variant=flash_by["olmoe-1b-7b"],
           rmsnorm_launches=m_rms, moe_gmm_launches=n_moe,
           moe_gmm_launches_by_variant=moe_by_variant, **served)
    if m_flash == 0 or m_rms == 0 or n_moe == 0:
        raise AssertionError("the moe serving path launched no "
                             "flash-attention, RMSNorm or MoE GMM kernel")
    if moe_by_variant["tc"] != n_moe:
        raise AssertionError(f"the moe serving path's B4 launches "
                             f"{moe_by_variant} were not all tensor-core")

    # 11. the SSD scan (B5) against its plain version
    t0 = time.perf_counter()
    ssd, flash_ssm, rms_ssm = ssd_kernel_phase(torch)
    record("ssd_kernel_cases", seconds=time.perf_counter() - t0,
           ssd_scan=ssd, flash_attention=flash_ssm, rmsnorm=rms_ssm)

    # 12. mamba2-370m at full width in float32: decode against forward
    t0 = time.perf_counter()
    parity = model_parity_phase(torch, "mamba2-370m")
    record("ssm_model_parity", seconds=time.perf_counter() - t0, **parity)

    # 13. the ssm serving path: counts set to 0 just before, read after
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "mamba2-370m", args.profile)
    rms_by_shape["mamba2-370m"] = _rms_shapes(served)
    s_rms, s_ssd = rmsnorm.launches, ssd_scan_bhsp.launches
    ssd_by = {"mamba2-370m": _all_tc("ssm serving", ssd_scan_bhsp,
                                     "SSD-scan")}
    record("ssm_serving_main_path", seconds=time.perf_counter() - t0,
           flash_attention_launches=flash_attention_bhsd.launches,
           rmsnorm_launches=s_rms, moe_gmm_launches=moe_gmm.launches,
           ssd_scan_launches=s_ssd,
           ssd_scan_launches_by_variant=ssd_by["mamba2-370m"], **served)
    if s_rms == 0 or s_ssd == 0:
        raise AssertionError("the ssm serving path launched no RMSNorm or "
                             "SSD-scan kernel")

    # 14. the hybrid serving path: counts set to 0 just before, read after
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "hymba-1.5b", args.profile)
    rms_by_shape["hymba-1.5b"] = _rms_shapes(served)
    y_flash, y_rms, y_ssd = (flash_attention_bhsd.launches, rmsnorm.launches,
                             ssd_scan_bhsp.launches)
    flash_by["hymba-1.5b"] = _all_tc("hybrid serving", flash_attention_bhsd)
    ssd_by["hymba-1.5b"] = _all_tc("hybrid serving", ssd_scan_bhsp,
                                   "SSD-scan")
    record("hybrid_serving_main_path", seconds=time.perf_counter() - t0,
           flash_attention_launches=y_flash,
           flash_attention_launches_by_variant=flash_by["hymba-1.5b"],
           rmsnorm_launches=y_rms, moe_gmm_launches=moe_gmm.launches,
           ssd_scan_launches=y_ssd,
           ssd_scan_launches_by_variant=ssd_by["hymba-1.5b"], **served)
    if y_flash == 0 or y_rms == 0 or y_ssd == 0:
        raise AssertionError("the hybrid serving path launched no "
                             "flash-attention, RMSNorm or SSD-scan kernel")

    # 15. the message path over shm and socket, under chaos, and across
    # two processes: counts set to 0 just before, read just after
    _zero_counts(counters)
    t0 = time.perf_counter()
    transports = transports_phase(torch, runs)
    t_launches = stage_copy_rows.launches
    p_launches = sum(r["kernel_launches"] for c in transports["processes"]
                     for r in c["ranks"])
    record("transports", seconds=time.perf_counter() - t0,
           kernel_launches_in_process=t_launches,
           kernel_launches_in_ranks=p_launches, **transports)
    if t_launches == 0 or p_launches == 0 or stage_copy.launches \
            or stage_copy_push.launches:
        raise AssertionError(f"the transports' path launched the gather "
                             f"{t_launches} times in process and "
                             f"{p_launches} times in the ranks, the dense "
                             f"stage copy {stage_copy.launches} times and "
                             f"the push {stage_copy_push.launches} times "
                             "(want only the gather)")

    # the kernels line: headline numbers at each main path's shape
    head = next(c for c in cases if c["case"] == "rows_f32_64x16384_bf160")
    fhead = next(c for c in flash
                 if c["case"] == "gemma3_prefill_local512_bfloat16")
    rhead = next(c for c in rms if c["case"] == "serve_bfloat16_8192x1152")
    mhead = next(c for c in moe if c["case"] == "olmoe_decode_bfloat16")
    mpre = next(c for c in moe if c["case"] == "olmoe_prefill_bfloat16")
    shead = next(c for c in ssd if c["case"] == "mamba2_prefill_bfloat16")
    shymba = next(c for c in ssd if c["case"] == "hymba_prefill_bfloat16")
    timed = ("case", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "max_abs_err")
    flash += flash_moe + flash_ssm
    rms += rms_ssm
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "doorbell.stage_copy_rows", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES,
        "launches": launches + t_launches + p_launches,
        "launches_by_path": {"message path (phase 4)": launches,
                             "transports (phase 15)": t_launches,
                             "two processes (phase 15)": p_launches},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": head["library_ms"], "shape": head["shape"],
        "call_ms": head["kernel_call_ms"], "pair_ms": head["pair_ms"],
        "dense_ms": head["dense_ms"],
        "cases": [{k: c.get(k) for k in (
            "case", "wrapper", "ok", "byte_exact", "launches", "kernel_ms",
            "pair_ms", "dense_ms", "plain_ms", "library_ms",
            "kernel_call_ms", "pair_call_ms", "pack_call_ms",
            "plain_call_ms", "bound_ms", "bound_share") if k in c}
            for c in cases]}, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": n_flash + m_flash + y_flash,
        "launches_by_path": {"gemma3-1b": n_flash, "olmoe-1b-7b": m_flash,
                             "mamba2-370m": 0, "hymba-1.5b": y_flash},
        "max_abs_err": max(c["max_abs_err"] for c in flash),
        "ms": fhead["kernel_ms"], "plain_ms": fhead["plain_ms"],
        "bound_ms": fhead["bound_ms"], "bound_by": fhead["bound_by"],
        "library_ms": fhead["library_ms"], "shape_q": fhead["shape_q"],
        "shape_kv": fhead["shape_kv"], "window": fhead["window"],
        "variant": fhead["variant"], "design": FLASH_DESIGN,
        "launches_by_variant": {
            k: sum(by[k] for by in flash_by.values()) for k in FLASH_DESIGN},
        "launches_by_variant_by_path": flash_by,
        "cases": _summary([c for c in flash if "kernel_ms" in c],
                          timed + ("variant", "kernel_bhsd_ms",
                                   "library_causal_ms",
                                   "library_causal_form", "achieved_tflops",
                                   "bound_share"))}, {
        "name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
        "replaces": RMS_REPLACES, "launches": n_rms + m_rms + s_rms + y_rms,
        "launches_by_path": {"gemma3-1b": n_rms, "olmoe-1b-7b": m_rms,
                             "mamba2-370m": s_rms, "hymba-1.5b": y_rms},
        "max_abs_err": max(c["max_abs_err"] for c in rms),
        "ms": rhead["kernel_ms"], "plain_ms": rhead["plain_ms"],
        "bound_ms": rhead["bound_ms"], "bound_by": "bytes",
        "library_ms": rhead["library_ms"], "shape": rhead["shape"],
        "launches_by_shape_by_path": rms_by_shape,
        "cases": _summary([c for c in rms if "kernel_ms" in c],
                          timed + ("copy_ms", "bound_share"))}, {
        "name": "moe_gmm", "route": "cuda", "source": MOE_SOURCE,
        "replaces": MOE_REPLACES, "launches": n_moe,
        "max_abs_err": max(c["max_abs_err"] for c in moe),
        "ms": mhead["kernel_ms"], "plain_ms": mhead["plain_ms"],
        "bound_ms": mhead["bound_ms"], "bound_by": mhead["bound_by"],
        "library_ms": mhead["library_ms"], "shape": mhead["shape_x"],
        "f": mhead["f"], "act": mhead["act"],
        "design": MOE_DESIGN, "launches_by_variant": moe_by_variant,
        "prefill": {k: mpre[k] for k in ("shape_x", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")},
        "cases": _summary([c for c in moe if "kernel_ms" in c],
                          timed + ("variant", "kernel_no_rows_ms"))}, {
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "launches": s_ssd + y_ssd,
        "launches_by_path": {"mamba2-370m": s_ssd, "hymba-1.5b": y_ssd},
        "max_abs_err": max(c["max_abs_err"] for c in ssd),
        "ms": shead["kernel_ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_ms"], "bound_by": shead["bound_by"],
        "library_ms": None, "shape_x": shead["shape_x"],
        "state": shead["state"], "plain_chunk": shead["plain_chunk"],
        "variant": shead["variant"], "chunk": shead["chunk"],
        "scratch_bytes": shead["scratch_bytes"], "stages": shead["stages"],
        "design": SSD_DESIGN, "launches_by_variant": {
            k: sum(by[k] for by in ssd_by.values()) for k in SSD_DESIGN},
        "launches_by_variant_by_path": ssd_by,
        "hymba": {k: shymba[k] for k in (
            "shape_x", "state", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "variant", "chunk", "scratch_bytes",
            "stages")},
        "cases": _summary([c for c in ssd if "kernel_ms" in c],
                          timed + ("variant", "bound_share",
                                   "tc_ref_limit_share",
                                   "tc_ref_h_final_limit_share"))}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
