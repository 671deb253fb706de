#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one GPU: the fused-doorbell
message path (over the sim, shm and socket transports, under chaos and
across two processes), gemma3-1b serving, olmoe-1b-7b (MoE) serving,
mamba2-370m (SSM) serving and hymba-1.5b (hybrid) serving at full width,
serving on the comm core (the reference's serve traffic), the in-graph
collectives with tensor-parallel serving on rank threads, the recovery
path (checkpoints, resharded restore, the 1F1B comm graph), training
at tp = 1 (the four families, data parallel on rank threads, the
pipeline, resume), the vlm and audio families (whisper-tiny and
llama-3.2-vision served through the cross-KV cache, and trained),
training at tp > 1 on rank threads (FSDP and tensor parallelism, the
sharded state, the launcher), the analysis tools, and olmo-1b,
minitron-8b, moonshot-v1-16b-a3b and command-r-plus-104b served at full
width.

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
2. the build, with ptxas' register and spill report (no B1, B3 or conv
   stage kernel and no tensor-core B2 or B5 kernel may spill);
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
   11b. the SSM conv stage (``csrc/ssm_conv.cu``: the causal depthwise
   conv, SiLU and the dt softplus in one launch) against its plain
   version on column views of a fused ``[z|x|dt]`` product, at
   mamba2-370m's prefill shapes (32 x 512 ... 4 x 4096), its training
   shape (32 x 2048) and hymba-1.5b's width, sequences shorter than the
   conv and ragged walks, bf16 and float32; the bf16
   cases at the benchmark's shapes timed beside the plain version and
   the bound;
12. mamba2-370m's full config in float32 (seeded random weights): decode
   against forward as in phase 6;
13. mamba2-370m's full config in bf16: ``make_prefill_step`` on 4 prompts
   of 2048 tokens (exactly 48 SSD-scan launches a call, every one on the
   "tc" variant, 48 conv-stage launches, and 97 RMSNorm launches:
   norm1 and the gated norm a layer, plus the final norm), then the serve
   launcher's loop as in phase 7 (97 RMSNorm and no SSD-scan launch a
   step);
14. hymba-1.5b's full config in bf16: prefill of 4 x 2048 tokens (exactly
   32 flash-attention and 32 SSD-scan launches, all "tc", 32 conv-stage
   launches, and 161
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
   drain every outstanding post as ERR_PEER_DEAD, shrink the mesh to
   (1, 1), restore rank 0's step-0 checkpoint resharded onto it with
   every leaf on the card (``restored_step=0``, ``ok_restore=True``) and
   exit 0 (phase 18c).  Every child runs under a wall-clock limit;
16. serving on the comm core (``ServePlane``, ``ContinuousBatcher``,
   ``TokenClient``, ``SyntheticModel`` on the card): first the doorbell
   gather byte for byte against its plain version at the path's rows
   (``ResultTokens.pack(...).wire_rows()`` on the card: bursts of 4, 41
   and 64 16-byte token rows, and one mixing two ticks' images as parked
   rows do); then the reference's open-loop serve traffic
   (``benchmarks/serve_traffic.py``'s ``make_workload`` and
   ``server_overrides``, ported here, seed 0): a) ``LocalCluster(2,
   device="cuda", fabric_depth=1<<15)`` on ``sim`` at c64 / 2 s and
   c1024 / 4 s; b) c128 / 2 s under ``chaos_drop=0.05``, and a
   closed-loop burst (24 streams at once into 8 slots) under it, which
   must fuse decode doorbells; c) the c128 / 2 s traffic and the burst
   across two OS processes on ``shm`` (``chip_smoke.py --serve-rank
   DIR --serve-cell traffic|burst``, rank 0 the client, rank 1 the
   server); each cell exactly-once (nothing lost, duplicated,
   mismatched or out of order, every stream equal to the oracle), one
   gather launch and no ``torch.stack`` a fused decode doorbell (a tick
   of 2 or 3 rows posts unfused with one stack) and no dense stage copy,
   no host sync on the server's tick
   (``torch.cuda.set_sync_debug_mode("warn")`` counts them) on ``sim``,
   and on ``shm`` one copy to the host a CUDA frame; TTFT, inter-token
   latency, goodput, slot occupancy,
   preemptions, retransmits and the share of decode bursts that fuse are
   recorded; d) the functional ``MatchTable`` / ``Ring`` / ``SyncState``
   mirrors on CUDA and CPU tensors, bitwise equal, with no host sync on
   the card; e) ``apps/kmer.py`` on a card-bound cluster at
   ``configs/paper.py``'s quick sizes, ranks 2 and 4, equal to its run
   on the CPU and exact on every repeated k-mer;
17. the in-graph collectives and tensor-parallel serving, on rank
   threads of ``LocalCluster(P, device="cuda")`` (``LciAxis`` through
   ``spmd_map``): a) every collective in every ``CommMode`` at P = 4
   with CUDA tensors at gemma3-1b's TP boundary of a 4 x 2048 prefill
   (the all-gather matmul of x (512, 4, 1152) with w (1152, 1728), the
   matmul reduce-scatter of (2048, 4, 1728) with (1728, 1152), the
   reduce-scatter, all-reduce and all-gather at those sizes) and
   olmoe-1b-7b's dispatch all-to-all (64 experts, capacity 160, d 2048),
   the barrier and the tree pair, float32 and bf16, ``wire_bf16`` off
   and on: the gathers, the all-to-all and the tree pair bitwise equal to
   the CPU call, every mode against the plain single-rank oracle, no
   host copy, host syncs counted (:func:`collectives_phase`); b) gemma3-1b
   at full width at tp = 2 (:func:`tp_gemma_phase`: f32 decode against
   tp = 1, bf16 prefill with B2 and B3 counted per rank thread where
   they launch, its last hidden state and tokens against tp = 1's);
   c) olmoe-1b-7b, mamba2-370m and hymba-1.5b at 2 layers, full width,
   tp = 2, forward against tp = 1 (:func:`tp_small_phase`);
   d) ``tp2d_decode.py``'s configs, classic, tp2d and ``joint_kv``, on a
   (2 x 2) mesh (:func:`tp2d_phase`).  Every kernel call of a-d is kept
   by signature (:class:`_PathCalls`), and after the counts are read each
   kernel is held against its plain version at every one
   (:func:`path_kernel_checks`: B4 and B1 on the path's own operands);
18. the recovery path: a) gemma3-1b's bf16 params at full width through
   the checkpoint store (:func:`recovery_checkpoint_phase`): the
   reference tokens from a 4 x 2048 prefill of ``SyntheticPipeline``'s
   batch of step 3; ``save_sync``, then ``save_async`` while 8 launcher
   decode steps run, beside 8 with no commit; ``restore`` bitwise, the
   batch of ``manifest["meta"]["next_step"]`` replayed to a bitwise equal
   last hidden state and equal tokens; ``restore_resharded`` onto a
   (1, 2) mesh, each rank's leaves bitwise its shards, and its tp = 2
   prefill against tp = 1 under 17b's gate (26 B2 and 105 B3 launches a
   rank thread); the snapshot, write-and-hash, commit and restore seconds
   and GB/s, decode ms a step with and without a commit in flight;
   b) ``build_1f1b_comm_graph`` on ``LocalCluster(4, device="cuda")``, 8
   microbatches, payloads of 32 B and 1 179 648 B
   (:func:`pipeline_comm_phase`): landing buffers equal to the marker
   chain, the partial order, ``schedule_1f1b``'s critical path
   2 (S - 1) + 2 M and each of its edges held by the comm graph's compute
   nodes, no payload byte through the host; wall ms a graph, messages by
   protocol; c) phase 15's chaos-kill demo and its resharded restore.
   Every kernel call of a-b is kept by signature and held against its
   plain version after the counts are read;
19. training on the card at tp = 1 (``train/step.py``'s step: the loss,
   backward through the kernels' ``autograd.Function``s, whose backward
   is the plain version's autograd, grad sync, clip, AdamW over the
   float32 master): a) each wrapper in bf16 at the training shapes of b
   and c (:func:`train_kernel_checks`): the gradients of the backward it
   records (the plain version's autograd, which the kernel's output does
   not enter) against autograd of the plain version in float32, within
   :data:`GRAD_TOL`, every B2 / B4 / B5 case on its tensor-core variant;
   b) gemma3-1b at full width, 4 x 2048 tokens, remat on, 8
   steps on one fixed batch (:func:`train_run`): losses finite and
   decreasing, every step's B2 and B3 launches exactly the forward's,
   the remat recompute's and the final norm's (:func:`_train_want`),
   step ms, tokens/s, peak memory, MFU (:func:`model_flops`), and under
   ``--profile`` the device's busy share; c) mamba2-370m and hymba-1.5b
   at full depth, mamba2-370m at 4 of its 48 layers and olmoe-1b-7b at 4
   of its 16, 2 x 1024 tokens, 4 steps each, the same gates, the
   full-depth mamba2-370m's losses held finite only
   (:data:`TRAIN_FAMILIES`); d) dp = 2 rank threads on one card and
   ``PipelinedModel`` (:func:`train_dp_phase`); e) ``train_loop`` resumed
   from a step-3 checkpoint bitwise equal to a straight run, under
   ``torch.use_deterministic_algorithms(True)``
   (:func:`train_resume_phase`).  Every kernel call of b-e is kept by
   signature and each kernel held against its plain version at every
   one after the counts are read (:func:`path_kernel_checks`);
20. the vlm and audio families (:func:`cross_phase`), bf16: a)
   whisper-tiny at its full configuration (4 encoder and 4 decoder
   layers, d 384, 1500 stub frames, batch 4): the encoder, the cross-KV
   (``precompute_cross_kv``), a 64-token prompt's prefill, then the
   prompt teacher-forced through ``make_serve_step`` and 16 greedy
   steps; then the same weights in float32: the decode against the
   forward over the same tokens (phase 6's gate), and the bf16 decode's
   logits no further from that float32 forward than twice the bf16
   forward's, its tokens float32's argmax beyond a tie threshold set by
   the bf16 forward's error (:func:`bf16_decode_gate`); b)
   llama-3.2-vision at full width cut to 10 layers (8 self + 2 gated
   cross; the 100-layer model's bf16 weights exceed the card), the gates
   0.5, 1600 stub image tokens, batch 2, a 128-token prompt, the same
   steps and gates, and other image embeddings moving the logits; c) a
   training step (remat, AdamW) of whisper-tiny at full width and of
   llama-3.2-vision at its smoke widths; every call's B2 and B3
   launches checked (:func:`cross_want`), every kernel call of a-c kept
   by signature and held against its plain version; d) B2 at the new signatures
   (whisper's unmasked encoder and cross-attention, the vision model's
   causal self- and unmasked cross-attention) and B3 at (rows, 8192) and
   (rows, 384), timed beside the bound and the library call, and the
   recorded backward at the unmasked training signatures.  The phase
   prints each model's prefill ms, decode ms a step, training step ms
   and peak memory beside the card's name and power limit;
21. training at tp > 1 on rank threads of the one card
   (:func:`tp_training_phase`; the backward is the rank thread's tape,
   ``distributed/spmd_autograd.py``: no collective runs in an autograd
   node): a) every ``Comm`` method's transpose on P = 2 and 4 rank
   threads, float32 and bf16, at 17a's sizes, against autograd of the
   plain single-rank oracle, no host copy, host syncs counted
   (:func:`tp_transpose_phase`); b) gemma3-1b at its full config on
   (1, 2): a float32 step's loss and gradients against tp = 1's, a bf16
   step's gradients against float32 (tp = 1's bf16 distance the
   witness), then 3 launcher steps on the state cut over the mesh, the
   B2 and B3 launches a rank thread exact, step ms, tokens/s, peak
   memory (:func:`tp_train_gemma_phase`); c) olmoe-1b-7b, mamba2-370m
   and hymba-1.5b at 2 layers on (2, 2) and whisper-tiny on (1, 2), a
   float32 step against tp = 1 (:func:`tp_train_families_phase`); d)
   the train launcher at ``--mesh 2x2`` and a checkpoint resharded from
   (2, 2) to (4, 1) (:func:`tp_train_launch_phase`).  Every kernel call
   of b-d is kept by signature and held against its plain version;
22. the analysis tools against the card (:func:`analysis_phase`): a)
   the dry run (``launch/dryrun.py``, the meta device) against real
   calls at a (1, 1) mesh (:func:`dryrun_card_case`): gemma3-1b's bf16
   training step and prefill at 4 x 2048, olmoe-1b-7b's prefill at 4 x
   1024 and mamba2-370m's at 4 x 2048; ``count_costs`` around the card's
   call equals the meta count exactly (flops, dot_bytes, each kernel's
   launches, flops and bytes), the argument bytes equal the real state's
   exactly, and the predicted peak (arguments + temp) lies within
   :data:`PEAK_BAND` of ``max_memory_allocated`` over the counted call;
   the ms, the roofline bound and the counted FLOPs beside
   :func:`model_flops` printed; b) one gemma3-1b bf16 step at tp = 2 on
   (1, 2) rank threads: each rank's recorded collectives (bytes by kind,
   ppermute bytes and steps by direction) equal the dry run's on an
   abstract (1, 2) mesh (:func:`collectives_card_case`); c) ``dryrun
   --all`` on both production meshes on the card's host, 33 cells ok
   and 7 skipped on each, under :data:`DRYRUN_ALL_S` seconds; d) each
   ``examples/torch_*.py`` on the card in a subprocess (``chip_smoke.py
   --example``, which keeps its kernel calls by signature), printing
   its OK line; every kernel call of a, b and d is held against its
   plain version;
23. the four configs no earlier phase ran, at full width
   (:func:`configs_phase`): olmo-1b (LayerNorm without weights, tied
   head), minitron-8b (GQA 32 / 8 at head dim 128, LayerNorm, relu2),
   moonshot-v1-16b-a3b (64 experts of f = 1408, top-6, the shared
   expert) and command-r-plus-104b (GQA 96 / 8, the parallel block,
   ``rope_theta`` 7.5e7, the tied 256000-row head): each through phase
   6's float32 gates at :data:`CONFIGS23`'s depth, then phase 7's bf16
   prefill (4 x 2048; moonshot 4 x 1024) and launcher loop, launches
   exact a prefill call and a decode step, every B2 and B4 launch "tc",
   no payload copy to the host; the depth cuts (:data:`CUTS23`; bf16
   moonshot the layers that fit, drawn by :func:`layerwise_init`), the
   prefill and decode ms and the peak memory printed beside the card's
   name and power limit; every kernel call held against its plain
   version after each run.

The launch counts are set to 0 just before phases 4, 7, 10, 13, 14, 15,
16 (after its kernel check), 17a, 17b, 18, 19b, 20a, 21a, 21b, 22 and
each run of 23 and read just after; the serving phases
also record B3's launches by (rows, d) a prefill call and a decode
step.  Every phase raises on failure;
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

# the card's peak figures (H100 SXM 80GB data sheet) live in one place:
# HBM3's rate for the bandwidth bound, the dense bf16 / float32 rates
from repro_torch.launch.costs import HBM_BYTES_PER_S, PEAK_FLOPS  # noqa: E402
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
    as ERR_PEER_DEAD, shrink the mesh to (1, 1), restore rank 0's step-0
    checkpoint resharded onto it with every leaf on the card, and exit 0
    (the launcher's own exit code)."""
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
    restored = [ln for ln in text.splitlines()
                if "spmd-chaos rank 0: recovered in " in ln]
    if r.returncode != 0 or not lines or "other=0 hung=0" not in lines[0] \
            or "peer_dead=0 " in lines[0] or not restored or (
                "new_mesh=(1, 1) restored_step=0 on cuda" not in restored[0]
                or "ok_restore=True" not in restored[0]):
        raise AssertionError(f"the chaos-kill demo failed ({r.returncode}):"
                             f"\n{text}")
    return {"backend": "shm", "hb_timeout_s": HB_TIMEOUT,
            "seconds": time.perf_counter() - t0, "survivor": lines[0],
            "recovery": restored[0]}


# ---------------------------------------------------------------------------
# phase 16: serving on the comm core
# ---------------------------------------------------------------------------

#: the reference's open-loop serving traffic (benchmarks/serve_traffic.py),
#: ported here: vocab, prompt and output length clips, deadlines
SERVE_VOCAB = 32000
PROMPT_CLIP = (4, 256)
OUTPUT_CLIP = (1, 64)
SUBMIT_DEADLINE_S = 60.0
DRAIN_DEADLINE_S = 120.0
#: (clients, arrival-window seconds) of the sim cells, the reference's
#: c64 / 2 s and its full default c1024 / 4 s; the chaos cell and the
#: two-process shm cell at c128 / 2 s
SERVE_CELLS = ((64, 2.0), (1024, 4.0))
SERVE_CHAOS = (128, 2.0, 0.05)
SERVE_XPROC = (128, 2.0)
SERVE_CHILD_TIMEOUT = 180.0
#: the closed-loop burst cells (tests/test_torch_batching.py's
#: test_chaos_burst_serve_matches_reference): 24 streams submitted at
#: once into 8 slots, so that decode bursts fuse whatever the tick's
#: timing; run on sim under chaos_drop and across two processes on shm
SERVE_BURST = 24
SERVE_BURST_OVERRIDES = {"kv_slots": 8, "kv_page_tokens": 8}
#: the fused decode bursts the gather is held at, in rows of 16 bytes: the
#: smallest that fuses, the c1024 cell's largest and a full 64-slot tick
SERVE_GATHER_K = (4, 41, 64)
KMER_SEED = 3           # benchmarks/kmer.py's


def make_workload(n_clients: int, duration: float, seed: int):
    """The reference's open-loop schedule: Poisson arrivals (uniform
    order statistics conditioned on N) with lognormal heavy-tailed
    prompt and output lengths."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0.0, duration, n_clients))
    plens = np.clip(rng.lognormal(2.8, 1.0, n_clients),
                    *PROMPT_CLIP).astype(int)
    outs = np.clip(rng.lognormal(1.4, 0.9, n_clients),
                   *OUTPUT_CLIP).astype(int)
    prompts = [rng.integers(0, SERVE_VOCAB, p).astype(np.int32)
               for p in plens]
    return arrivals, prompts, outs


def server_overrides(n_clients: int) -> dict:
    """The reference's engine geometry scaled to the cell."""
    slots = max(8, min(64, n_clients // 8))
    return {"kv_slots": slots, "kv_page_tokens": 16,
            "kv_pages": 16 * slots, "prefill_chunk": 32}


def burst_workload(seed: int = 11):
    """The closed-loop burst: ``SERVE_BURST`` streams that all arrive at
    once, prompts of 1-39 tokens and 4-11 new tokens each."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(1, 40, SERVE_BURST)
    outs = rng.integers(4, 12, SERVE_BURST)
    prompts = [rng.integers(0, SERVE_VOCAB, p).astype(np.int32)
               for p in plens]
    return np.zeros(SERVE_BURST), prompts, outs


def serve_workload(cell: str):
    """``(clients, window seconds, (arrivals, prompts, outputs), engine
    overrides)`` of a two-process cell: ``traffic`` is the reference's
    open-loop c128 / 2 s, ``burst`` the closed-loop burst."""
    if cell == "burst":
        return SERVE_BURST, 0.0, burst_workload(), SERVE_BURST_OVERRIDES
    n, duration = SERVE_XPROC
    return n, duration, make_workload(n, duration, SEED), \
        server_overrides(n)


class _DecodeBursts:
    """Records the size of every ``post_am_many`` the server's decode
    endpoint rings, and the ``torch.stack`` calls made inside it while a
    :class:`_StackCount` is installed (``stack``).  A burst of
    ``fused_min_burst`` rows or more is a fused doorbell, which the
    doorbell gather stages in one launch a 256 rows, with no stack; a
    shorter one posts unfused: a lone row is cloned, and 2 or 3 rows take
    one ``torch.stack`` copy (``fabric.py::payloads_to_bytes``)."""

    def __init__(self, server):
        from repro_torch.kernels.doorbell.ops import ROWS_PER_LAUNCH
        self.per_launch = ROWS_PER_LAUNCH
        self.sizes, self.stacks = [], []
        self.stack = None
        self.fused_min = server.runtime.fused_min_burst
        ep = server.decode_ep
        real = ep.post_am_many

        def counted(rank, bufs, *a, **kw):
            s0 = self.stack.calls if self.stack else 0
            try:
                return real(rank, bufs, *a, **kw)
            finally:
                self.sizes.append(len(bufs))
                self.stacks.append((self.stack.calls if self.stack else 0)
                                   - s0)
        ep.post_am_many = counted

    def summary(self) -> dict:
        fused = [k for k in self.sizes if k >= self.fused_min]
        split = {True: 0, False: 0}
        for k, n in zip(self.sizes, self.stacks):
            split[k >= self.fused_min] += n
        return {"decode_doorbells": len(self.sizes),
                "fused_decode_doorbells": len(fused),
                "fused_share": len(fused) / max(len(self.sizes), 1),
                "rows_in_fused": sum(fused),
                "max_burst": max(self.sizes, default=0),
                "launches_wanted": sum(-(-k // self.per_launch)
                                       for k in fused),
                "torch_stack_calls_fused": split[True],
                "torch_stack_calls_unfused": split[False]}


class _SyncCount:
    """Counts the host syncs the card reports while installed
    (``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing
    CUDA call warns)."""

    def __init__(self, torch):
        self.torch, self.calls, self.where = torch, 0, []

    def __enter__(self):
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        hits = [w for w in self._seen
                if "called a synchronizing" in str(w.message)]
        self.calls = len(hits)
        self.where = sorted({f"{w.filename}:{w.lineno}" for w in hits})


class _Occupancy:
    """Time-throttled samples of the slot allocator's occupancy."""

    def __init__(self, slots, period_s: float = 2e-3):
        self.slots, self.period, self.samples, self._last = \
            slots, period_s, [], 0.0

    def tick(self) -> None:
        now = time.perf_counter()
        if now - self._last >= self.period:
            self.samples.append(self.slots.occupancy())
            self._last = now

    def result(self) -> dict:
        if not self.samples:
            return {"mean": 0.0, "peak": 0.0}
        return {"mean": float(np.mean(self.samples)),
                "peak": float(np.max(self.samples))}


def _percentiles(xs, scale: float):
    if not len(xs):
        return 0.0, 0.0
    arr = np.asarray(xs) * scale
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


def _serve_metrics(report: dict, wall: float) -> dict:
    """The reference's serve-traffic numbers of one cell."""
    ttft = _percentiles(report["ttft_s"], 1e3)
    gap = _percentiles(report["gap_s"], 1e6)
    return {"ttft_p50_ms": ttft[0], "ttft_p99_ms": ttft[1],
            "tok_p50_us": gap[0], "tok_p99_us": gap[1],
            "goodput_tok_s": report["tokens"] / wall if wall > 0 else 0.0,
            "tokens": report["tokens"], "wall_s": wall}


def _exactly_once(case: str, report: dict, n_clients: int) -> dict:
    bad = {k: report[k] for k in ("lost", "duplicated", "mismatched",
                                  "out_of_order", "bad_done", "unexpected")
           if report[k]}
    if bad or report["submitted"] != n_clients \
            or report["completed"] != report["submitted"]:
        raise AssertionError(f"{case}: exactly-once contract violated: "
                             f"submitted {report['submitted']}, completed "
                             f"{report['completed']}, {bad}")
    return {k: report[k] for k in ("submitted", "completed", "lost",
                                   "duplicated", "mismatched",
                                   "out_of_order", "submit_retries")}


def serve_gather_cases(torch) -> list:
    """B1 at the serve plane's own shapes against its plain version.  A
    fused decode burst is K 16-byte uint8 rows, each a view of one tick's
    wire image (``ResultTokens.pack(...).wire_rows()`` on the card), and
    rows parked from an older tick's image join the next burst ahead of
    the new ones.  For K in ``SERVE_GATHER_K`` and for one burst that
    mixes two ticks' images, ``stage_copy_rows`` must equal
    ``stage_copy_rows_ref`` byte for byte in one launch; the K = 41
    burst is also timed.  The rest of a tick's device work (the unfused
    stack and clone, a first-token row) runs once, so that a cell's first
    requests do not pay the process's first launches.  Launches the
    gather: run it before the counts are set to 0."""
    from repro_torch.kernels.doorbell import (stage_copy_rows,
                                              stage_copy_rows_ref)
    from repro_torch.serving import (ResultTokens, SyntheticModel,
                                     encode_token_row)
    from repro_torch.serving.result_tokens import ROW_BYTES
    model = SyntheticModel(seed=SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 20)

    def tick(k, n_slots=64):
        """one decode tick's k wire rows, slots in random order"""
        slots = [int(x) for x in rng.permutation(n_slots)[:k]]
        rids = [int(x) for x in rng.integers(1, 1 << 20, k)]
        toks = model.decode(rids, [int(x) for x in rng.integers(4, 320, k)])
        res = ResultTokens.pack(
            slots, rids, toks, [int(x) for x in rng.integers(1, 65, k)],
            [int(x) for x in rng.integers(0, 2, k)], n_slots)
        return [row for _, row in res.wire_rows()]

    bursts = [(f"serve_rows_u8_{k}x{ROW_BYTES}", tick(k))
              for k in SERVE_GATHER_K]
    older, newer = tick(6), tick(30)
    bursts.append((f"serve_rows_u8_mixed_3+30x{ROW_BYTES}",
                   older[::2] + newer))
    cases = []
    for label, rows in bursts:
        n0 = stage_copy_rows.launches
        out = stage_copy_rows(rows)
        got = stage_copy_rows.launches - n0
        ref = stage_copy_rows_ref(rows)
        torch.cuda.synchronize()
        if got != 1 or tuple(out.shape) != (len(rows), ROW_BYTES):
            raise AssertionError(f"{label}: {got} gather launches, wire "
                                 f"image {tuple(out.shape)}")
        case = {"case": label, "wrapper": "stage_copy_rows",
                "shape": [len(rows), ROW_BYTES], "dtype": "uint8",
                "wire_bf16": False, "ok": True, "byte_exact": True,
                "max_abs_err": compare(label, out, ref, torch.uint8, False),
                "launches": got}
        if len(rows) == 41:
            sets = [tick(41) for _ in range(16)]
            nbytes = len(rows) * ROW_BYTES
            case.update({
                "kernel_ms": device_ms(stage_copy_rows, sets),
                "plain_ms": device_ms(stage_copy_rows_ref, sets),
                "library_ms": device_ms(torch.stack, sets),
                "kernel_call_ms": call_ms(stage_copy_rows, sets),
                "bound_ms": bound_ms(nbytes, nbytes)})
            case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        cases.append(case)
    rows = bursts[0][1]
    torch.stack(rows[:2])
    rows[0].clone()
    encode_token_row(1, 0, model.decode([1], [0])[0], 0)
    torch.cuda.synchronize()
    return cases


def serve_cell(torch, card, n_clients, duration, chaos_drop=0.0,
               burst=False):
    """One cell on ``LocalCluster(2, device="cuda")`` over ``sim``: the
    reference's open-loop serve traffic, or with ``burst`` the
    closed-loop burst, which must fuse decode doorbells.  The client
    submits on the schedule, the server steps between arrivals, and the
    run drains every token.  The whole traffic runs under the sync
    counter and the ``torch.stack`` counter; the client's streams are
    checked against the oracle only after the run
    (``TokenClient.collect``)."""
    from repro_torch.core import LocalCluster
    from repro_torch.kernels.doorbell import stage_copy, stage_copy_rows
    from repro_torch.serving import (ContinuousBatcher, ServePlane,
                                     SyntheticModel, TokenClient)
    if burst:
        n_clients, duration = SERVE_BURST, 0.0
        arrivals, prompts, outs = burst_workload()
        overrides = SERVE_BURST_OVERRIDES
        case = f"c{n_clients}/burst"
    else:
        arrivals, prompts, outs = make_workload(n_clients, duration, SEED)
        overrides = server_overrides(n_clients)
        case = f"c{n_clients}/d{duration:g}"
    attrs = {}
    if chaos_drop:
        attrs = {"chaos_drop": chaos_drop, "chaos_seed": SEED + 1}
        case += "/chaos_drop"
    cl = LocalCluster(2, device=DEVICE, attrs=attrs, fabric_depth=1 << 15)
    try:
        plane = ServePlane(cl)
        model = SyntheticModel(seed=SEED, device=DEVICE)
        server = ContinuousBatcher(plane, model, **overrides)
        client = TokenClient(plane, model, drain_workers=2)
        bursts = _DecodeBursts(server)
        occ = _Occupancy(server.slots)
        launches0, dense0 = stage_copy_rows.launches, stage_copy.launches
        with _StackCount(torch) as stack, _SyncCount(torch) as syncs:
            bursts.stack = stack
            t0 = time.perf_counter()
            for i in range(n_clients):
                while time.perf_counter() - t0 < arrivals[i]:
                    server.step()
                    occ.tick()
                rid, st = client.submit(prompts[i], int(outs[i]))
                deadline = time.monotonic() + SUBMIT_DEADLINE_S
                while st.is_retry():
                    server.step()
                    occ.tick()
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{case}: submit wedged at "
                                             f"client {i}")
                    rid, st = client.submit(prompts[i], int(outs[i]),
                                            rid=rid)
            deadline = time.monotonic() + DRAIN_DEADLINE_S
            while not (server.completed >= n_clients and server.idle):
                server.step()
                occ.tick()
                if time.monotonic() > deadline:
                    raise AssertionError(f"{case}: server stalled: "
                                         f"{server.counters()}")
            while client.drain.drained < client.expected_tokens:
                client.pump()
                if time.monotonic() > deadline:
                    break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report = client.collect()
        launches = stage_copy_rows.launches - launches0
        dense = stage_copy.launches - dense0
        b = bursts.summary()
        rel = [rt.rel.counters()["retransmits"] for rt in cl.runtimes
               if rt.rel is not None]
        counters = server.counters()
        rec = {"case": case, "backend": "sim", "card": card,
               "clients": n_clients, "duration_s": duration,
               "closed_loop_burst": burst, "chaos_drop": chaos_drop,
               **_exactly_once(case, report, n_clients),
               **_serve_metrics(report, wall),
               "slot_occupancy_mean": occ.result()["mean"],
               "slot_occupancy_peak": occ.result()["peak"],
               "preemptions": counters["preemptions"],
               "retransmits": sum(rel), "server": counters,
               "kernel_launches": launches, **b,
               "dense_stage_copy_launches": dense,
               "torch_stack_calls": stack.calls,
               "host_syncs_on_server_tick": syncs.calls,
               "host_sync_sites": syncs.where}
        # one gather a fused decode doorbell and no stack in one; the only
        # stacks on the tick are those of unfused 2- and 3-row bursts
        if launches != b["launches_wanted"] or dense \
                or (burst and not b["fused_decode_doorbells"]) \
                or b["torch_stack_calls_fused"] \
                or stack.calls != b["torch_stack_calls_unfused"]:
            raise AssertionError(f"{case}: {launches} gather launches for "
                                 f"{b['fused_decode_doorbells']} fused "
                                 f"decode doorbells (want "
                                 f"{b['launches_wanted']}), {dense} dense "
                                 f"stage copies, {stack.calls} torch.stack "
                                 f"calls ({b['torch_stack_calls_fused']} in "
                                 "fused doorbells)")
        if syncs.calls:
            raise AssertionError(f"{case}: {syncs.calls} host syncs on the "
                                 f"server's tick at {syncs.where}")
        if server.completed != n_clients:
            raise AssertionError(f"{case}: the server completed "
                                 f"{server.completed} of {n_clients}")
        return rec
    finally:
        cl.close()


def serve_xproc_case(card, cell: str = "traffic"):
    """A cross-process cell (``serve_workload(cell)``): two ranks of
    ``chip_smoke.py --serve-rank`` through the port's SPMD launcher on
    ``shm``, rank 0 the client and rank 1 the server, both on the one
    card."""
    import shutil
    import tempfile
    from repro_torch.launch import spmd
    outdir = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    n_clients, duration, _, _ = serve_workload(cell)
    t0 = time.perf_counter()
    try:
        code = spmd.launch([sys.executable, os.path.abspath(__file__),
                            "--serve-rank", outdir, "--serve-cell", cell],
                           2, backend="shm", timeout=SERVE_CHILD_TIMEOUT,
                           env={"PYTHONPATH": _src_path()})
        frags = {}
        for r in range(2):
            path = os.path.join(outdir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    frags[r] = json.load(f)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if code != 0 or len(frags) != 2:
        raise AssertionError(f"the two-process serve cell exited {code} "
                             f"with {len(frags)} rank reports: {frags}")
    client, server = frags[0], frags[1]
    case = (f"c{n_clients}/burst" if cell == "burst"
            else f"c{n_clients}/d{duration:g}") + "/xproc/shm"
    rec = {"case": case, "backend": "shm", "card": card,
           "clients": n_clients, "duration_s": duration,
           "closed_loop_burst": cell == "burst",
           **_exactly_once(case, client["report"], n_clients),
           **client["metrics"],
           "slot_occupancy_mean": server["occupancy"]["mean"],
           "slot_occupancy_peak": server["occupancy"]["peak"],
           "preemptions": server["counters"]["preemptions"],
           "retransmits": 0, "server": server["counters"],
           **{k: server[k] for k in (
               "kernel_launches", "decode_doorbells",
               "fused_decode_doorbells", "fused_share", "rows_in_fused",
               "max_burst", "launches_wanted", "torch_stack_calls",
               "torch_stack_calls_fused", "torch_stack_calls_unfused",
               "dense_stage_copy_launches", "frames_encoded",
               "cuda_frames_encoded", "copies_to_host", "copies_to_card")},
           "seconds": time.perf_counter() - t0}
    if server["counters"]["completed"] != n_clients:
        raise AssertionError(f"{case}: the server completed "
                             f"{server['counters']['completed']}")
    return rec


def serve_rank(outdir, cell: str) -> int:
    """One rank of a two-process serve cell (rank 0 the client, rank 1
    the server, over ``shm``): writes its fragment to ``outdir``.  The
    server gates one gather a fused decode doorbell (and, in the burst
    cell, at least one fused decode doorbell) and one copy to the host a
    CUDA frame; the client sends the end-of-traffic message only after
    draining every expected token."""
    import torch
    from repro_torch.core import ProcessCluster
    from repro_torch.kernels.doorbell import stage_copy, stage_copy_rows
    from repro_torch.launch.spmd import bootstrap
    from repro_torch.serving import (ContinuousBatcher, ServePlane,
                                     SyntheticModel, TokenClient)
    ctx = bootstrap()
    n_clients, duration, workload, overrides = serve_workload(cell)
    cl = ProcessCluster(ctx.n_ranks, ctx.rank, fabric_depth=1 << 15,
                        session=os.path.join(ctx.session, "serve"),
                        device=DEVICE)
    plane = ServePlane(cl, client_rank=0, server_rank=1)
    model = SyntheticModel(seed=SEED, device=DEVICE)
    if ctx.rank == 1:
        serve_gather_cases(torch)    # before the client starts its clock
    ctx.barrier(timeout=60)
    if ctx.rank == 1:
        server = ContinuousBatcher(plane, model, **overrides)
        bursts = _DecodeBursts(server)
        occ = _Occupancy(server.slots)
        launches0, dense0 = stage_copy_rows.launches, stage_copy.launches
        wire0 = _wire_counts()
        deadline = time.monotonic() + duration + DRAIN_DEADLINE_S
        with _StackCount(torch) as stack:
            bursts.stack = stack
            while not (server.eot_seen and server.idle):
                server.step()
                occ.tick()
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve rank 1: stalled "
                                         f"{server.counters()}")
        torch.cuda.synchronize()
        frames, cuda, to_host, to_card = _since(wire0)
        out = {"role": "server", "counters": server.counters(),
               "occupancy": occ.result(),
               "kernel_launches": stage_copy_rows.launches - launches0,
               "dense_stage_copy_launches": stage_copy.launches - dense0,
               "frames_encoded": frames, "cuda_frames_encoded": cuda,
               "copies_to_host": to_host, "copies_to_card": to_card,
               "torch_stack_calls": stack.calls, **bursts.summary()}
        # one gather and no stack a fused decode doorbell; every CUDA
        # frame (a burst or a lone row) crosses to the host once
        if out["kernel_launches"] != out["launches_wanted"] \
                or (cell == "burst" and not out["fused_decode_doorbells"]) \
                or out["dense_stage_copy_launches"] or not cuda \
                or out["torch_stack_calls_fused"] \
                or stack.calls != out["torch_stack_calls_unfused"] \
                or to_host != cuda or to_card:
            raise AssertionError(f"serve rank 1: {out}")
    else:
        client = TokenClient(plane, model, drain_workers=2)
        arrivals, prompts, outs = workload
        t0 = time.perf_counter()
        for i in range(n_clients):
            while time.perf_counter() - t0 < arrivals[i]:
                client.pump()
            rid, st = client.submit(prompts[i], int(outs[i]))
            deadline = time.monotonic() + SUBMIT_DEADLINE_S
            while st.is_retry():
                client.pump()
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve rank 0: submit wedged at "
                                         f"client {i}")
                rid, st = client.submit(prompts[i], int(outs[i]), rid=rid)
        deadline = time.monotonic() + DRAIN_DEADLINE_S
        while client.drain.drained < client.expected_tokens:
            client.pump()
            if time.monotonic() > deadline:
                raise AssertionError("serve rank 0: tokens never drained")
        wall = time.perf_counter() - t0
        client.send_eot()
        for _ in range(200):                 # flush the EOT
            client.pump()
        report = client.collect()
        out = {"role": "client",
               "report": {k: v for k, v in report.items()
                          if k not in ("ttft_s", "gap_s")},
               "metrics": _serve_metrics(report, wall)}
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(out, f)
    ctx.barrier(timeout=60)
    cl.close()
    ctx.close()
    return 0


def mirrors_case(torch):
    """The functional mirrors: one seeded sequence of ``insert_batch``
    (duplicate keys, both kinds), ``probe_batch`` (duplicates), ring
    pushes and pops past full and empty, and sync signals past the
    payload's slots, on CUDA tensors and on CPU tensors, compared
    bitwise; the CUDA run under the sync counter."""
    from repro_torch.core import (encode_key, init_ring, init_sync,
                                  init_table, insert_batch, pending_count,
                                  probe_batch, ring_pop, ring_push,
                                  ring_size, sync_ready, sync_signal)
    rng = np.random.default_rng(SEED + 16)
    pool = np.array([int(encode_key(r, t)) for r in range(8)
                     for t in range(8)] + [2**31 - 1, -5, 0x3FFF0000],
                    np.int32)
    n = 256
    keys = pool[rng.integers(0, len(pool), n)]
    kinds = rng.integers(1, 3, n).astype(np.int32)
    vals = rng.integers(0, 1 << 30, n).astype(np.int32)
    probes = pool[rng.integers(0, len(pool), 128)]
    ring_ops = rng.random(96) < 0.55
    records = rng.normal(size=(96, 4)).astype(np.float32)

    def inputs(dev):
        return [torch.from_numpy(x).to(dev)
                for x in (keys, kinds, vals, probes, records)]

    def run(dev, keys, kinds, vals, probes, recs):
        t = init_table(64, 8, device=dev)
        t, m, s = insert_batch(t, keys, kinds, vals)
        t, pv, ph = probe_batch(t, probes, 1)
        ring = init_ring(16, 4, torch.float32, device=dev)
        outs = []
        for i, push in enumerate(ring_ops):
            if push:
                ring, st = ring_push(ring, recs[i])
                outs.append(st)
            else:
                ring, rec, st = ring_pop(ring)
                outs += [rec, st]
        sync = init_sync(40, 4, device=dev)
        for rec in recs[:48]:
            sync = sync_signal(sync, rec)
        return [t.keys, t.kinds, t.vals, m, s, pv, ph, pending_count(t),
                ring.buf, ring.head, ring.tail, ring_size(ring),
                sync.received, sync.payload, sync_ready(sync)] + outs

    on_dev = inputs(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _SyncCount(torch) as syncs:      # the mirrors' calls only
        on_card = run(DEVICE, *on_dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    on_cpu = run("cpu", *inputs("cpu"))
    wrong = [i for i, (a, b) in enumerate(zip(on_card, on_cpu))
             if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    if wrong:
        raise AssertionError(f"the functional mirrors differ across "
                             f"devices at outputs {wrong}")
    if syncs.calls:
        raise AssertionError(f"the functional mirrors synced the host "
                             f"{syncs.calls} times at {syncs.where}")
    hits = int(on_cpu[6].sum())
    return {"case": "functional_mirrors", "inserts": n,
            "matched": int((on_cpu[3] >= 0).sum()),
            "bucket_full": int((on_cpu[4] == 2).sum()), "probes": 128,
            "probe_hits": hits, "ring_ops": int(len(ring_ops)),
            "sync_signals": 48, "bitwise_equal": True,
            "host_syncs": syncs.calls, "card_s": card_s}


def kmer_case(torch, n_ranks):
    """``run_kmer_count`` on a card-bound cluster at ``configs/paper.py``'s
    quick sizes and the reference benchmark's seed
    (``benchmarks/kmer.py``), exact twice over: the histogram and the
    message counts equal the port's run on the CPU (which
    ``tests/test_torch_kmer.py::test_quick_size_histogram_matches_reference``
    holds equal to the reference package's at this size), and every k-mer
    that occurs twice or more is counted as ``reference_count`` counts it;
    the Bloom filter's false positives, k-mers counted once, are
    reported."""
    from repro_torch.apps.kmer import (generate_reads, reference_count,
                                       run_kmer_count)
    from repro_torch.configs.paper import PAPER
    reads = generate_reads(PAPER.kmer_reads // 4, PAPER.kmer_read_len,
                           seed=KMER_SEED)
    runs = {dev: run_kmer_count(reads, PAPER.kmer_k, n_ranks,
                                agg_bytes=PAPER.kmer_agg_bytes, device=dev)
            for dev in (DEVICE, "cpu")}
    (hist, stats), (cpu_hist, cpu_stats) = runs[DEVICE], runs["cpu"]
    counts = (stats.messages, stats.bytes_sent, stats.aggregation_flushes)
    cpu_counts = (cpu_stats.messages, cpu_stats.bytes_sent,
                  cpu_stats.aggregation_flushes)
    if hist != cpu_hist or counts != cpu_counts:
        raise AssertionError(f"k-mer counts on {n_ranks} ranks differ "
                             f"between the card and the CPU: "
                             f"{len(hist)} vs {len(cpu_hist)} k-mers, "
                             f"{counts} vs {cpu_counts}")
    oracle = reference_count(reads, PAPER.kmer_k)
    missing = sum(1 for k in oracle if hist.get(k, 0) != oracle[k])
    extra = {k: n for k, n in hist.items() if k not in oracle}
    if missing or any(n != 1 for n in extra.values()):
        raise AssertionError(f"k-mer counts on {n_ranks} ranks: {missing} "
                             f"of {len(oracle)} repeated k-mers wrong, "
                             f"extra {extra}")
    return {"case": f"kmer_ranks{n_ranks}", "reads": len(reads),
            "k": PAPER.kmer_k, "repeated_kmers": len(oracle),
            "exact": True, "equal_to_cpu_run": True,
            "bloom_false_positives": len(extra),
            "messages": stats.messages, "bytes_sent": stats.bytes_sent,
            "aggregation_flushes": stats.aggregation_flushes,
            "elapsed_s": stats.elapsed_s}


def serve_phase(torch, card):
    """a) the sim cells; b) the chaos cells, the reference's traffic and
    the closed-loop burst; c) the two-process shm cells, the same two;
    d) the functional mirrors across devices; e) the k-mer app."""
    out = {"cells": []}
    t0 = time.perf_counter()
    for n, dur in SERVE_CELLS:
        out["cells"].append(serve_cell(torch, card, n, dur))
    n, dur, drop = SERVE_CHAOS
    for burst in (False, True):
        out["cells"].append(serve_cell(torch, card, n, dur, chaos_drop=drop,
                                       burst=burst))
        if not out["cells"][-1]["retransmits"]:
            raise AssertionError(f"{out['cells'][-1]['case']} retransmitted "
                                 "nothing: the faults did not fire")
    out["sim_s"] = time.perf_counter() - t0
    out["cells"] += [serve_xproc_case(card, cell)
                     for cell in ("traffic", "burst")]
    out["mirrors"] = mirrors_case(torch)
    out["kmer"] = [kmer_case(torch, r) for r in (2, 4)]
    return out


# ---------------------------------------------------------------------------
# phase 5: flash attention (B2) and RMSNorm (B3) against their plain versions
# ---------------------------------------------------------------------------

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
        # no mask at all (cross-attention, the encoder): the library's
        # unmasked call, the same work
        if not causal and window == 0:
            fn, inputs, form = _causal_sdpa(xs, causal=False)
            case["library_unmasked_ms"] = device_ms(fn, inputs)
            case["library_unmasked_form"] = form
        case["achieved_tflops"] = flops / case["kernel_ms"] / 1e9
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
    return case


def _causal_sdpa(xs, causal: bool = True):
    """``F.scaled_dot_product_attention(..., is_causal=causal)`` over the
    (q, k, v) tuples ``xs``, with no mask: (the call, its inputs, the
    form).  The form is ``enable_gqa`` where the chosen backend takes
    it, else k and v are expanded to q's heads here, outside the timed
    calls (a GQA shape then reads hq / hkv times the kv bytes)."""
    import torch
    import torch.nn.functional as F
    q, k, v = xs[0]
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=True)
        torch.cuda.synchronize()
        return (lambda t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], is_causal=causal, enable_gqa=True)), xs, \
            "enable_gqa"
    except RuntimeError:
        g = q.shape[1] // k.shape[1]
        return (lambda t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], is_causal=causal)), [
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


def _decode_vs_forward(torch, cfg, params, tokens, extras=None):
    """Teacher-forced ``make_serve_step`` over every position against
    ``forward``'s greedy tokens, and ``make_prefill_step``'s token
    against forward's last position.  A vlm or audio config's
    ``extras`` (its image embeddings or frames) go to forward and
    prefill, and the decode cache carries their cross-KV
    (``precompute_cross_kv``; whisper's memory from the port's encoder).
    Returns the record and forward's logits (s, b, V)."""
    from repro_torch.distributed import local_comm
    from repro_torch.models import lm
    from repro_torch.models.blocks import tp_plan
    from repro_torch.models.layers import greedy_sample, lm_head_logits
    from repro_torch.models.registry import build_model
    from repro_torch.serving import (init_cache, make_prefill_step,
                                     make_serve_step)
    from repro_torch.serving.engine import precompute_cross_kv
    comm = local_comm()
    batch = {"tokens": tokens, **(extras or {})}
    x, aux = build_model(cfg, device=DEVICE).forward(params, batch)
    head = params.get("lm_head", params["emb"])
    logits = lm_head_logits(x, head, comm, real_vocab=cfg.vocab)
    oracle = greedy_sample(logits, comm)
    top2 = logits.topk(2, dim=-1).values
    step = make_serve_step(cfg)
    s, b = tokens.shape
    if cfg.n_cross_layers:
        with torch.no_grad():
            mem = (lm._encode(params, batch, cfg, comm, tp_plan(cfg, 1),
                              remat=False) if cfg.is_encdec
                   else batch["image_embeds"])
        cache = init_cache(cfg, s, b, n_memory=mem.shape[0], device=DEVICE)
        cache.cross_k, cache.cross_v = precompute_cross_kv(params, mem, cfg)
    else:
        cache = init_cache(cfg, s, b, device=DEVICE)
    preds = []
    for i in range(s):
        nxt, cache = step(params, cache, tokens[i])
        preds.append(nxt)
    preds = torch.stack(preds)
    p_tok, last = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    if not torch.isfinite(x).all() or not torch.isfinite(last).all():
        raise AssertionError(f"{cfg.name} f32: non-finite hidden states")
    return {"decode_vs_forward_agreement":
            float((preds == oracle).float().mean()),
            "prefill_token_equals_forward": bool(torch.equal(p_tok,
                                                             oracle[-1])),
            "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min()),
            "mismatches": int((preds != oracle).sum()),
            "forward_aux": {k: float(v) for k, v in aux.items()}}, logits


def _parity_gate(label: str, res: dict) -> None:
    """Phase 6's float32 gate on a :func:`_decode_vs_forward` record:
    decode agrees with forward on more than 0.95 of the tokens, and
    prefill's token is forward's at the last position."""
    agree = res["decode_vs_forward_agreement"]
    if agree <= 0.95:
        raise AssertionError(f"{label} f32: decode agrees with forward on "
                             f"{agree:.3f} of tokens (needs > 0.95)")
    if not res["prefill_token_equals_forward"]:
        raise AssertionError(f"{label} f32: prefill token differs from "
                             "forward's last position")


def model_parity_phase(torch, arch: str = "gemma3-1b", layers=None):
    """``arch``'s full config in float32 (``layers``: its first layers
    only), the port's own seeded init on the card: teacher-forced
    ``make_serve_step`` over 32 positions (plain decode attention)
    against ``forward``'s greedy tokens (the flash-attention kernel), and
    ``make_prefill_step``'s token against forward's last position.

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
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
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
                                                           params, tokens)[0]}
        gated = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        out["gated_capacity_factor"] = gated.capacity_factor
    res, _ = _decode_vs_forward(torch, gated, params, tokens)
    out.update(res)
    _parity_gate(arch, res)
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
    "gemma3-1b": dict(batch=4, seq=2048, flash=26, rms=105, moe=0, ssd=0,
                      conv=0),
    "olmoe-1b-7b": dict(batch=4, seq=1024, flash=16, rms=65, moe=16, ssd=0,
                        conv=0),
    "mamba2-370m": dict(batch=4, seq=2048, flash=0, rms=97, moe=0, ssd=48,
                        conv=48),
    "hymba-1.5b": dict(batch=4, seq=2048, flash=32, rms=161, moe=0, ssd=32,
                       conv=32),
}


#: phase 23's configs: the prefill batch and prompt length; the kernel
#: launches of a prefill call a layer (B2, B3, B4; B3 adds the final norm
#: where the config's norm is RMSNorm); the layers of the float32 parity
#: run and of the bf16 run (None: all, the port's own init; "fit": as
#: many as the card holds, reckoned from its free memory by
#: :func:`_fitting_layers`), each cut named in :data:`CUTS23`
CONFIGS23 = {
    "olmo-1b": dict(batch=4, seq=2048, flash=1, rms=0, moe=0,
                    f32_layers=None, bf16_layers=None),
    "minitron-8b": dict(batch=4, seq=2048, flash=1, rms=0, moe=0,
                        f32_layers=None, bf16_layers=None),
    "moonshot-v1-16b-a3b": dict(batch=4, seq=1024, flash=1, rms=2, moe=1,
                                f32_layers=12, bf16_layers="fit"),
    "command-r-plus-104b": dict(batch=4, seq=2048, flash=1, rms=0, moe=0,
                                f32_layers=4, bf16_layers=8),
}
#: why each config's depth is cut (the card's 80 GB)
CUTS23 = {
    "moonshot-v1-16b-a3b": "float32: 12 of 48 layers (2.35 GB a layer, "
                           "~31 GB with the embeddings); bf16: the layers "
                           "that fit beside 12 GB of working memory",
    "command-r-plus-104b": "float32: 4 of 64 layers (6.3 GB a layer, the "
                           "tied 256000-row head 12.6 GB: ~38 GB); bf16: 8 "
                           "of 64 (3.15 GB a layer, ~32 GB with the head; "
                           "all 64 would be 208 GB)",
}
WORK23_BYTES = 12 << 30       # working memory kept free beside the weights


def _serving_want(arch: str, n_layers: int) -> dict:
    """A serving path's batch, prompt length and kernel launches a
    prefill call (phases 7, 10, 13, 14 at full depth; phase 23 at
    ``n_layers``)."""
    if arch in SERVING:
        return SERVING[arch]
    w = CONFIGS23[arch]
    return dict(batch=w["batch"], seq=w["seq"], flash=w["flash"] * n_layers,
                rms=w["rms"] * n_layers + (1 if w["rms"] else 0),
                moe=w["moe"] * n_layers, ssd=0, conv=0)


def _layer_bytes(torch, cfg):
    """(bytes of one layer's params, of the rest, of one layer's init
    draw at its peak: the float32 draw and its scaled copy beside the
    result) for ``cfg``, from its meta shapes."""
    import dataclasses
    from repro_torch.models.registry import build_model
    one, _ = build_model(dataclasses.replace(cfg, n_layers=1),
                         device="meta").abstract_params()
    layer = sum(t.numel() * t.element_size()
                for t in one["layers"].values())
    rest = sum(t.numel() * t.element_size() for k, t in one.items()
               if k != "layers")
    draw = max(t.numel() for t in one["layers"].values()) * (
        8 + torch.tensor([], dtype=cfg.dtype).element_size())
    return layer, rest, draw


def _fitting_layers(torch, cfg) -> int:
    """The most of ``cfg``'s layers whose params, drawn by
    :func:`layerwise_init`, fit in the card's free memory beside
    ``WORK23_BYTES`` of working memory."""
    layer, rest, draw = _layer_bytes(torch, cfg)
    free, _ = torch.cuda.mem_get_info()
    fit = (free - WORK23_BYTES - rest - draw - layer) // layer
    return max(1, min(cfg.n_layers, int(fit)))


def layerwise_init(torch, cfg, seed: int):
    """``cfg``'s params, each layer drawn by the port's init of a one-layer
    stack (``models/lm.py::_init_layer_stack``, layer ``i`` from seed
    ``seed + i``; the embeddings, head, final norm and layer 0 from
    ``build_model(...).init(seed)`` of a one-layer config) into the
    stacked buffers: at its peak the full-depth params and one layer's
    draw, where one draw of every stacked tensor holds each in float32
    twice (``models/common.py``'s truncated normal) and moonshot's
    48-layer expert stacks would need ~93 GB."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.models.common import ParamFactory
    from repro_torch.models.registry import build_model
    params, _ = build_model(dataclasses.replace(cfg, n_layers=1),
                            device=DEVICE).init(seed)
    first = params["layers"]
    stacks = {k: torch.empty((cfg.n_layers,) + tuple(v.shape[1:]),
                             dtype=v.dtype, device=DEVICE)
              for k, v in first.items()}
    for k, v in first.items():
        stacks[k][0].copy_(v[0])
    params["layers"] = stacks
    del first
    for i in range(1, cfg.n_layers):
        gen = torch.Generator(device=DEVICE).manual_seed(seed + i)
        one = lm._init_layer_stack(ParamFactory(gen, cfg.dtype,
                                                fsdp=cfg.fsdp_params),
                                   cfg, 1)
        for k, v in one.items():
            stacks[k][i].copy_(v[0])
        del one
    return params


def _rms_by_shape(before: dict) -> dict:
    """B3's launches by (rows, d) since the snapshot ``before`` of
    ``rmsnorm.launches_by_shape``, keyed "ROWSxD"."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {f"{r}x{d}": n - before.get((r, d), 0)
            for (r, d), n in sorted(rmsnorm.launches_by_shape.items())
            if n > before.get((r, d), 0)}


def _counts():
    """Launches of B2, B3, B4, B4's tensor-core variant, B5, B2's
    tensor-core variant, B5's tensor-core variant and the SSM conv
    stage's kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.kernels.ssm_conv import ssm_conv
    return (flash_attention_bhsd.launches, rmsnorm.launches,
            moe_gmm.launches, moe_gmm.launches_by_variant["tc"],
            ssd_scan_bhsp.launches,
            flash_attention_bhsd.launches_by_variant["tc"],
            ssd_scan_bhsp.launches_by_variant["tc"], ssm_conv.launches)


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


def serving_phase(torch, arch: str, profile: bool, layers=None):
    """``make_prefill_step`` on the config's prompts, then the serve
    launcher's loop (``ServeScheduler`` + ``make_serve_step``), with
    ``arch``'s full config in bf16 (``layers``: its first layers only,
    drawn layer by layer: :func:`layerwise_init`).  Launch counts are
    checked per prefill call and per decode step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.launch.serve import PROMPT_LEN, serve
    from repro_torch.models.registry import build_model
    from repro_torch.serving import make_prefill_step
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    want = _serving_want(arch, cfg.n_layers)
    pb, ps = want["batch"], want["seq"]
    # every B2, B4 and B5 launch of a bf16 path takes the tensor-core
    # variant
    per_call = (want["flash"], want["rms"], want["moe"], want["moe"],
                want["ssd"], want["flash"], want["ssd"], want["conv"])
    model = build_model(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = (layerwise_init(torch, cfg, SEED) if layers is not None
              else model.init(SEED)[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
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
                                 f"flash tensor-core, SSD scan tensor-core, "
                                 f"SSM conv) {got} times (want {per_call})")
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
    nf, nr, nm, ntc, ns, _, _, nc = (b - a for a, b in zip(c0, _counts()))
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
    if nf or ns or nc:
        raise AssertionError("decode launched the prefill attention, the "
                             "SSD-scan or the SSM conv-stage kernel")
    if out["completed"] != SERVE_ARGS["requests"] or any(
            r is None or len(r) != SERVE_ARGS["max_new"] or
            not ((r >= 0) & (r < cfg.vocab)).all() for r in out["results"]):
        raise AssertionError(f"{arch} decode: a request did not complete "
                             "with max_new valid tokens")
    rec = {"config": cfg.name, "dtype": "bfloat16", "layers": cfg.n_layers,
           "params": sum(int(t.numel()) for t in _leaves(params)),
           "init_s": init_s, "init_peak_memory_bytes": init_peak,
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
                       "ssm_conv_launches_per_call": want["conv"],
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


def profile_phase(torch, cfg, params, tokens, extras=None, cache=None):
    """``--profile`` only: torch.profiler over one prefill call and over
    8 decode steps: device time by kernel, summed, against wall time, and
    the float32 -> bf16 cast kernels' launches; then a second prefill
    with ``Tensor.to`` watched, for where those casts come from.
    ``extras`` joins the prefill's batch (a vlm or audio config's stub);
    ``cache`` (at least 12 positions) replaces the launcher's cache."""
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
    batch = {"tokens": tokens, **(extras or {})}
    prefill(params, batch)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    out = {"prefill_call": split(prof, wall)}
    with _CastLog() as casts:
        prefill(params, batch)
        torch.cuda.synchronize()
    out["prefill_cast_sites"] = casts.sites
    step = make_serve_step(cfg)
    b = SERVE_ARGS["max_batch"] if cache is None else cache.k.shape[2]
    if cache is None:
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


# ---------------------------------------------------------------------------
# phase 11b: the SSM conv stage against its plain version
# ---------------------------------------------------------------------------

CONV_SOURCE = "src/repro_torch/csrc/ssm_conv.cu"
CONV_REPLACES = ("none: the reference's conv stage is plain jnp "
                 "(src/repro/models/ssm.py: _causal_conv, silu, softplus)")
CONV_DESIGN = ("one launch a call: a thread owns 16 bytes of channels of one "
               "sequence and walks 64 time steps in 4-step tiles, the next "
               "tile's rows in flight while it computes this one, the K-1 "
               "halo rows in registers as the sliding window; float32 "
               "products and sums in the plain order, rounded once; one more "
               "block row for dt's softplus; the fused product's column "
               "views read through their row stride")
#: the conv stage's cases: (label, bs, s, d_inner, row, dt heads, timed):
#: mamba2-370m's prefill sweep of the benchmark and its training shape,
#: hymba-1.5b's width, sequences shorter than the conv (K = 4) and ragged
#: walks
CONV_CASES = [
    ("mamba2_prefill_32x512", 32, 512, 2048, 4160, 32, True),
    ("mamba2_prefill_16x1024", 16, 1024, 2048, 4160, 32, True),
    ("mamba2_prefill_8x2048", 8, 2048, 2048, 4160, 32, True),
    ("mamba2_prefill_4x4096", 4, 4096, 2048, 4160, 32, True),
    ("mamba2_train_32x2048", 32, 2048, 2048, 4160, 32, True),
    ("hymba_prefill_4x2048", 4, 2048, 3200, 6464, 50, True),
    ("short_s1", 3, 1, 2048, 4160, 32, False),
    ("short_s2", 3, 2, 3200, 6464, 50, False),
    ("ragged_s37", 2, 37, 2048, 4160, 32, False),
    ("ragged_s133", 3, 133, 3200, 6464, 50, False),
]


def conv_case(torch, label, bs, s, di, row, h, dtype, gen, *, time_it=True):
    """The conv stage on the column views of a fresh (s, bs, row) fused
    product (xs columns di..2 di, dt_raw 2 di..2 di + h), one launch a
    call, against the float32 plain version on the same values: float32
    within 4e-7 |ref| (the plain float32 arithmetic in its order; only
    another build's ``expf`` could round an ulp apart), bf16 within 2^-7
    |ref| (that result rounded once: an ulp of float32 can tip the bf16
    rounding); dt within 4e-7 |ref|; bf16 also against the plain bf16
    version within its own roundings (2K - 1 bf16 unit roundoffs, 2^-8,
    of the conv's absolute sum, times SiLU's slope of at most 1.1, plus
    an ulp of the output).  The timed cases time the kernel, the plain
    version and the bound by CUDA-graph replay beyond L2."""
    from repro_torch.kernels.ssm_conv import (CONV_WIDTH, causal_conv,
                                              ssm_conv, ssm_conv_ref)
    zxdt = torch.randn(s, bs, row, generator=gen, device=DEVICE).to(dtype)

    def views(z):
        return z[..., di:2 * di], z[..., 2 * di:2 * di + h]
    xs, dt_raw = views(zxdt)
    conv_w = (torch.randn(CONV_WIDTH, di, generator=gen, device=DEVICE)
              * 0.5).to(dtype)
    dt_bias = torch.randn(h, generator=gen, device=DEVICE) - 2
    before = ssm_conv.launches
    y, dt = ssm_conv(xs, dt_raw, conv_w, dt_bias)
    if ssm_conv.launches != before + 1:
        raise AssertionError(f"{label}: {ssm_conv.launches - before} "
                             "launches (want 1)")
    y32, dt32 = ssm_conv_ref(xs.float(), dt_raw.float(), conv_w.float(),
                             dt_bias)
    plain_y, plain_dt = ssm_conv_ref(xs, dt_raw, conv_w, dt_bias)
    torch.cuda.synchronize()
    rel = 4e-7 if dtype == torch.float32 else 2 ** -7
    err = (y.float() - y32).abs()
    share = float((err / (rel * y32.abs() + 1e-30)).max())
    dt_err = (dt - dt32).abs()
    dt_share = float((dt_err / (4e-7 * dt32.abs() + 1e-30)).max())
    plain_err = (y.float() - plain_y.float()).abs()
    if dtype == torch.bfloat16:
        absum = causal_conv(xs.float().abs(), conv_w.float().abs())
        plain_limit = (1.1 * (2 * CONV_WIDTH - 1) * 2 ** -8 * absum
                       + 2 ** -7 * y32.abs())
    else:
        plain_limit = rel * y32.abs() + 1e-30
    plain_share = float((plain_err / plain_limit).max())
    if not (share <= 1 and dt_share <= 1 and plain_share <= 1):
        raise AssertionError(
            f"{label} {dtype}: y {float(err.max())} ({share} of its limit "
            f"to the float32 plain version), dt {float(dt_err.max())} "
            f"({dt_share}), y against the plain version {plain_share} of "
            "its limit")
    dname = str(dtype).split(".")[1]
    nbytes = (2 * xs.numel() * xs.element_size()
              + dt_raw.numel() * dt_raw.element_size() + conv_w.nbytes
              + dt_bias.nbytes + dt.nbytes)
    case = {"case": f"{label}_{dname}", "shape": [s, bs, di], "row": row,
            "dt_heads": h, "dtype": dname, "ok": True,
            "max_abs_err": float(err.max()),
            "limit_share_float32_plain": share,
            "bitwise_float32_plain": bool(torch.equal(y, y32.to(dtype))),
            "dt_max_abs_err": float(dt_err.max()),
            "dt_bitwise": bool(torch.equal(dt, dt32)),
            "plain_max_abs_err": float(plain_err.max()),
            "limit_share_plain": plain_share, "bytes": nbytes,
            "bound_ms": bound_ms(nbytes, 0), "bound_by": "bytes",
            "library_ms": None}
    del y, dt, y32, dt32, plain_y, plain_dt, err, dt_err, plain_err
    if time_it:
        sets = cold_sets((zxdt,))
        case["kernel_ms"] = device_ms(
            lambda t: ssm_conv(*views(t[0]), conv_w, dt_bias), sets)
        case["plain_ms"] = device_ms(
            lambda t: ssm_conv_ref(*views(t[0]), conv_w, dt_bias), sets[:4])
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        case["achieved_GB_per_s"] = nbytes / case["kernel_ms"] / 1e6
        del sets
    del zxdt, xs, dt_raw
    torch.cuda.empty_cache()
    return case


def conv_kernel_phase(torch):
    """Phase 11b: :data:`CONV_CASES` in bf16 (the timed ones timed) and
    float32 (untimed)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    return [conv_case(torch, label, bs, s, di, row, h, dtype, gen,
                      time_it=timed and dtype == torch.bfloat16)
            for dtype in (torch.bfloat16, torch.float32)
            for label, bs, s, di, row, h, timed in CONV_CASES]


def _summary(cases, keys):
    return [{k: c.get(k) for k in keys} for c in cases]


def _rms_shapes(served) -> dict:
    """B3's launches by (rows, d) a prefill call and a decode step."""
    return {"prefill": served["prefill"]["rmsnorm_launches_by_shape"],
            "decode_per_step":
                served["decode"]["rmsnorm_launches_by_shape_per_step"]}


# ---------------------------------------------------------------------------
# phase 17: the in-graph collectives and tensor-parallel serving
# ---------------------------------------------------------------------------

COLL_P = 4              # rank threads of phase 17a
COLL_REPS = 5           # timed calls a (collective, mode, dtype), median
#: gemma3-1b's TP boundary at a prefill of 4 x 2048 tokens, P = 4
GEMMA_S, GEMMA_B, GEMMA_D, GEMMA_FF = 2048, 4, 1152, 6912
#: olmoe-1b-7b's dispatch: 64 experts, capacity(1024 local tokens), d 2048
OLMOE_E, OLMOE_D = 64, 2048
TP_DECODE_S, TP_DECODE_B = 32, 2
TP_PREFILL = (2048, 4)
TP_SMALL_LAYERS = 2
TP_SMALL_PREFILL = (512, 2)


def _bf16_tol(ref, p: int) -> float:
    """bf16 inputs or ``wire_bf16``: each of up to P - 1 hops, or the
    final rounding, may round the accumulator to bf16 on the other side
    of a tie (one bf16 ulp, 2**-7 relative): P * 2**-7 * max|ref|."""
    return p * 2.0 ** -7 * float(ref.abs().max())


def _coll_cases(torch, p):
    """(name, fn(comm, *local), in_specs, out_spec, full inputs) of phase
    17a, float32 on the CPU (cast and moved per run)."""
    from repro_torch.core import collectives as C
    from repro_torch.distributed import P
    from repro_torch.models.moe import capacity
    from repro_torch.configs import get_config
    g = torch.Generator().manual_seed(SEED + 17)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    s, b, d, ff = GEMMA_S, GEMMA_B, GEMMA_D, GEMMA_FF
    cap = capacity((1024 // p) * 4, get_config("olmoe-1b-7b"))
    x = normal(s, b, d)
    xr = normal(p * s, b, d)            # a different (s, b, d) a rank
    w_in = normal(d, ff // p * p, scale=d ** -0.5)
    h = normal(s, b, ff)
    w_out = normal(ff, d, scale=ff ** -0.5)
    disp = normal(p * OLMOE_E, cap, OLMOE_D)
    v = normal(p, 8, 128)

    def stack(t):
        return t[None]
    return [
        ("all_gather", lambda c, x: stack(C.all_gather(x, c.model_axis,
                                                       c.cfg)),
         (P("x"),), P("x"), (x,), "exact"),
        ("all_gather_matmul", lambda c, x, w: stack(C.all_gather_matmul(
            x, w, c.model_axis, c.cfg)), (P("x"), P(None, "x")), P("x"),
         (x, w_in), "agmm"),
        ("matmul_reduce_scatter", lambda c, h, w: stack(
            C.matmul_reduce_scatter(h, w, c.model_axis, c.cfg)),
         (P(None, None, "x"), P("x")), P("x"), (h, w_out), "reduce"),
        ("reduce_scatter", lambda c, x: stack(C.reduce_scatter(
            x, c.model_axis, c.cfg)), (P("x"),), P("x"), (xr,), "reduce"),
        ("all_reduce", lambda c, x: stack(C.all_reduce(x, c.model_axis,
                                                       c.cfg)),
         (P("x"),), P("x"), (xr,), "reduce"),
        ("all_to_all", lambda c, y: stack(C.all_to_all(
            y, c.model_axis, split_axis=0, concat_axis=1, config=c.cfg)),
         (P("x"),), P("x"), (disp,), "exact"),
        ("barrier_tree", lambda c, v: torch.stack([
            C.tree_broadcast(v[0], c.model_axis, root=p - 1),
            C.tree_reduce(v[0], c.model_axis, root=1),
            C.dissemination_barrier(c.model_axis).float().expand_as(v[0])
        ])[None], (P("x"),), P("x"), (v,), "tree"),
    ]


def _coll_oracle(torch, name, args, p):
    """The plain single-rank result of a case (float32 on the card)."""
    if name == "all_gather":
        return torch.stack([args[0]] * p)
    if name == "all_gather_matmul":
        x, w = (a.float() for a in args)
        return torch.stack([torch.matmul(x, w[:, r * (w.shape[1] // p):
                                               (r + 1) * (w.shape[1] // p)])
                            for r in range(p)])
    if name == "matmul_reduce_scatter":
        full = torch.matmul(args[0].float(), args[1].float())
        return torch.stack(torch.chunk(full, p, 0))
    if name in ("reduce_scatter", "all_reduce"):
        total = sum(torch.chunk(args[0].float(), p, 0))
        if name == "all_reduce":
            return torch.stack([total] * p)
        return torch.stack(torch.chunk(total, p, 0))
    return None


def collectives_phase(torch):
    """17a: every collective in every mode at P = 4 rank threads on
    ``LocalCluster(4, device="cuda")`` (``LciAxis`` through ``spmd_map``)
    with CUDA tensors, in float32 and bf16, ``wire_bf16`` off and on in
    the LCI modes; the gathers, the all-to-all and the tree pair bitwise
    equal to the same call on CPU tensors; each mode against the plain
    single-rank oracle (and so against BSP) at ``collectives_check.py``'s
    float32 tolerances (1e-4 the all-gather matmul, 1e-3 the reduces),
    and at :func:`_bf16_tol` in bf16 and under ``wire_bf16``; no payload
    byte through the host (``to_host`` / ``to_card`` copies unchanged);
    per mode the wall ms (median of 5), bytes and messages by protocol,
    B1 launches, and the host syncs of the first call (and where they
    were asked for) over its ring steps."""
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.core.transport.wire import to_card, to_host
    from repro_torch.distributed import Mesh, spmd_map
    from repro_torch.kernels.doorbell import stage_copy_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    p = COLL_P
    cases = _coll_cases(torch, p)
    out = []
    host0 = (to_host.copies, to_card.copies)
    b1_0 = stage_copy_rows.launches
    with Mesh((p,), ("x",), device=DEVICE) as mesh, \
            Mesh((p,), ("x",), device="cpu") as cpu_mesh:
        for name, fn, specs, ospec, args, kind in cases:
            for dt in ("float32", "bfloat16"):
                tdt = getattr(torch, dt)
                dev_args = [a.to(DEVICE, tdt) for a in args]
                oracle = _coll_oracle(torch, name, dev_args, p)
                cpu_ref = None
                if kind in ("exact", "tree"):
                    cpu_ref = spmd_map(fn, cpu_mesh, specs, ospec,
                                       model_axis="x", config=CommConfig(
                                           mode=CommMode.LCI_DEDICATED))(
                        *[a.to(tdt) for a in args])
                for mode in CommMode:
                    for wire in ((False,) if mode == CommMode.BSP
                                 else (False, True)):
                        if wire and kind != "reduce":
                            continue
                        cfg = CommConfig(mode=mode, wire_bf16=wire)
                        f = spmd_map(fn, mesh, specs, ospec, config=cfg,
                                     model_axis="x")
                        tot0 = mesh.protocol_totals()
                        calls0 = sum(_axis_calls(mesh))
                        b1 = stage_copy_rows.launches
                        torch.cuda.synchronize()
                        with _SyncCount(torch) as syncs:
                            got = f(*dev_args)
                        torch.cuda.synchronize()
                        tot1 = mesh.protocol_totals()
                        steps = sum(_axis_calls(mesh)) - calls0
                        b1 = stage_copy_rows.launches - b1
                        times = []
                        for _ in range(COLL_REPS):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            f(*dev_args)
                            torch.cuda.synchronize()
                            times.append(time.perf_counter() - t0)
                        rec = {"case": name, "dtype": dt, "mode": mode.value,
                               "wire_bf16": wire, "ranks": p,
                               "shape": [list(a.shape) for a in args],
                               "ms": statistics.median(times) * 1e3,
                               "messages": steps,
                               "host_syncs": syncs.calls,
                               "host_sync_sites": syncs.where,
                               "host_syncs_per_ring_step":
                                   syncs.calls / max(steps, 1),
                               "b1_launches": b1,
                               **{k: tot1[k] - tot0[k] for k in tot1}}
                        if cpu_ref is not None:
                            same = torch.equal(got.cpu(), cpu_ref)
                            rec["bitwise_vs_cpu"] = same
                            if not same:
                                raise AssertionError(
                                    f"17a {name} {dt} {mode.value}: CUDA "
                                    "result differs from the CPU call")
                        if oracle is not None:
                            err = float((got.float() - oracle).abs().max())
                            if dt == "bfloat16" or wire:
                                tol = _bf16_tol(oracle, p)
                            else:
                                tol = 1e-4 if kind == "agmm" else 1e-3
                            rec.update(max_abs_err=err, tol=tol)
                            if not err <= tol:
                                raise AssertionError(
                                    f"17a {name} {dt} {mode.value} wire="
                                    f"{wire}: |err| {err} > {tol}")
                        out.append(rec)
    host = (to_host.copies - host0[0], to_card.copies - host0[1])
    if host != (0, 0):
        raise AssertionError(f"17a: payload bytes crossed the host "
                             f"(to_host, to_card copies {host})")
    return {"cases": out, "host_copies": list(host),
            "b1_launches": stage_copy_rows.launches - b1_0}


def _axis_calls(mesh):
    """Messages posted so far by every rank (the runtimes' protocol
    counts): a ring step is one message a rank."""
    return [rt.stats.total_msgs for rt in mesh.cluster.local_runtimes()]


class _PathCalls:
    """While installed, keeps one call of each kernel at each signature
    (shapes, dtypes, options) that the path gives it, where the port's
    code calls the wrapper: B2's and B5's seq-major wrappers, B3, B4 and
    the SSM conv stage at the model code's imports, B1's gather where the
    fabric stages a doorbell's rows (``fabric._stage_rows``).
    B1's rows and B4's activations, weights and row counts are cloned, as
    the checks rerun the kernel on them; the others keep their shapes.  Every
    call goes on to the real wrapper once, so launch counts are those of
    the path."""

    def __enter__(self):
        import importlib

        import repro_torch.models.attention as attention
        import repro_torch.models.layers as layers
        import repro_torch.models.moe as moe
        import repro_torch.models.ssm as ssm
        # (``repro_torch.core.progress`` the name is a function: by path)
        fabric = importlib.import_module("repro_torch.core.progress.fabric")
        self.sites = ((attention, "_flash_kernel", "flash"),
                      (layers, "rmsnorm", "rmsnorm"),
                      (moe, "moe_gmm", "moe_gmm"),
                      (ssm, "ssd_scan_kernel", "ssd_scan"),
                      (ssm, "ssm_conv", "ssm_conv"),
                      (fabric, "_stage_rows", "doorbell"))
        self.real = [getattr(m, n) for m, n, _ in self.sites]
        self.calls = {k: {} for _, _, k in self.sites}
        keep = {"flash": self._flash, "rmsnorm": self._rmsnorm,
                "moe_gmm": self._moe_gmm, "ssd_scan": self._ssd_scan,
                "ssm_conv": self._ssm_conv, "doorbell": self._doorbell}

        def wrap(fn, kind):
            def kept(*a, **kw):
                first = a[0][0] if kind == "doorbell" else a[0]
                if first.is_cuda:
                    key, val = keep[kind](*a, **kw)
                    self.calls[kind].setdefault(key, val)
                return fn(*a, **kw)
            return kept
        for (m, n, kind), fn in zip(self.sites, self.real):
            setattr(m, n, wrap(fn, kind))
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.sites, self.real):
            setattr(m, n, fn)

    @staticmethod
    def _flash(q, k, v, *, causal=True, window=0, q_offset=0):
        key = (tuple(q.shape), tuple(k.shape), str(q.dtype), causal,
               window, q_offset)
        return key, key

    @staticmethod
    def _rmsnorm(x, w=None, *, eps=1e-6):
        d = x.shape[-1]
        key = (x.numel() // d, d, str(x.dtype), w is not None, eps)
        return key, key

    @staticmethod
    def _moe_gmm(x, w1, w2, *, act="swiglu", block_c=128, rows=None):
        key = (tuple(x.shape), tuple(w1.shape), tuple(w2.shape),
               str(x.dtype), act, rows is None)
        # the weights cloned too: a layer's view would keep the whole
        # stacked param alive after its run
        return key, (x.detach().clone(), w1.detach().clone(),
                     w2.detach().clone(), act,
                     None if rows is None else rows.clone())

    @staticmethod
    def _ssd_scan(x, dt, a_log, b, c, d_skip, *, chunk=128, h0=None):
        key = (tuple(x.shape), tuple(b.shape), str(x.dtype), chunk,
               h0 is not None)
        return key, key

    @staticmethod
    def _ssm_conv(xs, dt_raw, conv_w, dt_bias):
        from repro_torch.kernels.ssm_conv import row_stride
        s, bs, di = xs.shape
        key = (s, bs, di, dt_raw.shape[2], row_stride(xs), str(xs.dtype))
        return key, key

    @staticmethod
    def _doorbell(rows, wire_bf16, uniform=False):
        key = (len(rows), tuple(rows[0].shape), str(rows[0].dtype),
               wire_bf16)
        return key, ([r.clone() for r in rows], wire_bf16)


def moe_operands_case(torch, label, x, w1, w2, act, rows) -> dict:
    """B4 on a path's own activations, weights and row counts against the
    plain version of the variant that ran ("tc": h rounded once to bf16
    after the float32 activation, as the kernel rounds it).  The model's
    activations and weights put the outputs over four decades (olmoe's
    training path: |out| up to ~2.4e4, mean ~1.5e3), where an element of
    h that rounds the other way moves a small output by more than
    3e-2 |out|; so the limits scale with the output: the relative
    Frobenius error within 2^-8 (a bf16 ulp) and every element within
    2^-7 of the largest |ref| (two ulps at the top of the range).  The
    distance from the float32 plain version is reported beside them."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
    out, ran = _variant_of(lambda: moe_gmm(x, w1, w2, act=act, rows=rows))
    want = "tc" if x.dtype == torch.bfloat16 and x.shape[2] % 8 == 0 \
        else "simt"
    if ran != want:
        raise AssertionError(f"{label}: launched the {ran} variant, not "
                             f"{want}")
    h_dtype = torch.bfloat16 if ran == "tc" else None
    ref = moe_gmm_ref(x, w1, w2, act=act, rows=rows,
                      h_dtype=h_dtype).double()
    f32 = moe_gmm_ref(x, w1, w2, act=act, rows=rows).double()
    a = out.double()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    scale = float(ref.abs().max())
    err = float((a - ref).abs().max())
    fro = float((a - ref).norm() / ref.norm().clamp_min(1e-30))
    if err > 2 ** -7 * scale or fro > 2 ** -8:
        raise AssertionError(
            f"{label}: max error {err} against the {ran} plain version "
            f"(limit 2^-7 x {scale}), relative Frobenius {fro} (limit "
            "2^-8)")
    tol = 3e-2
    beyond = int(((a - f32).abs() > tol + tol * f32.abs()).sum())
    case = {"case": label, "shape_x": list(x.shape), "f": w2.shape[1],
            "act": act, "dtype": str(x.dtype).split(".")[1],
            "variant": ran, "operands": "the path's own", "ok": True,
            "max_abs_err": err, "max_abs_ref": scale,
            "limit": "2^-7 max|ref|, relative Frobenius 2^-8",
            "relative_frobenius": fro,
            "vs_float32_plain": {
                "max_abs_err": float((a - f32).abs().max()),
                "relative_frobenius": float((a - f32).norm()
                                            / f32.norm().clamp_min(1e-30)),
                "elements_beyond_3e-2": beyond, "elements": a.numel()}}
    del a, ref, f32, out
    return case


def path_kernel_checks(torch, calls, prefix: str = "tp_path",
                       b4_scaled: bool = False) -> dict:
    """Each kernel held against its plain version at every signature
    :class:`_PathCalls` kept, through the earlier phases' cases (their
    tolerances; untimed): B2, B3, B5 and the conv stage on fresh draws at
    the path's shapes and options, B4 on the path's own activations,
    weights and row counts, B1 on the path's own rows byte for byte.  With
    ``b4_scaled`` (the training path, whose B4 outputs span four
    decades), B4 on fresh draws at the path's shapes and row counts under
    that tolerance, and on the path's own operands under
    :func:`moe_operands_case`'s.  Returns the cases by kernel, each
    labelled ``prefix`` and its signature."""
    from repro_torch.kernels.doorbell import (stage_copy_rows,
                                              stage_copy_rows_ref)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    dt = {"torch.float32": torch.float32, "torch.bfloat16": torch.bfloat16}
    out = {k: [] for k in calls}
    for (qs, ks, dn, causal, window, qo) in calls["flash"]:
        sq, b, hq, dh = qs
        label = (f"{prefix}_{sq}x{b}x{hq}x{ks[2]}x{dh}_w{window}_o{qo}_"
                 f"{dn.split('.')[1]}")
        out["flash"].append(flash_case(
            torch, label, b, hq, ks[2], sq, ks[0], dh, causal, window, qo,
            dt[dn], g, time_it=False))
    for (rows, d, dn, with_w, eps) in calls["rmsnorm"]:
        if eps != 1e-6:
            raise AssertionError(f"the path normed with eps {eps}, which "
                                 "rmsnorm_case does not take")
        out["rmsnorm"].append(rmsnorm_case(
            torch, f"{prefix}_{dn.split('.')[1]}_{rows}x{d}", rows, d,
            dt[dn], g, with_w=with_w, time_it=False))
    for x, w1, w2, act, rows in calls["moe_gmm"].values():
        e, c, d = x.shape
        label = (f"{prefix}_{e}x{c}x{d}_f{w2.shape[1]}_{act}_"
                 f"{str(x.dtype).split('.')[1]}")
        if b4_scaled:
            out["moe_gmm"].append(moe_gmm_case(
                torch, label + "_draw", e, c, d, w2.shape[1], act, x.dtype,
                g, rows=rows, time_it=False))
            out["moe_gmm"].append(moe_operands_case(
                torch, label, x, w1, w2, act, rows))
            continue
        out["moe_gmm"].append(moe_gmm_case(
            torch, label, e, c, d, w2.shape[1], act, x.dtype, g,
            operands=(x, w1, w2), rows=rows, time_it=False))
    for (xs, bs_, dn, chunk, h0) in calls["ssd_scan"]:
        s, bs, h, p = xs
        out["ssd_scan"].append(ssd_case(
            torch, f"{prefix}_{bs}x{h}x{s}x{p}_g{bs_[2]}_n{bs_[3]}_"
            f"{dn.split('.')[1]}", bs, h, s, p, bs_[2], bs_[3], dt[dn], g,
            chunk=chunk, with_h0=h0, time_it=False))
    for (s, bs, di, h, row, dn) in calls.get("ssm_conv", {}):
        out["ssm_conv"].append(conv_case(
            torch, f"{prefix}_{bs}x{s}x{di}_h{h}_row{row}", bs, s, di, row,
            h, dt[dn], g, time_it=False))
    for (k, shape, dn, wire), (rows, _) in calls["doorbell"].items():
        label = (f"{prefix}_rows_{k}x{'x'.join(map(str, shape))}_"
                 f"{dn.split('.')[1]}_bf16{int(wire)}")
        got = stage_copy_rows(rows, wire_bf16=wire)
        ref = stage_copy_rows_ref(rows, wire_bf16=wire)
        torch.cuda.synchronize()
        out["doorbell"].append({
            "case": label, "wrapper": "stage_copy_rows", "ok": True,
            "shape": [k, *shape], "dtype": dn.split(".")[1],
            "wire_bf16": wire, "byte_exact": True,
            "max_abs_err": compare(label, got, ref, rows[0].dtype,
                                   wire and rows[0].dtype == torch.float32)})
    return out


def _tp_specs(specs):
    if isinstance(specs, dict):
        return {k: _tp_specs(v) for k, v in specs.items()}
    return specs.pspec()


def _tp_decode(torch, cfg, params, specs, tokens, mesh, mode):
    """Teacher-forced decode on the mesh's model axis; (tokens, ms a
    step)."""
    from repro_torch.core.modes import CommConfig
    from repro_torch.distributed import P, spmd_map
    from repro_torch.serving import cache_pspecs, init_cache, \
        make_serve_step
    S, B = tokens.shape

    def rank(comm, params, cache, tokens):
        step = make_serve_step(cfg, comm)
        preds = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(S):
            nxt, cache = step(params, cache, tokens[i])
            preds.append(nxt)
        torch.cuda.synchronize()
        return torch.stack(preds), torch.tensor(
            [(time.perf_counter() - t0) / S * 1e3])
    cache = init_cache(cfg, S, B, device=DEVICE)
    got, ms = spmd_map(rank, mesh, (_tp_specs(specs),
                                    cache_pspecs(cfg, batch=B), P()),
                       (P(), P("model")), config=CommConfig(mode=mode))(
        params, cache, tokens)
    return got, float(ms.max())


def _local_decode(torch, cfg, params, tokens):
    from repro_torch.serving import init_cache, make_serve_step
    step = make_serve_step(cfg)
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device=DEVICE)
    preds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(tokens.shape[0]):
        nxt, cache = step(params, cache, tokens[i])
        preds.append(nxt)
    torch.cuda.synchronize()
    return torch.stack(preds), (time.perf_counter() - t0) / \
        tokens.shape[0] * 1e3


def _tp_forward(torch, cfg, params, specs, tokens, mesh, mode, reps=1):
    """``forward`` on the mesh, tokens sequence-sharded over model;
    (hidden states (s, b, d), aux, ms of the last call)."""
    from repro_torch.core.modes import CommConfig
    from repro_torch.distributed import P, spmd_map
    from repro_torch.models.registry import build_model

    def rank(comm, params, tokens):
        model = build_model(cfg, device=DEVICE)
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, aux = model.forward(params, {"tokens": tokens}, comm)
            torch.cuda.synchronize()
        return x, {k: v.reshape(1) for k, v in aux.items()}, torch.tensor(
            [(time.perf_counter() - t0) * 1e3])
    x, aux, ms = spmd_map(rank, mesh, (_tp_specs(specs), P("model")),
                          (P(), P("model"), P("model")),
                          config=CommConfig(mode=mode))(params, tokens)
    return x, {k: float(v[0]) for k, v in aux.items()}, float(ms.max())


def tp_gemma_phase(torch):
    """17b: gemma3-1b at full width (26 layers, d 1152, vocab 262144) at
    tp = 2 on two rank threads, with ``tp_target`` 2 so that its 4 heads
    shard and its one kv head does not (Plan A with the kv projection
    replicated, each rank keeping the kv head its q heads map to).

    Decode: float32, teacher-forced ``make_serve_step`` over 32 positions
    of batch 2, in LCI_DEDICATED and in BSP, against the tp = 1 run on the
    same weights: agreement > 0.95 (``tp2d_decode.py``'s gate).  Prefill:
    bf16, 4 x 2048 tokens, ``make_prefill_step`` in both modes; per rank
    thread, counted where the wrappers launch, exactly 26 flash-attention
    launches (one a layer, on its two q heads, all "tc") and 105 RMSNorm
    launches (norm1, q_norm, k_norm, norm2 a layer and the final norm), as
    at tp = 1, and none on another thread.  Its last hidden state is held
    against tp = 1's on the same weights: its distance from the float32
    tp = 1 run (the bf16 weights cast up) at most twice tp = 1's bf16
    distance, norm-wise; its tokens the argmax of its own logits, and
    tp = 1's wherever tp = 1's logit of them is more than twice the two
    runs' largest logit difference below tp = 1's top one."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.modes import CommMode
    from repro_torch.distributed import Mesh, P, spmd_map
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.registry import build_model
    from repro_torch.serving import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"config": "gemma3-1b", "tp": 2, "tp_target": 2}
    base = dataclasses.replace(get_config("gemma3-1b"), tp_target=2)
    cfg = dataclasses.replace(base, dtype=torch.float32)
    params, specs = build_model(cfg, device=DEVICE).init(SEED)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab, (TP_DECODE_S, TP_DECODE_B),
                           generator=g, device=DEVICE, dtype=torch.int32)
    oracle, ms1 = _local_decode(torch, cfg, params, tokens)
    out["decode"] = {"dtype": "float32", "positions": TP_DECODE_S,
                     "batch": TP_DECODE_B, "tp1_ms_per_step": ms1}
    with Mesh((2,), ("model",), device=DEVICE) as mesh:
        for mode in (CommMode.LCI_DEDICATED, CommMode.BSP):
            got, ms = _tp_decode(torch, cfg, params, specs, tokens, mesh,
                                 mode)
            agree = float((got == oracle).float().mean())
            out["decode"][mode.value] = {"agreement_vs_tp1": agree,
                                         "ms_per_step": ms}
            if agree <= 0.95:
                raise AssertionError(f"17b gemma3-1b tp=2 {mode.value}: "
                                     f"decode agrees with tp=1 on {agree}")
        del params
        torch.cuda.empty_cache()
        cfg = base                                     # bf16
        params, specs = build_model(cfg, device=DEVICE).init(SEED)
        s, b = TP_PREFILL
        tokens = torch.randint(0, cfg.vocab, (s, b), generator=g,
                               device=DEVICE, dtype=torch.int32)
        # tp = 1 on the same weights, in bf16 and in float32 (the bf16
        # weights cast up exactly): the float32 run is the yardstick of
        # what bf16 rounding alone moves
        tok1, last1 = make_prefill_step(cfg)(params, {"tokens": tokens})
        cfg32 = dataclasses.replace(base, dtype=torch.float32)
        _, last32 = make_prefill_step(cfg32)(_float_tree(params),
                                             {"tokens": tokens})
        torch.cuda.empty_cache()
        head = params.get("lm_head", params["emb"]).float()
        e1 = _rel_err(last1, last32)
        prefill_rec = {"dtype": "bfloat16", "batch": b, "seq": s,
                       "tp1_tokens": tok1.tolist(),
                       "tp1_rel_err_vs_float32": e1}
        for mode in (CommMode.LCI_DEDICATED, CommMode.BSP):
            from repro_torch.core.modes import CommConfig

            def rank(comm, params, tokens):
                step = make_prefill_step(cfg, comm)
                times = []
                for _ in range(PREFILL_CALLS + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tok, last = step(params, {"tokens": tokens})
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                return tok, last, torch.tensor(
                    [statistics.median(times[1:]) * 1e3])
            before = [dict(f.launches_by_thread)
                      for f in (flash_attention_bhsd, rmsnorm)]
            tc0 = flash_attention_bhsd.launches_by_variant["tc"]
            tok, last, ms = spmd_map(rank, mesh, (_tp_specs(specs),
                                                  P("model")),
                                     (P(), P(), P("model")),
                                     config=CommConfig(mode=mode))(params,
                                                                   tokens)
            calls = PREFILL_CALLS + 1
            per_rank = _rank_launches(f"17b prefill {mode.value}", cfg,
                                      before, calls)
            tc = flash_attention_bhsd.launches_by_variant["tc"] - tc0
            if tc != 2 * cfg.n_layers * calls:
                raise AssertionError(f"17b prefill {mode.value}: {tc} "
                                     "tensor-core flash launches (want "
                                     f"{2 * cfg.n_layers * calls})")
            agree = _tp_prefill_gate(torch, f"17b prefill {mode.value}",
                                     cfg, head, tok, last, tok1, last1,
                                     last32, e1)
            prefill_rec[mode.value] = {
                "ms": float(ms.max()), "launches_per_rank_call": per_rank,
                "flash_tc_launches": tc, **agree}
        out["prefill"] = prefill_rec
    del params
    torch.cuda.empty_cache()
    return out


def _rank_launches(label, cfg, before, calls) -> dict:
    """B2's and B3's launches a rank thread and prefill call since
    ``before`` (their ``launches_by_thread``): raises unless each of the
    two rank threads launched ``cfg.n_layers`` B2 and ``4 n_layers + 1``
    B3 kernels a call, and no other thread launched any."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    by = [{t: n - b0.get(t, 0) for t, n in f.launches_by_thread.items()
           if n != b0.get(t, 0)}
          for f, b0 in zip((flash_attention_bhsd, rmsnorm), before)]
    per_rank = {t: {"flash": by[0].get(t, 0) / calls,
                    "rms": by[1].get(t, 0) / calls}
                for t in ("spmd-rank0", "spmd-rank1")}
    want = {"flash": cfg.n_layers, "rms": 4 * cfg.n_layers + 1}
    elsewhere = sorted((set(by[0]) | set(by[1])) - set(per_rank))
    if any(v != want for v in per_rank.values()) or elsewhere:
        raise AssertionError(f"{label}: launches per rank and call "
                             f"{per_rank} (want {want}), launches on "
                             f"threads {elsewhere} too")
    return per_rank


def _tp_prefill_gate(torch, label, cfg, head, tok, last, tok1, last1,
                     last32, e1) -> dict:
    """A tp > 1 bf16 prefill (``tok``, ``last``) against tp = 1's
    (``tok1``, ``last1``) on the same weights: its last hidden state no
    further from the float32 tp = 1 result ``last32`` than twice tp = 1's
    bf16 distance ``e1``, norm-wise; its tokens the argmax of its own
    logits, and tp = 1's wherever tp = 1's logit of them is more than
    twice the two runs' largest logit difference below tp = 1's top
    one.  Raises on a miss; returns the numbers."""
    b = tok1.shape[0]
    e2 = _rel_err(last, last32)
    d21 = _rel_err(last, last1)
    if not torch.isfinite(last.float()).all() or not e2 <= 2 * e1:
        raise AssertionError(f"{label}: hidden state {e2} from float32 "
                             f"(tp = 1: {e1}; limit {2 * e1})")
    if tok.shape != (b,) or not ((tok >= 0) & (tok < cfg.vocab)).all():
        raise AssertionError(f"{label}: tokens {tok.tolist()} out of range")
    lg1 = torch.matmul(last1.float(), head.T)[:, :cfg.vocab]
    lg2 = torch.matmul(last.float(), head.T)[:, :cfg.vocab]
    spread = float((lg2 - lg1).abs().max())
    rows = torch.arange(b, device=DEVICE)
    own = lg2[rows, tok.long()] >= lg2.max(-1).values - 1e-4 * \
        lg2.abs().max(-1).values
    near = lg1[rows, tok.long()] >= lg1[rows, tok1.long()] - 2 * spread
    if not own.all() or not near.all():
        raise AssertionError(f"{label}: tokens {tok.tolist()} (tp = 1: "
                             f"{tok1.tolist()}; logits spread {spread})")
    return {"tokens": tok.tolist(),
            "tokens_equal_tp1": int((tok == tok1).sum()),
            "rel_err_vs_float32": e2, "rel_err_vs_tp1": d21,
            "logits_max_abs_diff_vs_tp1": spread}


def _float_tree(tree):
    """The params tree with every floating tensor cast to float32."""
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _rel_err(x, ref) -> float:
    """‖x - ref‖ / ‖ref‖ over every element, in float64."""
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm())


#: phase 17c's configs: the path each exercises at tp = 2
TP_SMALL = {"olmoe-1b-7b": "B4 on the local experts after the all-to-all",
            "mamba2-370m": "B5 on the local SSD heads",
            "hymba-1.5b": "Plan B attention and the replicated SSM"}


def tp_small_phase(torch):
    """17c: olmoe-1b-7b, mamba2-370m and hymba-1.5b at full width, 2
    layers, tp = 2, float32: ``forward`` on 2 x 512 tokens in
    LCI_DEDICATED against tp = 1 on the same weights, gated as phases 9
    and 12 gate decode against forward: the greedy tokens of every
    position agree on more than 0.95 (olmoe at the capacity factor E / k,
    where no expert overflows at either width); the kernels' launches on
    the path are recorded and must be nonzero."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.modes import CommMode
    from repro_torch.distributed import Mesh, local_comm
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.models.layers import greedy_sample, lm_head_logits
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    s, b = TP_SMALL_PREFILL
    with Mesh((2,), ("model",), device=DEVICE) as mesh:
        for arch, what in TP_SMALL.items():
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=TP_SMALL_LAYERS,
                                      dtype=torch.float32)
            if cfg.family == "moe":
                cfg = dataclasses.replace(
                    cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            params, specs = build_model(cfg, device=DEVICE).init(SEED)
            g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
            tokens = torch.randint(0, cfg.vocab, (s, b), generator=g,
                                   device=DEVICE, dtype=torch.int32)
            x1, aux1 = build_model(cfg, device=DEVICE).forward(
                params, {"tokens": tokens})
            c0 = (flash_attention_bhsd.launches, rmsnorm.launches,
                  moe_gmm.launches, ssd_scan_bhsp.launches)
            x2, aux2, ms = _tp_forward(torch, cfg, params, specs, tokens,
                                       mesh, CommMode.LCI_DEDICATED)
            launches = dict(zip(("flash", "rms", "moe_gmm", "ssd_scan"), (
                b_ - a_ for a_, b_ in zip(c0, (
                    flash_attention_bhsd.launches, rmsnorm.launches,
                    moe_gmm.launches, ssd_scan_bhsp.launches)))))
            head = params.get("lm_head", params["emb"])
            comm = local_comm()
            t1 = greedy_sample(lm_head_logits(x1, head, comm,
                                              real_vocab=cfg.vocab), comm)
            t2 = greedy_sample(lm_head_logits(x2, head, comm,
                                              real_vocab=cfg.vocab), comm)
            agree = float((t1 == t2).float().mean())
            err = float((x1 - x2).abs().max())
            out[arch] = {"path": what, "layers": cfg.n_layers, "seq": s,
                         "batch": b, "dtype": "float32",
                         "token_agreement_vs_tp1": agree,
                         "max_abs_hidden_diff": err, "forward_ms": ms,
                         "launches": launches,
                         "dropped_frac": aux2["dropped_frac"]}
            need = {"olmoe-1b-7b": ("flash", "rms", "moe_gmm"),
                    "mamba2-370m": ("rms", "ssd_scan"),
                    "hymba-1.5b": ("flash", "rms", "ssd_scan")}[arch]
            if agree <= 0.95 or not torch.isfinite(x2).all() or \
                    any(launches[k] == 0 for k in need):
                raise AssertionError(f"17c {arch} tp=2: {out[arch]}")
            del params, x1, x2
            torch.cuda.empty_cache()
    return out


#: tp2d_decode.py's configs (float32) and the dense one at batch 1
TP2D = {
    "dense": (dict(family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=4, d_ff=128, vocab=256, tp_target=4), 4),
    "gqa-par": (dict(family="dense", n_layers=2, d_model=64, n_heads=8,
                     n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                     norm="layernorm", parallel_block=True,
                     tie_embeddings=True, tp_target=4), 4),
    "ssm": (dict(family="ssm", n_layers=2, d_model=64, n_heads=0,
                 n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16,
                 ssm_headdim=16, ssm_chunk=8, tp_target=4), 4),
    "moe": (dict(family="moe", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=4, d_ff=96, vocab=256, n_experts=8, top_k=2,
                 tp_target=4, capacity_factor=8.0, shared_expert_ff=64), 4),
    "dense-joint-kv": (dict(family="dense", n_layers=2, d_model=64,
                            n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                            tp_target=4), 1),
}


def tp2d_phase(torch):
    """17d: ``tp2d_decode.py``'s four configs on a (data 2 x model 2) mesh
    of four rank threads on the card, classic and tp2d decode (and the
    dense config at batch 1: ``joint_kv``), 16 teacher-forced positions,
    each against the local (tp = 1) decode: agreement > 0.95."""
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.distributed import Mesh, P, spmd_map
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving import cache_pspecs, init_cache, \
        make_serve_step
    S = 16
    out = {}
    with Mesh((2, 2), ("data", "model"), device=DEVICE) as mesh:
        for name, (fields, batch) in TP2D.items():
            cfg = ModelConfig(name=name, dtype=torch.float32, **fields)
            params, specs = build_model(cfg, device=DEVICE).init(SEED)
            g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
            tokens = torch.randint(0, cfg.vocab, (S, batch), generator=g,
                                   device=DEVICE, dtype=torch.int32)
            oracle, _ = _local_decode(torch, cfg, params, tokens)
            rec = {}
            for tp2d in (False, True):
                tok_spec = P(None, "data") if (batch > 1 and not tp2d) \
                    else P()

                def rank(comm, params, cache, tokens, tp2d=tp2d):
                    step = make_serve_step(cfg, comm, joint_kv=batch == 1,
                                           tp2d=tp2d)
                    preds = []
                    for i in range(S):
                        nxt, cache = step(params, cache, tokens[i])
                        preds.append(nxt)
                    return torch.stack(preds)
                cache = init_cache(cfg, S, batch, device=DEVICE)
                got = spmd_map(rank, mesh, (
                    _tp_specs(specs), cache_pspecs(cfg, batch=batch,
                                                   tp2d=tp2d), tok_spec),
                    tok_spec, config=CommConfig(
                        mode=CommMode.LCI_DEDICATED))(params, cache, tokens)
                agree = float((got == oracle).float().mean())
                rec["tp2d" if tp2d else "classic"] = agree
                if agree <= 0.95:
                    raise AssertionError(f"17d {name} tp2d={tp2d}: "
                                         f"agreement {agree}")
            rec.update(batch=batch, joint_kv=batch == 1)
            out[name] = rec
    return out


# ---------------------------------------------------------------------------
# phase 18: the recovery path
# ---------------------------------------------------------------------------

#: 18a: the replayed batch (SyntheticPipeline seq_len, global_batch), its
#: step, and the launcher decode steps run with and without a commit in
#: flight
RECOVERY_BATCH = (2048, 4)
RECOVERY_STEP = 3
RECOVERY_DECODE = 8
#: 18b: stages (cluster ranks), microbatches, graphs timed a payload, and
#: the payloads: the reference's default, and one microbatch of 512
#: tokens x d 1152 in bf16
PP_STAGES, PP_MICRO, PP_REPS = 4, 8, 3
PP_PAYLOADS = (32, 512 * 1152 * 2)


class _StoreTimes:
    """While installed, the seconds ``checkpoint/store.py`` spends in its
    snapshot (every leaf copied to the host) and in its leaf writes
    (``np.save``, fsync and SHA-256 a leaf), wherever they run."""

    def __enter__(self):
        from repro_torch.checkpoint import store
        self.store = store
        self.real = (store._snapshot, store._write_leaf)
        self.snapshot_s = self.write_s = 0.0

        def snapshot(tree):
            t0 = time.perf_counter()
            out = self.real[0](tree)
            self.snapshot_s += time.perf_counter() - t0
            return out

        def write(*args):
            t0 = time.perf_counter()
            out = self.real[1](*args)
            self.write_s += time.perf_counter() - t0
            return out
        store._snapshot, store._write_leaf = snapshot, write
        return self

    def __exit__(self, *exc):
        self.store._snapshot, self.store._write_leaf = self.real


def _pairs(tree, other, path=()):
    """(name, leaf, other's leaf) over two trees of one structure."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], other[k], path + (k,))
    else:
        yield "/".join(path), tree, other


def _bits(t):
    """``t``'s bytes as a flat uint8 tensor: equal bits, equal bytes."""
    import torch
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _meta_tree(tree):
    """``tree`` as tensors on the ``meta`` device: its shapes and
    dtypes, no data."""
    import torch
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def recovery_checkpoint_phase(torch):
    """18a: gemma3-1b's bf16 params at full width from seed 0 (with
    ``tp_target`` 2, as phase 17b, so that its 4 heads shard at tp = 2)
    through the checkpoint store and back.  A 4 x 2048 prefill of
    ``SyntheticPipeline(...).get_batch(3)`` gives the reference tokens and
    hidden state; ``save_sync`` (meta ``next_step`` 3), then ``save_async``
    of the same step while 8 launcher decode steps run, beside the same 8
    steps with no commit; ``restore``: every leaf bitwise the saved one,
    the batch of ``manifest["meta"]["next_step"]`` bitwise the reference
    batch, and its prefill's last hidden state and tokens bitwise the
    reference's; ``restore_resharded`` onto a (1, 2) mesh: each rank's
    leaves bitwise ``shard(full, pspec, mesh, rank)``, and the tp = 2
    prefill on those trees against tp = 1 under phase 17b's gate with 26
    B2 and 105 B3 launches on each rank thread.  Times: the snapshot
    (device -> host), the leaf writes (``np.save`` + fsync + SHA-256),
    the rest of the commit, the restore, each in GB/s of the params'
    bytes, and decode ms a step with and without a commit in flight.  The
    checkpoint directory is deleted at the end."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import (restore, restore_resharded,
                                        save_async, save_sync)
    from repro_torch.configs import get_config
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh, P, shard, spmd_map
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.registry import build_model
    from repro_torch.serving import (init_cache, make_prefill_step,
                                     make_serve_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-1b"), tp_target=2)
    params, specs = build_model(cfg, device=DEVICE).init(SEED)
    pspecs = _tp_specs(specs)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    s, b = RECOVERY_BATCH
    pipe = SyntheticPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b)
    tokens = pipe.get_batch(RECOVERY_STEP, DEVICE)["tokens"]
    prefill = make_prefill_step(cfg)
    tok1, last1 = prefill(params, {"tokens": tokens})
    ckpt = os.path.join(ROOT, "build", "phase18_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    meta = {"next_step": RECOVERY_STEP}
    gb = nbytes / 1e9
    out = {"config": cfg.name, "dtype": "bfloat16", "layers": cfg.n_layers,
           "leaves": len(list(_leaves(params))), "param_bytes": nbytes}
    try:
        # save_sync, its time split by stage
        with _StoreTimes() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_sync(ckpt, RECOVERY_STEP - 1, params, meta=meta)
            total = time.perf_counter() - t0
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        rest = total - st.snapshot_s - st.write_s
        out["save_sync"] = {
            "seconds": total, "gb_per_s": gb / total,
            "snapshot_s": st.snapshot_s, "snapshot_gb_per_s":
                gb / st.snapshot_s,
            "write_hash_s": st.write_s, "write_hash_gb_per_s":
                gb / st.write_s,
            "commit_rest_s": rest}

        # the launcher's decode step, 8 steps with no commit, then 8 while
        # save_async's writer thread commits the same step again
        step = make_serve_step(cfg)
        batch = SERVE_ARGS["max_batch"]
        dec = SyntheticPipeline(vocab=cfg.vocab, seq_len=RECOVERY_DECODE,
                                global_batch=batch, seed=1).get_batch(0, DEVICE)[
            "tokens"]
        cache = init_cache(cfg, SERVE_ARGS["cache_len"], batch,
                           device=DEVICE)

        def decode(cache):
            times = []
            for i in range(RECOVERY_DECODE):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, cache = step(params, cache, dec[i])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return cache, times
        cache, _ = decode(cache)                       # warm
        cache, quiet = decode(cache)
        with _StoreTimes() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync = save_async(ckpt, RECOVERY_STEP - 1, params, meta=meta)
            returned = time.perf_counter() - t0
            cache, busy = decode(cache)
            in_flight = not sync.ready
            sync.wait()
            total = time.perf_counter() - t0
        del cache
        q, w = statistics.median(quiet) * 1e3, statistics.median(busy) * 1e3
        out["save_async"] = {
            "seconds_to_return": returned, "seconds_to_commit": total,
            "snapshot_s": st.snapshot_s, "write_hash_s": st.write_s,
            "commit_in_flight_after_the_steps": in_flight}
        out["decode"] = {"batch": batch, "steps": RECOVERY_DECODE,
                         "ms_per_step_no_commit": q,
                         "ms_per_step_commit_in_flight": w,
                         "ratio": w / q,
                         "ms_each_no_commit": [t * 1e3 for t in quiet],
                         "ms_each_commit_in_flight": [t * 1e3 for t in busy]}
        if not in_flight:
            raise AssertionError("18a: the async commit landed before the 8 "
                                 "decode steps ended; no step ran beside it")

        # restore: every leaf bitwise, and the replayed batch's prefill
        like = _meta_tree(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, manifest = restore(ckpt, like, device=DEVICE)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        out["restore"] = {"seconds": took, "gb_per_s": gb / took}
        bad = [n for n, a, r in _pairs(params, restored)
               if a.dtype != r.dtype or not torch.equal(_bits(a), _bits(r))]
        if bad or any(t.device.type != torch.device(DEVICE).type
                      for t in _leaves(restored)):
            raise AssertionError(f"18a: restored leaves {bad[:5]} differ "
                                 "from the saved ones, or a leaf is off the "
                                 "card")
        nxt = manifest["meta"]["next_step"]
        replay = pipe.get_batch(nxt, DEVICE)["tokens"]
        tok_r, last_r = prefill(restored, {"tokens": replay})
        if not torch.equal(replay, tokens) or \
                not torch.equal(_bits(last_r), _bits(last1)) or \
                not torch.equal(tok_r, tok1):
            raise AssertionError(f"18a: the replay of step {nxt} differs "
                                 f"(tokens {tok_r.tolist()} against "
                                 f"{tok1.tolist()})")
        out["replay"] = {"step": nxt, "tokens": tok_r.tolist(),
                         "last_hidden_bitwise": True}
        del restored, tok_r, last_r
        torch.cuda.empty_cache()

        # restore_resharded onto (1, 2): each rank's leaves are its shards
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        _, last32 = make_prefill_step(cfg32)(_float_tree(params),
                                             {"tokens": tokens})
        torch.cuda.empty_cache()
        head = params["emb"].float()
        e1 = _rel_err(last1, last32)
        with Mesh((1, 2), ("data", "model"), device=DEVICE) as mesh:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trees, _ = restore_resharded(ckpt, like, pspecs, mesh)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            for r, tree in enumerate(trees):
                bad = [n for (n, full, spec), (_, got, _) in zip(
                           _pairs(params, pspecs), _pairs(tree, pspecs))
                       if not torch.equal(_bits(shard(full, spec, mesh, r)),
                                          _bits(got))]
                if bad:
                    raise AssertionError(f"18a: rank {r}'s restored leaves "
                                         f"{bad[:5]} are not its shards")

            def rank(comm, trees, tokens):
                mine = trees[comm.data_index() * mesh.shape[1]
                             + comm.model_index()]
                return make_prefill_step(cfg, comm)(mine,
                                                    {"tokens": tokens})
            before = [dict(f.launches_by_thread)
                      for f in (flash_attention_bhsd, rmsnorm)]
            tok2, last2 = spmd_map(rank, mesh, (None, P("model")),
                                   (P(), P()), config=CommConfig(
                                       mode=CommMode.LCI_DEDICATED))(
                trees, tokens)
            per_rank = _rank_launches("18a tp = 2 prefill", cfg, before, 1)
            agree = _tp_prefill_gate(torch, "18a tp = 2 prefill", cfg, head,
                                     tok2, last2, tok1, last1, last32, e1)
            out["resharded"] = {
                "mesh": [1, 2], "seconds": took, "gb_per_s": gb / took,
                "launches_per_rank_call": per_rank,
                "tp1_rel_err_vs_float32": e1, **agree}
            del trees
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    return out


def _marker_chain(n_stages: int, n_micro: int):
    """The landing buffers' values under ``build_1f1b_comm_graph``'s
    default marker arithmetic: (activations at (s, m), gradients at
    (s, m))."""
    act, grad = {}, {}
    for m in range(n_micro):
        x = m % 251
        for s in range(n_stages):
            x = (x + s + 1) % 251
            if s < n_stages - 1:
                act[(s, m)] = x
        g = x                                   # the last stage's output
        for s in range(n_stages - 1, 0, -1):
            g = (g * 2 + s) % 251
            grad[(s - 1, m)] = g
    return act, grad


def pipeline_comm_phase(torch):
    """18b: ``build_1f1b_comm_graph`` on ``LocalCluster(4, device="cuda")``
    (a 4-rank ``Mesh``'s cluster: rendezvous from ``eager_max_bytes``), 8
    microbatches, an endpoint of two devices a stage, payloads of 32 B
    and 1 179 648 B; ``PP_REPS`` graphs a payload, each run to its end.
    Gates: every activation and gradient landing buffer equals the marker
    chain, on the card; ``assert_partial_order``; every edge of
    ``schedule_1f1b(4, 8)`` (whose critical path must be 2 (S - 1) + 2 M)
    held by the comm graph's compute nodes in their completion order; no
    payload byte through the host (``to_host`` / ``to_card`` copies
    unchanged).  Records wall ms a graph (median), ms a comm node, and
    messages and bytes by protocol."""
    from repro_torch.core.transport.wire import to_card, to_host
    from repro_torch.distributed import (Mesh, build_1f1b_comm_graph,
                                         schedule_1f1b)
    S, M = PP_STAGES, PP_MICRO
    sched, sids = schedule_1f1b(S, M)
    sched.execute()
    want_cp = 2 * (S - 1) + 2 * M
    if sched.critical_path_len() != want_cp:
        raise AssertionError(f"18b: 1F1B critical path "
                             f"{sched.critical_path_len()} (want {want_cp})")
    node_of = {nid: node for node, nid in sids.items()}
    edges = [(node_of[d], node_of[n.nid]) for n in sched._nodes
             for d in n.deps]
    act_want, grad_want = _marker_chain(S, M)
    out = {"stages": S, "micro": M, "schedule_critical_path": want_cp,
           "schedule_edges": len(edges), "cases": []}
    host0 = (to_host.copies, to_card.copies)
    for nbytes in PP_PAYLOADS:
        with Mesh((S,), ("stage",), device=DEVICE) as mesh:
            cl = mesh.cluster
            eps = cl.alloc_endpoint(n_devices=2, name="pp")
            tot0 = mesh.protocol_totals()
            times = []
            for _ in range(PP_REPS):
                pg = build_1f1b_comm_graph(cl, M, nbytes, endpoints=eps)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pg.graph.execute()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                pg.graph.assert_partial_order()
                pos = {nid: i for i, nid in enumerate(pg.graph.fire_order)}
                late = [(u, v) for u, v in edges
                        if pos[pg.compute_ids[u]] >= pos[pg.compute_ids[v]]]
                wrong = [k for bufs, want in ((pg.act_in, act_want),
                                              (pg.grad_in, grad_want))
                         for k, buf in bufs.items()
                         if buf.device.type != torch.device(DEVICE).type
                         or not bool((buf == want[k]).all())]
                if late or wrong:
                    raise AssertionError(f"18b {nbytes} B: schedule edges "
                                         f"{late[:3]} out of order, landing "
                                         f"buffers {wrong[:3]} wrong")
            tot = {k: v - tot0[k] for k, v in mesh.protocol_totals().items()}
        n_comm = pg.graph.get_attr("n_comm_nodes")
        ms = statistics.median(times) * 1e3
        out["cases"].append({
            "payload_bytes": nbytes, "graphs": PP_REPS,
            "nodes": len(pg.graph), "comm_nodes": n_comm,
            "graph_critical_path": pg.graph.critical_path_len(),
            "ms_per_graph": ms, "ms_each": [t * 1e3 for t in times],
            "ms_per_comm_node": ms / n_comm, **tot})
    host = (to_host.copies - host0[0], to_card.copies - host0[1])
    if host != (0, 0):
        raise AssertionError(f"18b: payload bytes crossed the host "
                             f"(to_host, to_card copies {host})")
    out["host_copies"] = list(host)
    return out


# ---------------------------------------------------------------------------
# phase 19: training on the card
# ---------------------------------------------------------------------------

#: 19b: gemma3-1b at full width on the prefill cell's tokens (4 x 2048),
#: 8 steps on one fixed batch; step ms is the median of the last 6
TRAIN_GEMMA = dict(arch="gemma3-1b", seq=2048, batch=4, steps=8, timed=6)
#: 19c: the other families, batch 2 x 1024, 4 steps, (arch, layers, each
#: loss held below the one before); olmoe-1b-7b at 4 of its 16 layers
#: (6.9 B params x 14 bytes of param, master, mu and nu is about 97 GB,
#: beyond the card's 80 GB).  mamba2-370m at its full 48 layers is held
#: to its launches and finite losses alone: from the reference's init its
#: gradient norm is 5e3-1e4 and its loss wanders within 10.825-10.841
#: (ln V 10.825) for 8 steps at every rate from 1e-5 to 1e-3, in bf16 and
#: in float32, so whether it falls is noise.  It is held to learn at 4 of
#: its layers, where every step fell by 0.02 or more on each of 4 seeds;
#: at 8 and 16 layers the steps fell by less than that noise
TRAIN_FAMILIES = (("mamba2-370m", None, False), ("mamba2-370m", 4, True),
                  ("hymba-1.5b", None, True), ("olmoe-1b-7b", 4, True))
TRAIN_SMALL = dict(seq=1024, batch=2, steps=4)
#: AdamW's rate in every phase 19 run (constant; the reference's other
#: defaults: b2 0.95, weight decay 0.1, clip at 1.0)
TRAIN_LR = 1e-3
#: 19a: the recorded backward's gradients against autograd of the
#: plain version in float32: tests/test_kernels.py's bf16 tolerance 2e-2,
#: its atol scaled by the gradient's largest |ref| (a gradient sums many
#: products; phase 5 scales the tensor-core limit by |ref| likewise)
GRAD_TOL = 2e-2
#: 19d: dp = 2 rank threads, gemma3-1b at full width and 2 layers; the
#: PipelinedModel's stages: gemma3-1b's first 4 layers, 8 microbatches
TRAIN_DP = dict(layers=2, seq=2048, batch=4)
TRAIN_PP = dict(stages=4, micro=8, seq=512)
#: 19e: gemma3-1b's smoke config, 6 steps, a checkpoint at step 3
TRAIN_RESUME = dict(seq=256, batch=4, steps=6, ckpt_every=3)


#: what a kernels-line entry's ``plain_backward_max_abs_err`` measures
PLAIN_BACKWARD = ("plain_backward_max_abs_err: that backward in bf16 "
                  "against float32 at the training shapes (19a), which "
                  "the kernel's output does not enter")


def _train_want(arch: str, layers=None) -> tuple:
    """The launches one training step implies, in :func:`_counts`' order:
    each layer's forward (a prefill's launches, :data:`SERVING`) once in
    the forward and once more in remat's recompute, the final norm once
    (outside the checkpointed layers); the loss chunks launch nothing and
    the backward runs the plain versions."""
    from repro_torch.configs import get_config
    s, n_all = SERVING[arch], get_config(arch).n_layers
    n = layers or n_all
    f, m, d, c = (2 * s[k] // n_all * n
                  for k in ("flash", "moe", "ssd", "conv"))
    r = 2 * (s["rms"] - 1) // n_all * n + 1
    return (f, r, m, m, d, f, d, c)


def model_flops(cfg, seq: int, batch: int) -> dict:
    """Model FLOPs of one training step: 6 N T (N = every param, the tied
    embedding once as the head's product) plus attention's 12 L h dh c T,
    c a layer's context (s for a global layer, its window for a local
    one, no causal halving: PaLM's convention)."""
    from repro_torch.models.blocks import layer_window
    t = seq * batch
    dense = 6 * cfg.param_count() * t
    attn = 0
    if cfg.family != "ssm":
        dh = cfg.resolved_head_dim
        for i in range(cfg.n_layers):
            w = layer_window(cfg, i)
            ctx = seq if not w else min(w, seq)
            attn += 12 * cfg.n_heads * dh * ctx * t
    return {"dense": dense, "attention": attn, "total": dense + attn}


def counted_flops(cfg, seq: int, batch: int) -> float:
    """The FLOPs ``launch/costs.py`` counts in one training step of
    ``cfg`` at ``batch`` x ``seq`` (remat on), from a trace on the meta
    device: every matmul the step dispatches and each kernel's formula,
    the backward's recomputes included."""
    from repro_torch.configs import Shape
    from repro_torch.launch import dryrun
    fn, args = dryrun.local_cell(cfg, Shape("train", "train", seq, batch),
                                 device="meta")
    return dryrun.trace_cell(fn, args)["costs"].flops


def _grads(torch, fn, inputs, cts):
    """Gradients of ``fn(*inputs)`` (every floating input) pulled back
    from ``cts``."""
    xs = [x.detach().clone().requires_grad_(x.is_floating_point())
          for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    srcs = [x for x in xs if x.requires_grad]
    return torch.autograd.grad(outs[:len(cts)], srcs, cts)


def _grad_case(torch, name, kernel_fn, plain_fn, inputs, cts, variant_of):
    """One 19a case: the gradients of the wrapper on the bf16 inputs (its
    kernel forward, and the backward it records: autograd of the plain
    version, recomputed from the saved inputs) against autograd of the
    plain version on float32 copies.  The kernel's output enters no
    gradient, so this holds the recorded backward, not the kernel: the
    kernel's output is held at these shapes by phase 19's path checks.
    ``variant_of`` (B2, B4, B5) reports the variant the forward took,
    which must be the tensor cores' (the backward recomputes that
    variant's plain version)."""
    t0 = time.perf_counter()
    variant = None
    if variant_of is not None:
        _, variant = variant_of(lambda: kernel_fn(*inputs))
        if variant != "tc":
            raise AssertionError(f"{name} ran the {variant} variant, not "
                                 "the tensor cores")
    got = _grads(torch, kernel_fn, inputs, cts)
    fwd_ms = _wall_ms(torch, lambda: kernel_fn(*inputs))
    fb_ms = _wall_ms(torch, lambda: _grads(torch, kernel_fn, inputs, cts))
    want = _grads(torch, plain_fn, [x.float() if x.is_floating_point()
                                    else x for x in inputs],
                  [c.float() for c in cts])
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        err, share = _close(f"{name} d{i}", g.float(), w,
                            torch.bfloat16, atol=GRAD_TOL * scale,
                            rtol=GRAD_TOL)
        errs.append({"max_abs_err": err, "limit_share": share,
                     "max_abs_ref": scale})
    return {"case": name, "variant": variant, "grads": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "forward_ms": fwd_ms, "backward_ms": fb_ms - fwd_ms,
            "seconds": time.perf_counter() - t0}


def _wall_ms(torch, fn, reps: int = 3) -> float:
    """Median wall ms of ``fn()`` from a synchronized card to a
    synchronized card, after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def train_kernel_checks(torch) -> list:
    """19a: each wrapper in bf16 at the training shapes of 19b and 19c,
    the gradients of the backward it records (the plain version's
    autograd in bf16) against autograd of the plain version in float32
    (:func:`_grad_case`); each case's forward ms (the kernel) and
    backward ms (the plain version's recompute and autograd; forward +
    backward less forward), wall time on a synchronized card, median of
    3."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import \
        variant_of as flash_variant
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_ref,
                                              variant_of as ssd_variant)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=DEVICE)
                * scale).to(dtype)

    def seq_ref(**kw):
        def fn(q, k, v):
            o = flash_attention_ref(*(t.permute(1, 2, 0, 3)
                                      for t in (q, k, v)), **kw)
            return o.permute(2, 0, 1, 3)
        return fn

    cases = []
    for label, (s, b, hq, hkv, dh, window) in (
            ("gemma3_local", (2048, 4, 4, 1, 256, 512)),
            ("gemma3_global", (2048, 4, 4, 1, 256, GEMMA_GLOBAL)),
            ("olmoe", (1024, 2, 16, 16, 128, 0)),
            ("hymba_local", (1024, 2, 25, 5, 64, 1024)),
            ("hymba_global", (1024, 2, 25, 5, 64, GEMMA_GLOBAL))):
        kw = dict(causal=True, window=window, q_offset=0)
        q, k, v = rnd(s, b, hq, dh), rnd(s, b, hkv, dh), rnd(s, b, hkv, dh)
        cases.append(_grad_case(
            torch, f"flash_{label}", lambda q, k, v: flash_attention(
                q, k, v, **kw), seq_ref(**kw), (q, k, v),
            (rnd(s, b, hq, dh),), flash_variant))
    for label, rows, d in (("gemma3", 8192, 1152), ("gemma3_qk", 32768, 256),
                           ("mamba2_gated", 2048, 2048),
                           ("hymba", 2048, 1600)):
        x, w = rnd(rows, d), rnd(d, scale=0.5)
        cases.append(_grad_case(torch, f"rmsnorm_{label}", rmsnorm,
                                rmsnorm_ref, (x, w), (rnd(rows, d),), None))
    # B4 at olmoe's training shape: 2048 tokens, top-8 of 64, cap 320
    e, c, d, f = 64, 320, 2048, 1024
    rows = torch.randint(0, c + 1, (e,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    cases.append(_grad_case(
        torch, "moe_gmm_olmoe_swiglu",
        lambda x, w1, w2: moe_gmm(x, w1, w2, act="swiglu", rows=rows),
        lambda x, w1, w2: moe_gmm_ref(x, w1, w2, act="swiglu", rows=rows),
        (rnd(e, c, d), rnd(e, d, 2 * f, scale=d ** -0.5),
         rnd(e, f, d, scale=f ** -0.5)), (rnd(e, c, d),), _variant_of))
    # B5 at mamba2's and hymba's training shapes (seq-major, as ssm_op)
    for label, h, n in (("mamba2", 32, 128), ("hymba", 50, 16)):
        s, bs, p = 1024, 2, 64
        dt = (torch.rand(s, bs, h, generator=g, device=DEVICE) * 0.2
              + 0.01)
        a_log = rnd(h, scale=0.5, dtype=torch.float32)
        d_skip = rnd(h, dtype=torch.float32)

        def seq_plain(x, dt, a_log, b, c, d_skip):
            y, _ = ssd_scan_ref(x.permute(1, 2, 0, 3), dt.permute(1, 2, 0),
                                a_log, b.permute(1, 2, 0, 3),
                                c.permute(1, 2, 0, 3), d_skip)
            return y.permute(2, 0, 1, 3)
        cases.append(_grad_case(
            torch, f"ssd_scan_{label}",
            lambda *a: ssd_scan(*a)[0], seq_plain,
            (rnd(s, bs, h, p), dt, a_log, rnd(s, bs, 1, n, scale=0.3),
             rnd(s, bs, 1, n, scale=0.3), d_skip), (rnd(s, bs, h, p),),
            ssd_variant))
    return cases


def _busy_share(torch, fn) -> dict:
    """torch.profiler over ``fn()``: the device's kernel time against the
    wall time (one stream: kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(ms for _, ms in rows)
    return {"wall_ms": wall * 1e3, "device_ms": total,
            "device_busy_share": total / (wall * 1e3),
            "top": [{"kernel": k[:90], "ms": ms} for k, ms in
                    sorted(rows, key=lambda r: -r[1])[:12]]}


def _free_card(torch) -> None:
    """Free what earlier phases left in reference cycles (Python frees a
    cycle only when its collector runs), then the allocator's cache."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_run(torch, arch: str, layers, seq: int, batch: int, steps: int,
              timed: int, profile: bool = False, falls: bool = True
              ) -> dict:
    """``steps`` steps of ``make_train_step`` (remat on, bf16 params, the
    float32 master) on one fixed ``SyntheticPipeline`` batch; every step's
    launches checked against :func:`_train_want`; the losses finite and
    (``falls``) each below the one before."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state_init
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    want = _train_want(arch, layers)
    model = build_model(cfg, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN_LR)
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    state, specs = train_state_init(model, SEED, opt)
    step = make_train_step(model, specs, opt)
    data = SyntheticPipeline(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch).get_batch(0, device=DEVICE)
    losses, times = [], []
    for i in range(steps):
        c0 = _counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, data)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        got = tuple(b - a for a, b in zip(c0, _counts()))
        if got != want:
            raise AssertionError(
                f"{arch} training step {i} launched (flash, RMSNorm, MoE "
                f"GMM, MoE GMM tensor-core, SSD scan, flash tensor-core, "
                f"SSD scan tensor-core, SSM conv) {got}, want {want}")
    falling = all(b < a for a, b in zip(losses, losses[1:]))
    if not all(math.isfinite(x) for x in losses) or (falls and not falling):
        raise AssertionError(f"{arch} training losses {losses} are not "
                             "finite and falling")
    step_s = statistics.median(times[-timed:])
    flops = model_flops(cfg, seq, batch)
    counted = counted_flops(cfg, seq, batch)
    out = {"arch": arch, "layers": cfg.n_layers, "seq": seq, "batch": batch,
           "steps": steps, "losses": losses, "losses_held_falling": falls,
           "step_ms": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": seq * batch / step_s,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "peak_above_start_gb":
               (torch.cuda.max_memory_allocated() - start) / 1e9,
           "allocated_at_start_gb": start / 1e9,
           "launches_per_step": dict(zip(
               ("flash", "rmsnorm", "moe_gmm", "moe_gmm_tc", "ssd_scan",
                "flash_tc", "ssd_scan_tc", "ssm_conv"), want)),
           "model_flops": flops,
           "mfu": flops["total"] / step_s / PEAK_FLOPS["bfloat16"],
           "flops_counted": counted,
           "mfu_counted": counted / step_s / PEAK_FLOPS["bfloat16"],
           "counted_over_model_flops": counted / flops["total"],
           "mfu_peak": "989 TFLOP/s, H100 SXM dense bf16 (data sheet)",
           "mfu_terms": "6 N T + 12 L h dh c T: N every param, T the "
                        "step's tokens, c a layer's context (s global, "
                        "its window local), no causal halving",
           "params": cfg.param_count()}
    if profile:
        out["profile"] = _busy_share(torch, lambda: step(state, data))
    del state
    _free_card(torch)
    return out


def train_dp_phase(torch) -> dict:
    """19d: a) dp = 2 rank threads on one card (``launch/train.py --mesh
    2x1``'s path: ``spmd_map`` on a (2, 1) mesh, each rank the whole
    state and half the batch, the gradient meaned over the data axis on
    the rank thread after backward), gemma3-1b at full width and 2 layers:
    the synced grads bitwise equal across the ranks, within GRAD_TOL of
    each leaf's largest element of dp = 1's on the global batch, the
    compressed sync (int8 codes summed in int32 over the ranks, times the
    mean scale) bitwise that rule on the ranks' own grads and its distance
    from the exact sync reported, no copy through the host, the B2 and
    B3 launches exactly two steps' in total (a rank's remat recompute runs
    on autograd's device thread, not on its rank thread, so the gate is
    on totals); then one launcher step (``mesh_step``) whose
    loss is dp = 1's within 1e-2; b) ``PipelinedModel``, 4 stages (one
    gemma3-1b layer each) x 8 microbatches, its grads against the
    monolithic step's within GRAD_TOL of each leaf's largest element, its
    launches exactly the schedule's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.core.transport.wire import to_card, to_host
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh, P, PipelinedModel, local_comm
    from repro_torch.distributed import spmd_map
    from repro_torch.distributed.compression import (grad_sync_compressed,
                                                     init_error_state,
                                                     quantize_int8)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.launch.mesh import batch_pspecs
    from repro_torch.launch.train import mesh_step, shard_state
    from repro_torch.models import lm
    from repro_torch.models.blocks import tp_plan
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, grad_sync
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train import TrainState, loss_and_grads
    out = {}
    _free_card(torch)
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              n_layers=TRAIN_DP["layers"])
    model = build_model(cfg, device=DEVICE)
    params, specs = model.init(SEED)
    data = SyntheticPipeline(vocab=cfg.vocab, seq_len=TRAIN_DP["seq"],
                             global_batch=TRAIN_DP["batch"]).get_batch(
                                 0, device=DEVICE)
    f_step, r_step = _train_want("gemma3-1b", TRAIN_DP["layers"])[:2]
    by_rank = {}

    def rank_fn(comm, params, batch):
        comm = dataclasses.replace(comm, fsdp=False)
        _, m, grads = loss_and_grads(model, params, batch, comm)
        synced = grad_sync(grads, specs, comm)
        comp, _ = grad_sync_compressed(grads, specs,
                                       init_error_state(grads), comm)
        by_rank[comm.data_index()] = (synced, comp, grads)
        return 0

    config = CommConfig(mode=CommMode.LCI_DEDICATED)
    with Mesh((2, 1), ("data", "model"), device=DEVICE) as mesh:
        bspec = batch_pspecs(cfg, "train", mesh, batch=TRAIN_DP["batch"])
        n0 = (flash_attention_bhsd.launches, rmsnorm.launches)
        host0 = (to_host.copies, to_card.copies)
        t = time.perf_counter()
        spmd_map(rank_fn, mesh, (P(), bspec), None, config=config)(params,
                                                                   data)
        torch.cuda.synchronize()
        out["dp2_grads_s"] = time.perf_counter() - t
        host = (to_host.copies - host0[0], to_card.copies - host0[1])
        n_dp = (flash_attention_bhsd.launches - n0[0],
                rmsnorm.launches - n0[1])
        if n_dp != (2 * f_step, 2 * r_step):
            raise AssertionError(f"dp = 2 launched (flash, RMSNorm) {n_dp}, "
                                 f"want two steps' {(2 * f_step, 2 * r_step)}")
        if host != (0, 0):
            raise AssertionError(f"grad_sync copied through the host "
                                 f"(to_host, to_card) {host}")
        opt = AdamWConfig(lr=TRAIN_LR)
        state = shard_state(TrainState(params, adamw_init(params, opt)),
                            specs, mesh)
        t = time.perf_counter()
        _, m2 = mesh_step(model, specs, opt, mesh, config,
                          batch=TRAIN_DP["batch"])(state, data)
        dp2_loss = float(m2["loss"])
        out["dp2_step_s"] = time.perf_counter() - t
        out["protocol_totals"] = mesh.protocol_totals()
        del state
    _, m1, one = loss_and_grads(model, params, data, local_comm())
    g0, g1 = (dict(leaves_with_paths(by_rank[r][0])) for r in (0, 1))
    c0, c1 = (dict(leaves_with_paths(by_rank[r][1])) for r in (0, 1))
    l0, l1 = (dict(leaves_with_paths(by_rank[r][2])) for r in (0, 1))
    worst, worst_c = 0.0, 0.0
    for name, want in leaves_with_paths(one):
        if not torch.equal(g0[name], g1[name]) or \
                not torch.equal(c0[name], c1[name]):
            raise AssertionError(f"dp = 2 synced grad {name} differs "
                                 "between the ranks")
        scale = float(want.float().abs().max())
        err = float((g0[name].float() - want.float()).abs().max())
        if err > GRAD_TOL * scale:
            raise AssertionError(f"dp = 2 grad {name}: {err} from dp = 1, "
                                 f"limit {GRAD_TOL} x {scale}")
        # the compressed sync bitwise its own rule on the two ranks'
        # local grads: the int8 codes summed in int32, times the mean
        # scale, over dp
        (q0, s0), (q1, s1) = (quantize_int8(l[name]) for l in (l0, l1))
        rule = ((q0.to(torch.int32) + q1.to(torch.int32)).float()
                * ((s0 + s1) / 2) / 2).to(c0[name].dtype)
        if not torch.equal(c0[name], rule):
            raise AssertionError(f"compressed grad {name} is not the int8 "
                                 "rule on the ranks' grads")
        gmax = float(g0[name].float().abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        worst_c = max(worst_c, float((c0[name].float() - g0[name].float())
                                     .abs().max()) / max(gmax, 1e-30))
    loss1 = float(m1["loss"])
    if abs(dp2_loss - loss1) > 1e-2 * abs(loss1):
        raise AssertionError(f"dp = 2 step loss {dp2_loss}, dp = 1 "
                             f"{loss1}")
    out.update({"dp": 2, "layers": cfg.n_layers, "seq": TRAIN_DP["seq"],
                "batch": TRAIN_DP["batch"], "ranks_bitwise_equal": True,
                "grad_worst_share_of_max_vs_dp1": worst,
                "compressed_worst_share_of_max": worst_c,
                "loss_dp2": dp2_loss, "loss_dp1": loss1,
                "host_copies": list(host),
                "launches": dict(zip(("flash", "rmsnorm"), n_dp)),
                "launch_gate": "totals: two steps' launches (a rank's "
                "remat recompute runs on autograd's device thread)"})
    del params, one, by_rank
    _free_card(torch)

    # b) PipelinedModel: 4 gemma3-1b layers as stages, 8 microbatches
    cfg4 = dataclasses.replace(get_config("gemma3-1b"),
                               n_layers=TRAIN_PP["stages"])
    p4, _ = build_model(cfg4, device=DEVICE).init(SEED)
    plan, comm = tp_plan(cfg4, 1), local_comm()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    xs = [torch.randn(TRAIN_PP["seq"], 1, cfg4.d_model, generator=g,
                      device=DEVICE).to(cfg4.dtype)
          for _ in range(TRAIN_PP["micro"])]

    def stage(s):
        return lambda p, x: lm._decoder_block(x, p, s, cfg4, comm, plan,
                                              0)[0]
    stages = [stage(s) for s in range(TRAIN_PP["stages"])]
    sp = [lm.layer_params(p4, s) for s in range(TRAIN_PP["stages"])]

    def loss_fn(y, m):
        return (y.float() ** 2).mean()

    c0 = _counts()
    t = time.perf_counter()
    loss_pp, grads_pp = PipelinedModel(stages, TRAIN_PP["micro"]) \
        .forward_backward(sp, xs, loss_fn)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t
    got = tuple(b - a for a, b in zip(c0, _counts()))
    n_nodes = TRAIN_PP["stages"] * TRAIN_PP["micro"]
    want = (2 * n_nodes, 2 * 4 * n_nodes, 0, 0, 0, 2 * n_nodes, 0, 0)
    if got != want:
        raise AssertionError(f"PipelinedModel launched {got}, want {want} "
                             "(each stage's forward, and again in its "
                             "backward node)")
    tracked = [{k: v.detach().requires_grad_() for k, v in p.items()}
               for p in sp]
    total = []
    with torch.enable_grad():
        for m, x in enumerate(xs):
            for s in range(TRAIN_PP["stages"]):
                x = stages[s](tracked[s], x)
            total.append(loss_fn(x, m))
        total = torch.stack(total)
        flat = [v for p in tracked for _, v in sorted(p.items())]
        mono = torch.autograd.grad(total.sum(), flat)
    mono = iter(mono)
    worst_pp = 0.0
    for s in range(TRAIN_PP["stages"]):
        for k in sorted(tracked[s]):
            want_g = next(mono).float()
            got_g = grads_pp[s][k].float()
            scale = float(want_g.abs().max())
            err = float((got_g - want_g).abs().max())
            if err > GRAD_TOL * scale:
                raise AssertionError(f"PipelinedModel stage {s} grad {k}: "
                                     f"{err} from the monolithic step, "
                                     f"limit {GRAD_TOL} x {scale}")
            worst_pp = max(worst_pp, err / max(scale, 1e-30))
    mono_loss = float(total.detach().mean())
    if abs(float(loss_pp) - mono_loss) > 1e-3 * abs(mono_loss):
        raise AssertionError(f"PipelinedModel loss {float(loss_pp)}, "
                             f"monolithic {mono_loss}")
    out["pipeline"] = {"stages": TRAIN_PP["stages"],
                       "micro": TRAIN_PP["micro"],
                       "micro_shape": [TRAIN_PP["seq"], 1, cfg4.d_model],
                       "seconds": pp_s, "launches": dict(zip(
                           ("flash", "rmsnorm"), got[:2])),
                       "grad_worst_share_of_max": worst_pp,
                       "loss": float(loss_pp)}
    return out


def train_resume_phase(torch) -> dict:
    """19e: ``train_loop`` for 6 steps with a checkpoint at step 3 into a
    temporary directory, then a resume to 6 from it, against a straight
    run of 6: the params bitwise equal, under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's
    scatter-add is not deterministic otherwise)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.train.loop import LoopConfig, train_loop
    cfg = get_smoke("gemma3-1b")
    model = build_model(cfg, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN_LR)
    pipe = SyntheticPipeline(vocab=cfg.vocab, seq_len=TRAIN_RESUME["seq"],
                             global_batch=TRAIN_RESUME["batch"])
    steps = TRAIN_RESUME["steps"]

    def fresh():
        state, specs = train_state_init(model, SEED, opt)
        return state, make_train_step(model, specs, opt)

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="phase19_ckpt_",
                           dir=os.path.join(ROOT, "build"))
    try:
        t = time.perf_counter()
        state, step = fresh()
        straight, _ = train_loop(state, step, pipe,
                                 LoopConfig(total_steps=steps, log_every=0))
        state, step = fresh()
        train_loop(state, step, pipe, LoopConfig(
            total_steps=TRAIN_RESUME["ckpt_every"], ckpt_dir=tmp,
            ckpt_every=TRAIN_RESUME["ckpt_every"], log_every=0))
        state, step = fresh()
        resumed, hist = train_loop(state, step, pipe, LoopConfig(
            total_steps=steps, ckpt_dir=tmp, ckpt_every=100, log_every=0))
        seconds = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(tmp, ignore_errors=True)
    if [r["step"] for r in hist] != list(range(TRAIN_RESUME["ckpt_every"],
                                               steps)):
        raise AssertionError(f"the resume ran steps "
                             f"{[r['step'] for r in hist]}")
    dist = 0.0
    for (n, a), (_, b) in zip(leaves_with_paths(straight.params),
                              leaves_with_paths(resumed.params)):
        dist = max(dist, float((a.float() - b.float()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"resumed param {n} differs from the "
                                 f"straight run by {dist}")
    return {"config": cfg.name, "steps": steps,
            "checkpoint_at": TRAIN_RESUME["ckpt_every"],
            "mode": "torch.use_deterministic_algorithms(True), "
                    "CUBLAS_WORKSPACE_CONFIG=:4096:8",
            "max_abs_distance": dist, "bitwise": True,
            "loops_seconds": seconds}


def training_phase(torch, counters, profile: bool) -> tuple:
    """Phase 19: 19a holds each wrapper's backward (the plain version's
    autograd) at the training shapes (its launches are not the path's);
    the counts are set to 0 just before 19b-e and read just after; every
    kernel call of 19b-e is kept by signature, and each kernel is held
    against its plain version at each one after the counts are read.
    Returns 19a's cases, the launches of 19b-e by kernel and the path
    checks by kernel."""
    from repro_torch.kernels.doorbell import stage_copy_rows
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.kernels.ssm_conv import ssm_conv
    t19 = time.perf_counter()
    t0 = time.perf_counter()
    grad_cases = train_kernel_checks(torch)
    record("train_kernel_grads", seconds=time.perf_counter() - t0,
           cases=grad_cases)
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        gemma = train_run(torch, TRAIN_GEMMA["arch"], None,
                          TRAIN_GEMMA["seq"], TRAIN_GEMMA["batch"],
                          TRAIN_GEMMA["steps"], TRAIN_GEMMA["timed"],
                          profile=profile)
        record("train_gemma3", seconds=time.perf_counter() - t0, **gemma)
        print(f"phase 19b gemma3-1b {gemma['batch']} x {gemma['seq']}: "
              f"{gemma['step_ms']:.1f} ms a step, MFU {gemma['mfu']:.4f} "
              f"of {gemma['model_flops']['total']:.6g} model_flops, "
              f"{gemma['mfu_counted']:.4f} of {gemma['flops_counted']:.6g} "
              f"counted FLOPs ({_card_line()})", flush=True)
        for arch, layers, falls in TRAIN_FAMILIES:
            t0 = time.perf_counter()
            fam = train_run(torch, arch, layers, TRAIN_SMALL["seq"],
                            TRAIN_SMALL["batch"], TRAIN_SMALL["steps"],
                            TRAIN_SMALL["steps"] - 1, profile=profile,
                            falls=falls)
            record("train_family", seconds=time.perf_counter() - t0, **fam)
        t0 = time.perf_counter()
        dp = train_dp_phase(torch)
        record("train_dp_pipeline", seconds=time.perf_counter() - t0, **dp)
        t0 = time.perf_counter()
        resume = train_resume_phase(torch)
        record("train_resume", seconds=time.perf_counter() - t0, **resume)
        g_launches = {"flash_attention": flash_attention_bhsd.launches,
                      "rmsnorm": rmsnorm.launches,
                      "moe_gmm": moe_gmm.launches,
                      "ssd_scan": ssd_scan_bhsp.launches,
                      "ssm_conv": ssm_conv.launches,
                      "doorbell": stage_copy_rows.launches}
        g_by_variant = {
            "flash_attention": dict(flash_attention_bhsd.launches_by_variant),
            "moe_gmm": dict(moe_gmm.launches_by_variant),
            "ssd_scan": dict(ssd_scan_bhsp.launches_by_variant)}
    if min(g_launches[k] for k in ("flash_attention", "rmsnorm", "moe_gmm",
                                   "ssd_scan")) == 0:
        raise AssertionError(f"the training path launched a kernel no "
                             f"time: {g_launches}")
    _free_card(torch)
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, path.calls, prefix="train_path",
                                b4_scaled=True)
    del path
    missing = [k for k, n in (("flash", g_launches["flash_attention"]),
                              ("rmsnorm", g_launches["rmsnorm"]),
                              ("moe_gmm", g_launches["moe_gmm"]),
                              ("ssd_scan", g_launches["ssd_scan"]),
                              ("ssm_conv", g_launches["ssm_conv"]),
                              ("doorbell", g_launches["doorbell"]))
               if n and not checks[k]]
    if missing:
        raise AssertionError(f"phase 19 launched {missing} at no signature "
                             "that was kept")
    record("phase19_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(v) for k, v in checks.items()},
           cases=checks)
    record("phase19", seconds=time.perf_counter() - t19,
           launches=g_launches, launches_by_variant=g_by_variant)
    return grad_cases, g_launches, checks


# ---------------------------------------------------------------------------
# phase 20: the vlm and audio families
# ---------------------------------------------------------------------------

#: 20a: whisper-tiny at its full configuration (4 + 4 layers, d 384, 1500
#: frames, vocab 51865), bf16: encode, the cross-KV, a 64-token prompt's
#: prefill, the prompt teacher-forced through the decode step, 16 greedy
#: steps
WHISPER_SERVE = dict(arch="whisper-tiny", batch=4, prompt=64, new=16)
#: 20b: llama-3.2-vision at its full width cut to 10 layers (8 self + 2
#: gated cross): the 100-layer model's ~180 GB of bf16 weights do not fit
#: the card's 80 GB, 10 layers are ~10.8 B params (~21.6 GB); the gates
#: 0.5 (at init they are 0, and the cross layers would add nothing); the
#: float32 run on the same weights (~43 GB)
VISION_SERVE = dict(arch="llama-3.2-vision-90b", layers=10, batch=2,
                    prompt=128, new=16, gate=0.5)
#: 20c: a training step of whisper-tiny at full width (remat, AdamW; the
#: launcher's stub frames, 1500 rounded up to 1504) and of
#: llama-3.2-vision at its SMOKE widths: at full width 10 layers' params
#: with the float32 master and moments (2 + 12 bytes a param) are ~151 GB
WHISPER_TRAIN = dict(seq=256, batch=4, steps=3)
VISION_SMOKE_TRAIN = dict(seq=128, batch=4, steps=3)


def cross_want(cfg) -> dict:
    """B2 and B3 launches of a vlm or audio config: a prefill (a
    forward), a decode step, the encoder alone, and a training step
    (remat recomputes every checkpointed layer once; the final norm runs
    outside them)."""
    final = int(cfg.norm == "rmsnorm")
    if cfg.family == "vlm":
        n_cross = cfg.n_cross_layers
        n_self = cfg.n_layers - n_cross
        flash, enc = cfg.n_layers, 0
        rms = 2 * n_self + 2 * n_cross + final  # norm1/norm2, normx/normm
    else:
        flash = cfg.encoder_layers + 2 * cfg.n_layers   # enc, self, cross
        enc = cfg.encoder_layers
        rms = cfg.n_layers + final       # normx (layernorm elsewhere)
    return {"prefill": (flash, rms), "step": (0, rms), "encode": (enc, 0),
            "train": (2 * flash, 2 * (rms - final) + final)}


def _b2_b3(c0, variant: str) -> tuple:
    """(B2, B3) launches since the :func:`_counts` snapshot ``c0``;
    raises unless every B2 launch took ``variant`` and no B4, B5 or SSM
    conv kernel ran."""
    d = [b - a for a, b in zip(c0, _counts())]
    tc_ok = d[5] == (d[0] if variant == "tc" else 0)
    if d[2] or d[4] or d[7] or not tc_ok:
        raise AssertionError(f"launched (flash, RMSNorm, MoE GMM, MoE GMM "
                             f"tc, SSD scan, flash tc, SSD scan tc, SSM "
                             f"conv) {d} (want every B2 launch {variant}, "
                             "no B4, B5 or SSM conv)")
    return d[0], d[1]


class _StepLogits:
    """While installed, keeps the logits of every decode step
    (``serving/engine.py``'s ``lm_head_logits``)."""

    def __enter__(self):
        import repro_torch.serving.engine as engine
        self.mod, self.real, self.logits = engine, engine.lm_head_logits, []

        def kept(*a, **kw):
            out = self.real(*a, **kw)
            self.logits.append(out)
            return out
        engine.lm_head_logits = kept
        return self

    def __exit__(self, *exc):
        self.mod.lm_head_logits = self.real


def bf16_decode_gate(torch, label, vocab, ld, lf, lf32, tok_d) -> dict:
    """The bf16 teacher-forced decode's logits ``ld`` (s, b, V) and
    tokens ``tok_d`` (s, b) against the float32 forward ``lf32`` at the
    same weights and inputs.  The bf16 forward ``lf`` is the witness of
    what bf16 rounding alone does to this network, measured outside the
    decode (phase 17b's rule): the decode's logits no further from
    float32 than twice the bf16 forward's, norm-wise; and its token
    float32's argmax wherever float32's top two logits are further apart
    than the tie threshold, four times the bf16 forward's largest logit
    error (a decode within twice that error keeps the argmax).  Raises
    on a miss."""
    ld, lf, lf32 = (t[..., :vocab].double() for t in (ld, lf, lf32))
    tok = tok_d.long()
    w_rel, d_rel = _rel_err(lf, lf32), _rel_err(ld, lf32)
    w_max = float((lf - lf32).abs().max())
    top2 = lf32.topk(2, dim=-1).values
    arg32 = lf32.argmax(-1)
    gated = top2[..., 0] - top2[..., 1] > 4 * w_max
    bad = gated & (tok != arg32)
    if not d_rel <= 2 * w_rel or bad.any():
        raise AssertionError(f"{label}: bf16 decode {d_rel} from the float32 "
                             f"forward (bf16 forward: {w_rel}; limit "
                             f"{2 * w_rel}); {int(bad.sum())} of "
                             f"{int(gated.sum())} tokens beyond the tie "
                             f"threshold {4 * w_max} differ from its argmax")
    return {"positions": tok.numel(),
            "decode_rel_err_vs_float32": d_rel,
            "bf16_forward_rel_err_vs_float32": w_rel,
            "decode_rel_err_vs_bf16_forward": _rel_err(ld, lf),
            "decode_max_logit_err_vs_float32":
                float((ld - lf32).abs().max()),
            "bf16_forward_max_logit_err_vs_float32": w_max,
            "tie_threshold": 4 * w_max, "gated_positions": int(gated.sum()),
            "decode_agreement_float32": float((tok == arg32).float().mean()),
            "bf16_forward_agreement_float32":
                float((lf.argmax(-1) == arg32).float().mean()),
            "decode_agreement_bf16_forward":
                float((tok == lf.argmax(-1)).float().mean())}


def cross_serve_case(torch, label, cfg, params, ext, prompt, new: int,
                     profile: bool = False) -> tuple:
    """A vlm or audio config served through the engine's entry points:
    the memory (the encoder over the frames, or the image embeddings),
    ``precompute_cross_kv``, ``make_prefill_step`` on the prompt (one
    untimed call, PREFILL_CALLS timed), then ``make_serve_step`` over
    the prompt teacher-forced and ``new`` greedy steps; every call's B2
    and B3 launches checked (:func:`cross_want`; B2 "tc" in bf16, "simt"
    in float32).  Returns the record and, for :func:`same_weights_f32`,
    the sequence teacher-forced, the decode's tokens and logits and the
    full forward's logits over that sequence."""
    from repro_torch.distributed import local_comm
    from repro_torch.models import lm
    from repro_torch.models.blocks import tp_plan
    from repro_torch.models.layers import lm_head_logits
    from repro_torch.models.registry import build_model
    from repro_torch.serving import (init_cache, make_prefill_step,
                                     make_serve_step)
    from repro_torch.serving.engine import precompute_cross_kv
    want = cross_want(cfg)
    variant = "tc" if cfg.dtype == torch.bfloat16 else "simt"
    s, b = prompt.shape
    comm = local_comm()
    out = {"config": cfg.name, "dtype": str(cfg.dtype).split(".")[1],
           "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "batch": b, "prompt": s, "new_tokens": new,
           "flash_variant": variant}

    def timed(fn, expect, name):
        c0 = _counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = _b2_b3(c0, variant)
        if got != expect:
            raise AssertionError(f"{label} {name}: (B2, B3) launches {got},"
                                 f" want {expect}")
        return res, ms

    torch.cuda.reset_peak_memory_stats()
    if cfg.is_encdec:
        def encode():
            return lm._encode(params, ext, cfg, comm, tp_plan(cfg, 1),
                              remat=False)
        encode_ms = [timed(encode, want["encode"], "encode")[1]
                     for _ in range(PREFILL_CALLS + 1)]
        mem, _ = timed(encode, want["encode"], "encode")
        out["encode_ms"] = statistics.median(encode_ms[1:])
    else:
        mem = ext["image_embeds"]
    (ck, cv), out["cross_kv_ms"] = timed(
        lambda: precompute_cross_kv(params, mem, cfg), (0, 0), "cross-KV")
    out["cross_kv_shape"] = list(ck.shape)
    prefill = make_prefill_step(cfg)
    times = []
    for i in range(PREFILL_CALLS + 1):
        (tok, last), ms = timed(lambda: prefill(params, {"tokens": prompt,
                                                         **ext}),
                                want["prefill"], "prefill")
        times.append(ms)
    if not torch.isfinite(last.float()).all() or tok.shape != (b,):
        raise AssertionError(f"{label} prefill: non-finite hidden state")
    out["prefill_ms"] = statistics.median(times[1:])
    out["prefill_ms_each"] = times[1:]
    out["prefill_tokens_per_s"] = s * b / (out["prefill_ms"] / 1e3)
    cache = init_cache(cfg, s + new, b, n_memory=mem.shape[0],
                       device=DEVICE)
    cache.cross_k, cache.cross_v = ck, cv
    step = make_serve_step(cfg)
    ins, outs, step_ms = [], [], []
    with _StepLogits() as logs:
        nxt = None
        for i in range(s + new):
            inp = prompt[i] if i < s else nxt
            (nxt, cache), ms = timed(lambda: step(params, cache, inp),
                                     want["step"], "decode step")
            ins.append(inp)
            outs.append(nxt)
            step_ms.append(ms)
    tok_d = torch.stack(outs)
    seq = torch.stack(ins)
    with torch.no_grad():
        x, _ = build_model(cfg, device=DEVICE).forward(
            params, {"tokens": seq, **ext})
        lf = lm_head_logits(x, params.get("lm_head", params["emb"]), comm,
                            real_vocab=cfg.vocab)
    held = {"seq": seq, "tok_d": tok_d, "ld": torch.stack(logs.logits),
            "lf": lf}
    out["logit_std"] = float(lf[..., :cfg.vocab].float().std())
    out["prefill_token_equals_decode"] = bool(torch.equal(tok, tok_d[s - 1]))
    out["decode_ms_per_step_prompt"] = statistics.median(step_ms[:s])
    if new:
        out["decode_ms_per_step"] = statistics.median(step_ms[s:])
        out["decode_tokens_per_s"] = b / (out["decode_ms_per_step"] / 1e3)
    out["launches"] = {k: dict(zip(("flash", "rmsnorm"), v))
                       for k, v in want.items() if k != "train"}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        pcache = init_cache(cfg, 16, b, n_memory=mem.shape[0],
                            device=DEVICE)
        pcache.cross_k, pcache.cross_v = ck, cv
        out["profile"] = profile_phase(torch, cfg, params, prompt, ext,
                                       pcache)
    return out, held


def _to_float32_(tree) -> None:
    """Every floating leaf of a params tree replaced by its float32 cast,
    one leaf at a time (the bf16 leaf freed as its cast lands)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_float32_(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def _fan_in_scaled_(params) -> None:
    """Each stacked matrix (L, fan_in, fan_out) of a params tree rescaled
    in place from the init's std, 1/sqrt(L) in both packages, to
    1/sqrt(fan_in).  At the init's scale the residual grows ~1000-fold
    in the first layer and attention saturates, so bf16 rounding alone
    moves whisper's logits as far as an unrelated network's (phase 20a's
    first run); at this scale it moves them little, and a bf16 decode
    fault stands out."""
    for v in _leaves(params):
        if v.ndim == 3:
            v.mul_(math.sqrt(v.shape[0] / v.shape[1]))


def same_weights_f32(torch, label, cfg, params, ext, held) -> dict:
    """The bf16 run's weights ``params`` cast to float32 in place (TF32
    off; the caller's bf16 tree is gone after), and the bf16 run's
    sequence ``held["seq"]`` through :func:`_decode_vs_forward` in
    float32 with the extras ``ext``: phase 6's gate
    (:func:`_parity_gate`).  Then the bf16 decode held against that
    float32 forward (:func:`bf16_decode_gate`)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    _to_float32_(params)
    res, lf32 = _decode_vs_forward(torch, cfg32, params, held["seq"],
                                   {k: v.float() for k, v in ext.items()})
    _parity_gate(label, res)
    gate = bf16_decode_gate(torch, label, cfg.vocab, held["ld"], held["lf"],
                            lf32, held["tok_d"])
    return {"float32": {"positions": held["seq"].numel(),
                        "logit_std": float(lf32[..., :cfg.vocab].std()),
                        **res},
            "bf16_decode_vs_float32": gate}


def _whisper_frames(cfg, batch):
    from repro_torch.data import stub_frames
    return {"frames": torch_from(stub_frames(cfg.n_audio_frames, batch,
                                             cfg.d_model), cfg.dtype)}


def _vision_image(cfg, batch, step=0):
    from repro_torch.data import stub_image_embeds
    return {"image_embeds": torch_from(stub_image_embeds(
        cfg.n_image_tokens, batch, cfg.d_model, step), cfg.dtype)}


def torch_from(arr, dtype):
    """A numpy array on the card in ``dtype``."""
    import torch
    return torch.from_numpy(arr).to(DEVICE, dtype)


def whisper_serve_phase(torch, profile: bool) -> dict:
    """20a: whisper-tiny's full config in bf16, seeded random weights on
    the card, the stub frames drawn with numpy (``data/pipeline.py``,
    seed 2); then the same weights in float32 (:func:`same_weights_f32`).
    Both again with the weights at std 1/sqrt(fan_in)
    (:func:`_fan_in_scaled_`), where bf16 is not chaotic and the bf16
    gate is tight."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    w = WHISPER_SERVE
    cfg = get_config(w["arch"])
    params, _ = build_model(cfg, device=DEVICE).init(SEED)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab, (w["prompt"], w["batch"])).astype(np.int32)).to(
        DEVICE)
    ext = _whisper_frames(cfg, w["batch"])
    out, held = cross_serve_case(torch, "whisper-tiny", cfg, params, ext,
                                 prompt, w["new"], profile)
    out["params"] = sum(int(t.numel()) for t in _leaves(params))
    out["frames"] = cfg.n_audio_frames
    out.update(same_weights_f32(torch, "whisper-tiny", cfg, params, ext,
                                held))
    params, _ = build_model(cfg, device=DEVICE).init(SEED)
    _fan_in_scaled_(params)
    label = "whisper-tiny, weights at 1/sqrt(fan_in)"
    scaled, held = cross_serve_case(torch, label, cfg, params, ext, prompt,
                                    w["new"])
    scaled.update(same_weights_f32(torch, label, cfg, params, ext, held))
    out["fan_in_scaled"] = {k: scaled[k] for k in (
        "logit_std", "float32", "bf16_decode_vs_float32")}
    del params, held
    _free_card(torch)
    return out


def vision_serve_phase(torch, profile: bool) -> dict:
    """20b: llama-3.2-vision at full width, 10 layers, bf16; weights
    drawn on the card from an explicit generator, the gates set to 0.5,
    the stub image embeddings drawn with numpy (seed 1).  The image
    check on the prefill's last logits: the same image gives the same
    bits, another image moves them, and with the gates at 0 another
    image changes no bit (so the cross layers carry the image).  Then
    the same weights in float32 (:func:`same_weights_f32`; ~43 GB, the
    bf16 tree cast leaf by leaf)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import local_comm
    from repro_torch.models.layers import lm_head_logits
    from repro_torch.models.registry import build_model
    from repro_torch.serving import make_prefill_step
    v = VISION_SERVE
    full = get_config(v["arch"])
    cfg = dataclasses.replace(full, n_layers=v["layers"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params, _ = build_model(cfg, device=DEVICE).init(gen)
    gates = params["cross_layers"]
    for k in ("gate_attn", "gate_mlp"):
        gates[k].fill_(v["gate"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab, (v["prompt"], v["batch"])).astype(np.int32)).to(
        DEVICE)
    ext = _vision_image(cfg, v["batch"])
    out, held = cross_serve_case(torch, "llama-3.2-vision", cfg, params,
                                 ext, prompt, v["new"], profile)
    prefill = make_prefill_step(cfg)

    def last_logits(step):
        _, last = prefill(params, {"tokens": prompt,
                                   **_vision_image(cfg, v["batch"], step)})
        return lm_head_logits(last, params["lm_head"], local_comm(),
                              real_vocab=cfg.vocab)
    a, again, other = last_logits(0), last_logits(0), last_logits(1)
    moved = float((other - a).abs().max())
    n_cross = cfg.n_cross_layers
    for k in ("gate_attn", "gate_mlp"):
        gates[k].zero_()
    shut = torch.equal(last_logits(0), last_logits(1))
    for k in ("gate_attn", "gate_mlp"):
        gates[k].fill_(v["gate"])
    if not torch.equal(a, again) or not moved > 1e-2 or not shut:
        raise AssertionError(f"llama-3.2-vision image check: same image "
                             f"bitwise {torch.equal(a, again)}, another "
                             f"moved the logits by {moved}, gates 0 "
                             f"bitwise {shut}")
    out.update({"params": sum(int(t.numel()) for t in _leaves(params)),
                "init_s": init_s, "image_tokens": cfg.n_image_tokens,
                "gates": v["gate"], "image_check": {
                    "other_image_max_logit_change": moved,
                    "same_image_bitwise": True,
                    "gates_zero_other_image_bitwise": True},
                "cut": f"depth {cfg.n_layers} of {full.n_layers} "
                       f"({cfg.n_layers - n_cross} self + {n_cross} gated "
                       "cross layers), full width: the 100-layer model's "
                       "~180 GB of bf16 weights exceed the card's 80 GB"})
    del gates, a, again, other
    _free_card(torch)
    out.update(same_weights_f32(torch, "llama-3.2-vision", cfg, params, ext,
                                held))
    del params, held
    _free_card(torch)
    return out


def cross_train_run(torch, label, cfg, seq: int, batch: int, steps: int,
                    variant: str) -> dict:
    """``steps`` steps of ``make_train_step`` (remat on, bf16 params, the
    float32 master, AdamW) on one fixed batch with the launcher's
    frontend stub (``launch/train.py::batch_extras``); a vlm config's
    gates set to 0.5 in the params and the master.  Every step's B2 and
    B3 launches checked (:func:`cross_want`); the losses finite and the
    last below the first."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.train import batch_extras
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state_init
    want = cross_want(cfg)["train"]
    model = build_model(cfg, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN_LR)
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    state, specs = train_state_init(model, SEED, opt)
    if cfg.family == "vlm":
        for tree in (state.params, state.opt.master):
            for k in ("gate_attn", "gate_mlp"):
                tree["cross_layers"][k].fill_(VISION_SERVE["gate"])
    step = make_train_step(model, specs, opt)
    data = SyntheticPipeline(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch).get_batch(0, device=DEVICE)
    data.update(batch_extras(cfg, batch, 0, DEVICE))
    losses, times = [], []
    for i in range(steps):
        c0 = _counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, data)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        got = _b2_b3(c0, variant)
        if got != want:
            raise AssertionError(f"{label} training step {i}: (B2, B3) "
                                 f"launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{label} training losses {losses} are not "
                             "finite and falling")
    step_s = statistics.median(times[1:])
    out = {"config": cfg.name, "layers": cfg.n_layers, "seq": seq,
           "batch": batch, "extras": {k: list(t.shape) for k, t in
                                      data.items() if k not in
                                      ("tokens", "labels")},
           "steps": steps, "losses": losses, "step_ms": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": seq * batch / step_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": cfg.param_count(),
           "launches_per_step": dict(zip(("flash", "rmsnorm"), want)),
           "flash_variant": variant}
    del state
    _free_card(torch)
    return out


def cross_kernel_cases(torch) -> tuple:
    """20d: B2 at the phase's new signatures (whisper's encoder and
    cross-attention, the vision model's self- and cross-attention; bf16
    "tc") and B3 at the vision model's width and whisper's, held against
    their plain versions and timed beside the bound and the library
    call (for the unmasked ones ``scaled_dot_product_attention`` with no
    mask); then the recorded backward at the unmasked signatures of
    20c's whisper step (:func:`_grad_case`)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import \
        variant_of as flash_variant
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    bf = torch.bfloat16
    w, v = WHISPER_SERVE, VISION_SERVE
    t = 1500
    flash = [flash_case(torch, label, *shape, bf, g) for label, shape in (
        ("whisper_encoder_bfloat16",
         (w["batch"], 6, 6, t, t, 64, False, 0, 0)),
        ("whisper_cross_bfloat16",
         (w["batch"], 6, 6, w["prompt"], t, 64, False, 0, 0)),
        ("vision_self_bfloat16",
         (v["batch"], 64, 8, v["prompt"], v["prompt"], 128, True, 0, 0)),
        ("vision_cross_bfloat16",
         (v["batch"], 64, 8, v["prompt"], 1600, 128, False, 0, 0)))]
    rms = [rmsnorm_case(torch, f"{name}_bfloat16_{rows}x{d}", rows, d, bf, g)
           for name, rows, d in (
               ("vision_prefill", v["batch"] * v["prompt"], 8192),
               ("vision_decode", v["batch"], 8192),
               ("whisper_prefill", w["batch"] * w["prompt"], 384),
               ("whisper_decode", w["batch"], 384))]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE).to(bf)

    def seq_ref(q, k, v):
        o = flash_attention_ref(*(x.permute(1, 2, 0, 3) for x in (q, k, v)),
                                causal=False, p_dtype=torch.bfloat16)
        return o.permute(2, 0, 1, 3)
    tt, s, b = 1504, WHISPER_TRAIN["seq"], WHISPER_TRAIN["batch"]
    grads = [_grad_case(torch, f"flash_whisper_train_{name}",
                        lambda q, k, v: flash_attention(q, k, v,
                                                        causal=False),
                        seq_ref, (rnd(sq, b, 6, 64), rnd(tt, b, 6, 64),
                                  rnd(tt, b, 6, 64)), (rnd(sq, b, 6, 64),),
                        flash_variant)
             for name, sq in (("encoder", tt), ("cross", s))]
    return flash, rms, grads


def cross_phase(torch, counters, profile: bool) -> tuple:
    """Phase 20: the counts set to 0 just before 20a-c and read just
    after; every kernel call of 20a-c kept by signature and held against
    its plain version at each one after the counts are read; then 20d.
    Returns the launches by kernel and the kernel cases (B2, B3, the
    backward cases)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    t20 = time.perf_counter()
    _free_card(torch)
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        whisper = whisper_serve_phase(torch, profile)
        record("cross_whisper_serve", seconds=time.perf_counter() - t0,
               **whisper)
        t0 = time.perf_counter()
        vision = vision_serve_phase(torch, profile)
        record("cross_vision_serve", seconds=time.perf_counter() - t0,
               **vision)
        t0 = time.perf_counter()
        trains = [cross_train_run(torch, "whisper-tiny",
                                  get_config("whisper-tiny"),
                                  variant="tc", **WHISPER_TRAIN),
                  cross_train_run(torch, "llama-3.2-vision smoke",
                                  get_smoke("llama-3.2-vision-90b"),
                                  variant="simt", **VISION_SMOKE_TRAIN)]
        record("cross_train", seconds=time.perf_counter() - t0, runs=trains)
        x_launches = {"flash_attention": flash_attention_bhsd.launches,
                      "rmsnorm": rmsnorm.launches}
        by_variant = dict(flash_attention_bhsd.launches_by_variant)
    if min(x_launches.values()) == 0:
        raise AssertionError(f"the vlm and audio paths launched a kernel "
                             f"no time: {x_launches}")
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, path.calls, prefix="cross_path")
    del path
    missing = [k for k in ("flash", "rmsnorm") if not checks[k]]
    if missing or any(checks[k] for k in ("moe_gmm", "ssd_scan",
                                          "doorbell")):
        raise AssertionError(f"phase 20 kept signatures "
                             f"{ {k: len(c) for k, c in checks.items()} }")
    record("phase20_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(c) for k, c in checks.items()}, cases=checks)
    t0 = time.perf_counter()
    flash, rms, grads = cross_kernel_cases(torch)
    record("cross_kernel_cases", seconds=time.perf_counter() - t0,
           flash_attention=flash, rmsnorm=rms, backward=grads)
    smi = _card_line()
    for name, rec in (("whisper-tiny", whisper),
                      ("llama-3.2-vision (10 layers)", vision)):
        print(f"phase 20 {name}: prefill {rec['prefill_ms']:.2f} ms, "
              f"decode {rec['decode_ms_per_step']:.2f} ms a step, peak "
              f"{rec['peak_memory_gb']:.2f} GB ({smi})", flush=True)
    for rec in trains:
        print(f"phase 20 train {rec['config']}: {rec['step_ms']:.1f} ms a "
              f"step, peak {rec['peak_memory_gb']:.2f} GB ({smi})",
              flush=True)
    record("phase20", seconds=time.perf_counter() - t20,
           launches=x_launches, flash_launches_by_variant=by_variant,
           card=smi)
    return x_launches, by_variant, flash + checks["flash"], \
        rms + checks["rmsnorm"], grads


# ---------------------------------------------------------------------------
# phase 21: training at tp > 1
# ---------------------------------------------------------------------------

#: 21a: every Comm method's transpose on P = 2 and on P = 4 rank threads
TPT_P = (2, 4)
#: 21b: gemma3-1b at its full config on a (1, 2) mesh, ``tp_target`` 2
#: (its 4 heads shard, its one kv head does not: 17b's plan): float32,
#: one step on 2 x 1024 tokens; bf16, 3 steps on 4 x 2048
TPT_F32 = (1024, 2)
TPT_BF16 = dict(seq=2048, batch=4, steps=3)
#: 21c: (arch, layers, mesh) in float32 on 2 x 512 tokens: full width, 2
#: layers on (2, 2); whisper-tiny at its full config on (1, 2)
TPT_FAMILIES = (("olmoe-1b-7b", 2, (2, 2)), ("mamba2-370m", 2, (2, 2)),
                ("hymba-1.5b", 2, (2, 2)), ("whisper-tiny", None, (1, 2)))
TPT_SMALL = (512, 2)
#: a float32 tp > 1 step against tp = 1's: the losses within this, every
#: gradient leaf within this share of its largest |g| at tp = 1
TPT_TOL = 1e-3
#: 21d: the launcher on gemma3-1b's smoke config; then a float32
#: checkpoint of it on (2, 2) continued on (4, 1) against on (2, 2)
TPT_LAUNCH = dict(mesh="2x2", steps=4, seq=64, batch=8, elastic_steps=3,
                  elastic_tol=2e-3)


def _tpt_cases(torch, p):
    """21a's cases: (name, mesh axis, fn(comm, *local) -> output,
    in_specs, out_spec, whole inputs, whole cotangent, oracle(*whole) ->
    whole output) at phase 17a's TP-boundary sizes, float32 on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import P
    from repro_torch.models.moe import capacity
    g = torch.Generator().manual_seed(SEED + 21)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    s, b, d, ff = GEMMA_S, GEMMA_B, GEMMA_D, GEMMA_FF
    cap = capacity((1024 // p) * 4, get_config("olmoe-1b-7b"))
    x = normal(s, b, d)
    w_in = normal(d, ff, scale=d ** -0.5)
    h = normal(s, b, ff)
    w_out = normal(ff, d, scale=ff ** -0.5)
    xr = normal(p * s, b, d)              # a different (s, b, d) a rank
    disp = normal(p * OLMOE_E, cap, OLMOE_D)

    def a2a(x):
        parts = torch.chunk(x, p, 0)
        return torch.cat([torch.cat([torch.chunk(parts[src], p, 0)[r]
                                     for src in range(p)], 1)
                          for r in range(p)])

    def total(x):
        return sum(torch.chunk(x, p, 0))
    M, D = "model", "data"
    return [
        ("ag_matmul", M, lambda c, x, w: c.ag_matmul(x, w),
         (P(M), P(None, M)), P(None, None, M), (x, w_in),
         normal(s, b, ff), lambda x, w: x @ w),
        ("matmul_rs", M, lambda c, h, w: c.matmul_rs(h, w),
         (P(None, None, M), P(M)), P(M), (h, w_out), normal(s, b, d),
         lambda h, w: h @ w),
        ("matmul_ar", M, lambda c, h, w: c.matmul_ar(h, w)[None],
         (P(None, None, M), P(M)), P(M), (h, w_out), normal(p, s, b, d),
         lambda h, w: (h @ w)[None].expand(p, s, b, d)),
        ("ag_seq", M, lambda c, x: c.ag_seq(x)[None], (P(M),), P(M), (x,),
         normal(p, s, b, d), lambda x: x[None].expand(p, s, b, d)),
        ("rs_seq", M, lambda c, x: c.rs_seq(x), (P(M),), P(M), (xr,),
         normal(s, b, d), total),
        ("psum_model", M, lambda c, x: c.psum_model(x)[None], (P(M),),
         P(M), (xr,), normal(p, s, b, d),
         lambda x: total(x)[None].expand(p, s, b, d)),
        ("psum_model_ge", M, lambda c, x: c.psum_model_ge(x), (P(M),), P(),
         (xr,), normal(s, b, d), total),
        ("a2a", M, lambda c, x: c.a2a(x, split_axis=0, concat_axis=1),
         (P(M),), P(M), (disp,), normal(OLMOE_E, p * cap, OLMOE_D), a2a),
        ("weight", D, lambda c, w: c.weight(w, fsdp_axis=1)[None],
         (P(None, D),), P(D), (w_in,), normal(p, d, ff),
         lambda w: w[None].expand(p, d, ff)),
    ]


def tp_transpose_phase(torch) -> dict:
    """21a: every Comm method's backward (the transpose the reference's AD
    derives, ``distributed/comm.py``) on P = 2 and P = 4 rank threads of
    ``LocalCluster(P, device="cuda")``, float32 and bf16, LCI_DEDICATED,
    at phase 17a's TP-boundary sizes (gemma3-1b's 2048 x 4 x 1152 rows,
    its 6912-wide MLP, olmoe-1b-7b's dispatch): each rank's forward and
    backward through the tape (``spmd_autograd.Tape``: the transposes on
    the rank thread) against autograd of the plain single-rank oracle on
    the whole float32 tensors (float32 within 1e-4 of the largest |ref|,
    bf16 within :func:`_bf16_tol`); no payload byte through the host,
    the host syncs of each call counted; wall ms of a call (forward and
    backward, median of 3)."""
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.core.transport.wire import to_card, to_host
    from repro_torch.distributed import Mesh, spmd_map
    from repro_torch.distributed.spmd_autograd import Tape
    from repro_torch.kernels.doorbell import stage_copy_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    config = CommConfig(mode=CommMode.LCI_DEDICATED)

    def rank(fn):
        def run(comm, ct, *xs):
            xs = [x.detach().clone().requires_grad_() for x in xs]
            tape = Tape()
            with tape.recording():
                y = fn(comm, *xs)
            tape.backward([y], [ct])
            return (y.detach(),) + tuple(x.grad for x in xs)
        return run

    out = []
    host0 = (to_host.copies, to_card.copies)
    b1_0 = stage_copy_rows.launches
    for p in TPT_P:
        with Mesh((1, p), ("data", "model"), device=DEVICE) as mm, \
                Mesh((p, 1), ("data", "model"), device=DEVICE) as dm:
            for name, axis, fn, specs, ospec, args, ct, oracle in \
                    _tpt_cases(torch, p):
                f = spmd_map(rank(fn), dm if axis == "data" else mm,
                             (ospec,) + specs, (ospec,) + specs,
                             config=config)
                for dt in (torch.float32, torch.bfloat16):
                    dargs = [a.to(DEVICE, dt) for a in args]
                    dct = ct.to(DEVICE, dt)
                    xs = [a.detach().float().clone().requires_grad_()
                          for a in dargs]
                    want_y = oracle(*xs)
                    want = torch.autograd.grad(want_y, xs, dct.float())
                    torch.cuda.synchronize()
                    with _SyncCount(torch) as syncs:
                        got = f(dct, *dargs)
                    torch.cuda.synchronize()
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        f(dct, *dargs)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    errs = []
                    for label, a, w in [("y", got[0], want_y.detach())] + [
                            (f"d{i}", g_, w_) for i, (g_, w_) in
                            enumerate(zip(got[1:], want))]:
                        err = float((a.float() - w).abs().max())
                        tol = (1e-4 * float(w.abs().max())
                               if dt == torch.float32 else _bf16_tol(w, p))
                        if not err <= tol:
                            raise AssertionError(
                                f"21a {name} P={p} {dt} {label}: |err| "
                                f"{err} > {tol}")
                        errs.append({"of": label, "max_abs_err": err,
                                     "tol": tol})
                    out.append({"case": name, "ranks": p,
                                "dtype": str(dt).split(".")[1],
                                "mode": config.mode.value,
                                "shape": [list(a.shape) for a in args],
                                "ms": statistics.median(times) * 1e3,
                                "host_syncs": syncs.calls,
                                "host_sync_sites": syncs.where,
                                "errors": errs})
                    del dargs, dct, xs, want_y, want, got
            torch.cuda.empty_cache()
    host = (to_host.copies - host0[0], to_card.copies - host0[1])
    if host != (0, 0):
        raise AssertionError(f"21a: payload bytes crossed the host "
                             f"(to_host, to_card copies {host})")
    return {"cases": out, "host_copies": list(host),
            "b1_launches": stage_copy_rows.launches - b1_0}


def _thread_launches() -> list:
    """B2's and B3's launches by thread so far."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.rmsnorm import rmsnorm
    return [dict(f.launches_by_thread) for f in (flash_attention_bhsd,
                                                 rmsnorm)]


def _rank_thread_gate(label, before, want, ranks) -> dict:
    """B2's and B3's launches on each of the rank threads since
    ``before`` (:func:`_thread_launches`): raises unless each of
    ``ranks`` threads launched exactly ``want`` (B2, B3) and no other
    thread launched any."""
    now = _thread_launches()
    by = [{t: n - b0.get(t, 0) for t, n in f.items() if n != b0.get(t, 0)}
          for f, b0 in zip(now, before)]
    names = [f"spmd-rank{r}" for r in range(ranks)]
    per = {t: (by[0].get(t, 0), by[1].get(t, 0)) for t in names}
    others = sorted((set(by[0]) | set(by[1])) - set(names))
    if any(v != tuple(want) for v in per.values()) or others:
        raise AssertionError(f"{label}: (B2, B3) launches a rank thread "
                             f"{per} (want {tuple(want)}), on threads "
                             f"{others} too")
    return {t: dict(zip(("flash", "rmsnorm"), v)) for t, v in per.items()}


def _tpt_grads(torch, model, specs, params, data, mesh):
    """One step's loss (meaned over the mesh) and ``grad_sync``'d
    gradients, put together, on every rank of ``mesh`` (the step's
    Comm, the rank thread's tape), LCI_DEDICATED; its wall ms (the cut of
    the params and the gather of the gradients included)."""
    import dataclasses
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.distributed import P, spmd_map
    from repro_torch.launch.mesh import batch_pspecs
    from repro_torch.optim import grad_sync
    from repro_torch.train import loss_and_grads
    pspecs = _tp_specs(specs)
    bspec = batch_pspecs(model.cfg, "train", mesh,
                         batch=data["tokens"].shape[1])

    def rank(comm, p, b):
        comm = dataclasses.replace(comm, fsdp=model.cfg.fsdp_params)
        loss, _, g = loss_and_grads(model, p, b, comm)
        return comm.pmean_all(loss), grad_sync(g, specs, comm)

    f = spmd_map(rank, mesh, (pspecs, bspec), (P(), pspecs),
                 config=CommConfig(mode=CommMode.LCI_DEDICATED))
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = f(params, data)
    torch.cuda.synchronize()
    return float(loss), grads, (time.perf_counter() - t) * 1e3


def _leaf_shares(got, want) -> dict:
    """Each leaf's largest distance from ``want``'s, as a share of
    ``want``'s largest |g|."""
    from repro_torch.core.tree import leaves_with_paths
    w_of = dict(leaves_with_paths(want))
    out = {}
    for path, g in leaves_with_paths(got):
        w = w_of[path].float()
        out[path] = float((g.float() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
    return out


def _leaf_rel_norms(got, want) -> dict:
    """Each leaf's ‖got - want‖ / ‖want‖ (float32)."""
    from repro_torch.core.tree import leaves_with_paths
    w_of = dict(leaves_with_paths(want))
    out = {}
    for path, g in leaves_with_paths(got):
        w = w_of[path].float()
        out[path] = float((g.float() - w).norm() / w.norm().clamp_min(
            1e-30))
    return out


def _worst(shares: dict) -> list:
    path = max(shares, key=shares.get)
    return [path, shares[path]]


def _shard_check(state, specs, whole: dict, mesh) -> dict:
    """Raises unless every rank's params, master, mu and nu leaf holds
    exactly its ``ParamSpec`` shard of the ``whole`` leaf's elements (by
    path); returns the bytes each rank holds and the whole state's."""
    from repro_torch.core.tree import leaves_with_paths
    spec_of = dict(leaves_with_paths(specs))

    def ways(spec):
        n = 1
        for entry in spec.pspec():
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= mesh.shape[mesh.names.index(a)]
        return n

    per_rank, whole_bytes = [], 0
    for r, st in enumerate(state.ranks):
        held = 0
        for tree in (st.params, st.opt.master, st.opt.mu, st.opt.nu):
            for path, t in leaves_with_paths(tree):
                held += t.numel() * t.element_size()
                if r == 0:
                    whole_bytes += whole[path] * t.element_size()
                if t.numel() * ways(spec_of[path]) != whole[path]:
                    raise AssertionError(
                        f"rank {r} holds {path} at {tuple(t.shape)}, not "
                        f"its shard of {whole[path]} elements")
        per_rank.append(held)
    return {"bytes_per_rank": per_rank, "whole_state_bytes": whole_bytes}


def tp_train_gemma_phase(torch) -> dict:
    """21b: gemma3-1b at its full config (26 layers, d 1152, vocab
    262144, ``tp_target`` 2) on a (1, 2) mesh of rank threads, remat on:
    a) float32 (TF32 off), 2 x 1024 tokens: one step's loss and every
    ``grad_sync``'d gradient leaf against tp = 1's on the same params
    within :data:`TPT_TOL`; b) bf16, 4 x 2048 tokens: the first step's
    gradients no further from the float32 tp = 1 gradients (the bf16
    weights cast up) than twice the bf16 tp = 1 step's distance, leaf by
    leaf, norm-wise (17b's and 20's witness rule); then 3 launcher steps
    (``mesh_step`` on the state cut over the mesh: each rank holds only
    its shard of params, master, mu and nu) on one fixed batch, the
    losses finite and strictly falling.  Each step's B2 and B3 launches
    a rank thread are exactly the forward's and the rank thread's remat
    recompute's (52 and 209), on no other thread, every bf16 B2 launch
    tensor-core; step ms, tokens/s, peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh, local_comm
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch.train import mesh_step, shard_state
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainState, loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_config("gemma3-1b"), tp_target=2)
    want = _train_want("gemma3-1b")[:2]          # (52, 209) a step
    out = {"config": base.name, "mesh": [1, 2], "tp_target": 2,
           "mode": "lci_dedicated", "remat": True}
    _free_card(torch)
    with Mesh((1, 2), ("data", "model"), device=DEVICE) as mesh:
        # a) float32, one step against tp = 1
        cfg = dataclasses.replace(base, dtype=torch.float32)
        model = build_model(cfg, device=DEVICE)
        params, specs = model.init(SEED)
        s, b = TPT_F32
        data = SyntheticPipeline(vocab=cfg.vocab, seq_len=s,
                                 global_batch=b).get_batch(0, device=DEVICE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss1, _, g1 = loss_and_grads(model, params, data, local_comm())
        loss1 = float(loss1)
        ms1 = (time.perf_counter() - t) * 1e3
        before = _thread_launches()
        loss2, g2, ms2 = _tpt_grads(torch, model, specs, params, data, mesh)
        launches = _rank_thread_gate("21b float32", before, want, 2)
        shares = _leaf_shares(g2, g1)
        worst = _worst(shares)
        if not (abs(loss2 - loss1) <= TPT_TOL and worst[1] <= TPT_TOL):
            raise AssertionError(f"21b float32 tp = 2: loss {loss2} (tp = 1 "
                                 f"{loss1}), worst leaf {worst} (limit "
                                 f"{TPT_TOL})")
        out["float32"] = {"seq": s, "batch": b, "loss_tp1": loss1,
                          "loss_tp2": loss2, "worst_leaf_share": worst,
                          "leaf_shares": shares, "step_ms_tp1": ms1,
                          "step_ms_tp2": ms2,
                          "launches_per_rank_thread": launches}
        del model, params, g1, g2
        _free_card(torch)

        # b) bf16: the witness rule, then 3 steps
        model = build_model(base, device=DEVICE)
        params, specs = model.init(SEED)
        s, b = TPT_BF16["seq"], TPT_BF16["batch"]
        data = SyntheticPipeline(vocab=base.vocab, seq_len=s,
                                 global_batch=b).get_batch(0, device=DEVICE)
        _, _, g32 = loss_and_grads(build_model(cfg, device=DEVICE),
                                   _float_tree(params), data, local_comm())
        _free_card(torch)
        _, _, g16 = loss_and_grads(model, params, data, local_comm())
        e1 = _leaf_rel_norms(g16, g32)
        del g16
        flash0 = (flash_attention_bhsd.launches,
                  flash_attention_bhsd.launches_by_variant["tc"])
        before = _thread_launches()
        loss_g, g2, ms_g = _tpt_grads(torch, model, specs, params, data,
                                      mesh)
        _rank_thread_gate("21b bf16 gradients", before, want, 2)
        e2 = _leaf_rel_norms(g2, g32)
        del g2, g32
        _free_card(torch)
        over = {k: (e2[k], e1[k]) for k in e2 if not e2[k] <= 2 * e1[k]}
        if over:
            raise AssertionError(f"21b bf16 tp = 2 gradients further from "
                                 f"float32 than twice tp = 1's bf16 "
                                 f"distance: {over}")
        whole = {p: t.numel() for p, t in leaves_with_paths(params)}
        opt = AdamWConfig(lr=TRAIN_LR)
        torch.cuda.reset_peak_memory_stats()
        state = shard_state(TrainState(params, adamw_init(params, opt)),
                            specs, mesh)
        del params
        _free_card(torch)
        held = _shard_check(state, specs, whole, mesh)
        step = mesh_step(model, specs, opt, mesh,
                         CommConfig(mode=CommMode.LCI_DEDICATED), batch=b)
        losses, times, per_step = [], [], []
        for i in range(TPT_BF16["steps"]):
            before = _thread_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, data)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_step.append(_rank_thread_gate(f"21b bf16 step {i}", before,
                                              want, 2))
        n_flash = flash_attention_bhsd.launches - flash0[0]
        n_tc = flash_attention_bhsd.launches_by_variant["tc"] - flash0[1]
        if n_tc != n_flash:
            raise AssertionError(f"21b bf16: {n_flash - n_tc} of {n_flash} "
                                 "flash-attention launches not tensor-core")
        if not all(math.isfinite(x) for x in losses) or \
                not all(b_ < a_ for a_, b_ in zip(losses, losses[1:])):
            raise AssertionError(f"21b bf16 tp = 2 losses {losses} are not "
                                 "finite and falling")
        step_s = statistics.median(times[1:])
        out["bfloat16"] = {
            "seq": s, "batch": b, "first_step_loss": loss_g,
            "first_step_grads_ms": ms_g,
            "witness": {"rule": "per leaf |g - g32| / |g32| at tp = 2 "
                                "<= 2 x tp = 1's (bf16 against float32 "
                                "tp = 1)",
                        "worst_ratio": max(e2[k] / max(e1[k], 1e-30)
                                           for k in e2),
                        "tp2": e2, "tp1": e1},
            "losses": losses, "step_ms": step_s * 1e3,
            "step_ms_all": [x * 1e3 for x in times],
            "tokens_per_s": s * b / step_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state": held, "launches_per_rank_thread_per_step": per_step,
            "flash_launches_tc": n_tc}
        del state
    _free_card(torch)
    return out


def tp_train_families_phase(torch) -> dict:
    """21c: olmoe-1b-7b (the all-to-all's backward, B4), mamba2-370m (the
    ``psum_model`` backward, B5) and hymba-1.5b (Plan B attention and the
    replicated SSM) at full width and 2 layers on a (2, 2) mesh (FSDP
    over data and tp 2, four rank threads), whisper-tiny at its full
    config on (1, 2); float32 (TF32 off), 2 x 512 tokens (whisper: the
    launcher's 1504 stub frames): one step's loss and every synced
    gradient leaf against tp = 1's on the same params within
    :data:`TPT_TOL`.  olmoe runs at the capacity factor E / k, where no
    expert overflows at either width, and with its router's load-balance
    coefficient at 0: at tp > 1 the reference's ``aux_lb`` is the mean
    over the ranks of each rank's term over its own tokens, another
    function than tp = 1's over all tokens (``tests/test_torch_tp.py``
    holds it to the reference's); its z-loss stays.  whisper's stacked
    matrices are rescaled to std 1/sqrt(fan_in) (:func:`_fan_in_scaled_`,
    as phase 20a): at the init's scale its float32 gradients are chaotic,
    tp = 1's as far from float64 as tp = 2's (both ~1.2 of a leaf's
    largest element at 64 x 2 tokens on the CPU; ~1e-6 when rescaled).
    Step ms and peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh, local_comm
    from repro_torch.launch.train import batch_extras
    from repro_torch.models.registry import build_model
    from repro_torch.train import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    s, b = TPT_SMALL
    for arch, layers, shape in TPT_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        if cfg.family == "moe":
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k,
                router_aux_coef=0.0)
        _free_card(torch)
        model = build_model(cfg, device=DEVICE)
        params, specs = model.init(SEED)
        if cfg.is_encdec:
            _fan_in_scaled_(params)
        data = SyntheticPipeline(vocab=cfg.vocab, seq_len=s,
                                 global_batch=b).get_batch(0, device=DEVICE)
        data.update(batch_extras(cfg, b, 0, DEVICE))
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss1, _, g1 = loss_and_grads(model, params, data, local_comm())
        loss1 = float(loss1)
        ms1 = (time.perf_counter() - t) * 1e3
        torch.cuda.reset_peak_memory_stats()
        c0 = _counts()
        with Mesh(shape, ("data", "model"), device=DEVICE) as mesh:
            loss2, g2, ms2 = _tpt_grads(torch, model, specs, params, data,
                                        mesh)
        launches = dict(zip(("flash", "rmsnorm", "moe_gmm", "ssd_scan"), (
            b_ - a_ for i, (a_, b_) in enumerate(zip(c0, _counts()))
            if i in (0, 1, 2, 4))))
        shares = _leaf_shares(g2, g1)
        worst = _worst(shares)
        rec = {"layers": cfg.n_layers, "mesh": list(shape), "seq": s,
               "batch": b, "dtype": "float32",
               "extras": {k: list(v.shape) for k, v in data.items()
                          if k not in ("tokens", "labels")},
               "loss_tp1": loss1, "loss_mesh": loss2,
               "worst_leaf_share": worst, "step_ms_tp1": ms1,
               "step_ms_mesh": ms2,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches}
        if cfg.family == "moe":
            rec.update(capacity_factor=cfg.capacity_factor,
                       router_aux_coef=0.0)
        if cfg.is_encdec:
            rec["weights"] = "stacked matrices at std 1/sqrt(fan_in)"
        out[arch] = rec
        need = {"olmoe-1b-7b": ("flash", "rmsnorm", "moe_gmm"),
                "mamba2-370m": ("rmsnorm", "ssd_scan"),
                "hymba-1.5b": ("flash", "rmsnorm", "ssd_scan"),
                "whisper-tiny": ("flash",)}[arch]
        if not (abs(loss2 - loss1) <= TPT_TOL and worst[1] <= TPT_TOL) \
                or any(launches[k] == 0 for k in need):
            raise AssertionError(f"21c {arch} on {shape}: {rec}")
        del model, params, g1, g2
    _free_card(torch)
    return out


def tp_train_launch_phase(torch) -> dict:
    """21d: ``python -m repro_torch.launch.train --arch gemma3-1b --smoke
    --mesh 2x2 --steps 4`` (its ``main``, on the card): losses finite
    and the last below the first.  Then the smoke config in float32 (the
    reference's ``elastic_reshard.py`` case): 3 ``mesh_step`` steps on
    (2, 2), a checkpoint of the state put together, its restore cut onto
    (4, 1) and continued 3 steps, against the same restore continued on
    (2, 2): the last losses within 2e-3."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_smoke
    from repro_torch.core.modes import CommConfig, CommMode
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh
    from repro_torch.launch import train as launcher
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import state_from_tree, state_tree, \
        train_state_init
    t = time.perf_counter()
    hist = launcher.main(["--arch", "gemma3-1b", "--smoke", "--mesh",
                          TPT_LAUNCH["mesh"], "--steps",
                          str(TPT_LAUNCH["steps"]), "--seq",
                          str(TPT_LAUNCH["seq"]), "--batch",
                          str(TPT_LAUNCH["batch"])])
    launch_s = time.perf_counter() - t
    losses = [r["loss"] for r in hist]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"21d launcher losses {losses} are not finite "
                             "and falling")
    cfg = dataclasses.replace(get_smoke("gemma3-1b"), dtype=torch.float32)
    model = build_model(cfg, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN_LR)
    state, specs = train_state_init(model, SEED, opt)
    pipe = SyntheticPipeline(vocab=cfg.vocab, seq_len=TPT_LAUNCH["seq"],
                             global_batch=TPT_LAUNCH["batch"])
    n = TPT_LAUNCH["elastic_steps"]
    config = CommConfig(mode=CommMode.LCI_DEDICATED)
    tmp = tempfile.mkdtemp(prefix="phase21_ckpt_",
                           dir=os.path.join(ROOT, "build"))
    try:
        with Mesh((2, 2), ("data", "model"), device=DEVICE) as mesh_a, \
                Mesh((4, 1), ("data", "model"), device=DEVICE) as mesh_b:
            step_a = launcher.mesh_step(model, specs, opt, mesh_a, config,
                                        batch=TPT_LAUNCH["batch"])
            step_b = launcher.mesh_step(model, specs, opt, mesh_b, config,
                                        batch=TPT_LAUNCH["batch"])
            st = launcher.shard_state(state, specs, mesh_a)
            for i in range(n):
                st, m = step_a(st, pipe.get_batch(i, device=DEVICE))
            store = CheckpointStore(tmp)
            store.save(n - 1, state_tree(st), meta={"next_step": n},
                       blocking=True)

            def continued(like, step_fn):
                tree, manifest = store.restore(state_tree(like),
                                               device=DEVICE)
                cur = like.resharded(state_from_tree(tree))
                for i in range(manifest["meta"]["next_step"], 2 * n):
                    cur, m = step_fn(cur, pipe.get_batch(i, device=DEVICE))
                return float(m["loss"])

            loss_b = continued(launcher.shard_state(st.gather(), specs,
                                                    mesh_b), step_b)
            loss_a = continued(st, step_a)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (math.isfinite(loss_b) and
            abs(loss_a - loss_b) < TPT_LAUNCH["elastic_tol"]):
        raise AssertionError(f"21d elastic: continued on (4, 1) {loss_b}, "
                             f"on (2, 2) {loss_a}")
    return {"launcher": {"argv": f"--arch gemma3-1b --smoke --mesh "
                                 f"{TPT_LAUNCH['mesh']} --steps "
                                 f"{TPT_LAUNCH['steps']}",
                         "seq": TPT_LAUNCH["seq"],
                         "batch": TPT_LAUNCH["batch"], "losses": losses,
                         "seconds": launch_s},
            "elastic": {"config": cfg.name, "dtype": "float32",
                        "from": [2, 2], "to": [4, 1], "steps": [n, n],
                        "loss_continued_4x1": loss_b,
                        "loss_continued_2x2": loss_a,
                        "abs_diff": abs(loss_a - loss_b),
                        "limit": TPT_LAUNCH["elastic_tol"]}}


def tp_training_phase(torch, counters) -> tuple:
    """Phase 21: the counts set to 0 just before 21a and again before
    21b, read just after 21a and 21d; every kernel call of 21b-d kept by
    signature and each kernel held against its plain version at each one
    after the counts are read.  Returns the launches of 21a-d by kernel
    and the path checks by kernel."""
    from repro_torch.kernels.doorbell import stage_copy_rows
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.kernels.ssm_conv import ssm_conv
    t21 = time.perf_counter()
    _free_card(torch)
    _zero_counts(counters)
    t0 = time.perf_counter()
    transposes = tp_transpose_phase(torch)
    a_doorbell = stage_copy_rows.launches
    record("tp_train_transposes", seconds=time.perf_counter() - t0,
           **transposes)
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        gemma = tp_train_gemma_phase(torch)
        record("tp_train_gemma3", seconds=time.perf_counter() - t0,
               **gemma)
        t0 = time.perf_counter()
        families = tp_train_families_phase(torch)
        record("tp_train_families", seconds=time.perf_counter() - t0,
               **families)
        t0 = time.perf_counter()
        launch = tp_train_launch_phase(torch)
        record("tp_train_launcher", seconds=time.perf_counter() - t0,
               **launch)
        launches = {"flash_attention": flash_attention_bhsd.launches,
                    "rmsnorm": rmsnorm.launches,
                    "moe_gmm": moe_gmm.launches,
                    "ssd_scan": ssd_scan_bhsp.launches,
                    "ssm_conv": ssm_conv.launches,
                    "doorbell": a_doorbell + stage_copy_rows.launches}
        by_variant = {
            "flash_attention": dict(flash_attention_bhsd.launches_by_variant),
            "moe_gmm": dict(moe_gmm.launches_by_variant),
            "ssd_scan": dict(ssd_scan_bhsp.launches_by_variant)}
    if min(launches[k] for k in ("flash_attention", "rmsnorm", "moe_gmm",
                                 "ssd_scan")) == 0:
        raise AssertionError(f"the tp > 1 training path launched a kernel "
                             f"no time: {launches}")
    _free_card(torch)
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, path.calls, prefix="tp_train_path",
                                b4_scaled=True)
    del path
    missing = [k for k, n_ in (("flash", launches["flash_attention"]),
                               ("rmsnorm", launches["rmsnorm"]),
                               ("moe_gmm", launches["moe_gmm"]),
                               ("ssd_scan", launches["ssd_scan"]),
                               ("ssm_conv", launches["ssm_conv"]),
                               ("doorbell", launches["doorbell"]
                                - a_doorbell))
               if n_ and not checks[k]]
    if missing:
        raise AssertionError(f"phase 21 launched {missing} at no signature "
                             "that was kept")
    record("phase21_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(v) for k, v in checks.items()}, cases=checks)
    smi = _card_line()
    bf = gemma["bfloat16"]
    print(f"phase 21 gemma3-1b tp = 2 bf16 {TPT_BF16['batch']} x "
          f"{TPT_BF16['seq']}: {bf['step_ms']:.1f} ms a step, "
          f"{bf['tokens_per_s']:.0f} tokens/s, peak "
          f"{bf['peak_memory_gb']:.2f} GB ({smi})", flush=True)
    for arch, rec in families.items():
        print(f"phase 21 {arch} on {tuple(rec['mesh'])} float32: "
              f"{rec['step_ms_mesh']:.1f} ms a step (tp = 1: "
              f"{rec['step_ms_tp1']:.1f}), peak {rec['peak_memory_gb']:.2f}"
              f" GB ({smi})", flush=True)
    record("phase21", seconds=time.perf_counter() - t21, launches=launches,
           launches_by_variant=by_variant, card=smi)
    return launches, checks


# ---------------------------------------------------------------------------
# phase 22: the analysis tools (launch/costs.py, launch/dryrun.py) and the
# examples against the card
# ---------------------------------------------------------------------------

#: 22a: (arch, step, seq, batch) of each dry-run cell held against the card:
#: 19b's gemma3-1b step, phase 7's prefill, B4's and B5's formulas
DRYRUN_CELLS = (("gemma3-1b", "train", 2048, 4),
                ("gemma3-1b", "prefill", 2048, 4),
                ("olmoe-1b-7b", "prefill", 1024, 4),
                ("mamba2-370m", "prefill", 2048, 4))
#: 22a: the predicted peak's largest distance from the card's, a share
PEAK_BAND = 0.15
#: 22c: the seconds ``dryrun --all`` may take on both meshes
DRYRUN_ALL_S = 300.0
#: 22d: each example, its arguments and the line it must print last; the
#: ~100M-param model trains for 60 of its default 300 steps
EXAMPLE_TRAIN_STEPS = 60
EXAMPLES = (("torch_quickstart.py", (), "quickstart OK"),
            ("torch_kmer_counting.py", (), "kmer example OK"),
            ("torch_serve_demo.py", (), "serve demo OK"),
            ("torch_train_100m.py", ("--steps", str(EXAMPLE_TRAIN_STEPS)),
             "train_100m OK"))
_COST_KEYS = ("flops", "dot_bytes")
_DIRS = ("ppermute_fwd_bytes", "ppermute_bwd_bytes", "ppermute_fwd_steps",
         "ppermute_bwd_steps")


def _kernel_launches() -> dict:
    """Each kernel's wrapper launch count, under the costs' names."""
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_push,
                                              stage_copy_rows)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.kernels.ssm_conv import ssm_conv
    return {"flash_attention": flash_attention_bhsd.launches,
            "rmsnorm": rmsnorm.launches, "moe_gmm": moe_gmm.launches,
            "ssd_scan": ssd_scan_bhsp.launches,
            "ssm_conv": ssm_conv.launches,
            "stage_copy": stage_copy.launches,
            "stage_copy_rows": stage_copy_rows.launches,
            "stage_copy_push": stage_copy_push.launches}


def dryrun_card_case(torch, arch: str, kind: str, seq: int, batch: int,
                     smi: str) -> dict:
    """22a: one cell traced on the meta device, then run on the card
    (weights drawn from :data:`SEED`): a warm-up call, the call under
    ``count_costs`` (peak memory from a reset), then timed calls without
    the counter.  Gates: the counts equal, the argument bytes equal, the
    predicted peak within :data:`PEAK_BAND` of the counted call's."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import CostCounter
    label = f"{arch} {kind} {batch} x {seq}"
    shape = Shape(f"{kind}_{seq}x{batch}", kind, seq, batch)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    fn, args = dryrun.local_cell(arch, shape, device="meta")
    meta = dryrun.trace_cell(fn, args)
    trace_s = time.perf_counter() - t0
    want = meta["costs"]
    predicted = meta["argument_size_in_bytes"] + meta["temp_size_in_bytes"]
    del fn, args
    _free_card(torch)
    fn, args = dryrun.local_cell(arch, shape, device=DEVICE, seed=SEED)
    arg_bytes = dryrun.storage_bytes(args)
    out = fn(*args)                        # warm-up: the workspaces
    del out
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    before = _kernel_launches()
    with CostCounter() as counter:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    launched = {k: v - before[k] for k, v in _kernel_launches().items()
                if v != before[k]}
    del out
    got = counter.costs
    bad = [k for k in _COST_KEYS if getattr(got, k) != getattr(want, k)]
    if bad or got.kernels != want.kernels:
        raise AssertionError(
            f"22a {label}: the card's counts {[getattr(got, k) for k in bad]}"
            f" {got.kernels} differ from the dry run's "
            f"{[getattr(want, k) for k in bad]} {want.kernels}")
    if launched != {k: int(v["launches"]) for k, v in got.kernels.items()}:
        raise AssertionError(f"22a {label}: the wrappers launched {launched},"
                             f" the counter recorded {got.kernels}")
    if arg_bytes != meta["argument_size_in_bytes"]:
        raise AssertionError(f"22a {label}: the state holds {arg_bytes} "
                             f"bytes, the dry run predicted "
                             f"{meta['argument_size_in_bytes']}")
    ratio = predicted / peak
    if abs(ratio - 1) > PEAK_BAND:
        raise AssertionError(f"22a {label}: predicted peak {predicted} "
                             f"bytes, {ratio:.4f} of the card's {peak}")
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 if kind == "train" else 3):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        del out
    plain_peak = torch.cuda.max_memory_allocated() - resident
    ms = statistics.median(times) * 1e3
    roof = dryrun.roofline(got, cfg, shape, 1)
    mf = model_flops(cfg, seq, batch)["total"]
    if kind != "train":
        mf /= 3                            # a forward: a third of a step
    rec = {"case": label, "arch": arch, "kind": kind, "seq": seq,
           "batch": batch, "trace_s": trace_s, "flops": got.flops,
           "dot_bytes": got.dot_bytes, "kernels": got.kernels,
           "launches": launched, "argument_bytes": arg_bytes,
           "predicted_peak_bytes": predicted,
           "predicted_temp_bytes": predicted - arg_bytes,
           "peak_bytes_counted_call": peak, "peak_ratio": ratio,
           "peak_bytes_plain_call": plain_peak,
           "peak_ratio_plain_call": predicted / plain_peak,
           "ms": ms, "bound_ms": roof["bound_s"] * 1e3,
           "bound_by": roof["dominant"],
           "bound_over_measured": roof["bound_s"] * 1e3 / ms,
           "model_flops": mf, "counted_over_model_flops": got.flops / mf,
           "card": smi}
    print(f"phase 22a {label}: counts equal ({got.flops:.6g} FLOPs, "
          f"{got.dot_bytes:.6g} dot bytes), peak predicted "
          f"{predicted / 1e9:.3f} GB = {ratio:.4f} of the counted call's "
          f"{peak / 1e9:.3f} GB ({predicted / plain_peak:.4f} of a plain "
          f"call's {plain_peak / 1e9:.3f}), {ms:.2f} ms, bound "
          f"{roof['bound_s'] * 1e3:.2f} ms ({roof['dominant']}, "
          f"{rec['bound_over_measured']:.3f} of it), counted / model_flops "
          f"{rec['counted_over_model_flops']:.4f} ({smi})", flush=True)
    del fn, args
    _free_card(torch)
    return rec


def collectives_card_case(torch, smi: str) -> dict:
    """22b: one gemma3-1b bf16 step (21b's: ``tp_target`` 2, 4 x 2048,
    remat) on (1, 2) rank threads, each rank's step under
    ``count_costs``: every rank's recorded collectives equal the dry
    run's rank 0 on an abstract (1, 2) mesh."""
    import dataclasses
    from repro_torch.configs import Shape, get_config
    from repro_torch.core.modes import CommConfig
    from repro_torch.data import SyntheticPipeline
    from repro_torch.distributed import Mesh, spmd_map
    from repro_torch.distributed.spmd_map import PER_RANK, P
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import count_costs
    from repro_torch.launch.mesh import batch_pspecs
    from repro_torch.launch.train import shard_state
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state_init
    cfg = dataclasses.replace(get_config("gemma3-1b"), tp_target=2)
    seq, batch = TPT_BF16["seq"], TPT_BF16["batch"]
    config = CommConfig()
    t0 = time.perf_counter()
    fn, args = dryrun.build_cell(cfg, Shape("train", "train", seq, batch),
                                 dryrun.AbstractMesh((1, 2), ("data",
                                                              "model")),
                                 config.mode)
    want = dryrun.trace_cell(fn, args)["costs"].as_dict()
    trace_s = time.perf_counter() - t0
    del fn, args
    _free_card(torch)
    model = build_model(cfg, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN_LR)
    data = SyntheticPipeline(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch).get_batch(0, device=DEVICE)
    with Mesh((1, 2), ("data", "model"), device=DEVICE) as mesh:
        state, specs = train_state_init(model, SEED, opt)
        sharded = shard_state(state, specs, mesh)
        del state
        _free_card(torch)

        def rank_step(comm, st, b):
            comm = dataclasses.replace(comm, fsdp=cfg.fsdp_params)
            step = make_train_step(model, specs, opt, comm)
            (st, metrics), c = count_costs(step, st, b)
            return float(metrics["loss"]), c.as_dict()
        run = spmd_map(rank_step, mesh, in_specs=(
            PER_RANK, batch_pspecs(cfg, "train", mesh, batch=batch)),
            out_specs=(P(), PER_RANK), config=config)
        t0 = time.perf_counter()
        loss, per_rank = run(sharded.ranks, data)
        step_s = time.perf_counter() - t0
        del sharded
    keys = ("coll_bytes_by_kind",) + _DIRS
    for r, got in enumerate(per_rank):
        if {k: got[k] for k in keys} != {k: want[k] for k in keys}:
            raise AssertionError(
                f"22b rank {r}: the card's collectives "
                f"{ {k: got[k] for k in keys} } differ from the dry run's "
                f"{ {k: want[k] for k in keys} }")
    if not math.isfinite(loss):
        raise AssertionError(f"22b: loss {loss}")
    _free_card(torch)
    print(f"phase 22b gemma3-1b tp = 2 bf16 {batch} x {seq}: both ranks' "
          f"collectives equal the dry run's "
          f"({want['coll_bytes_total']:.6g} bytes a rank, "
          f"{want['ppermute_fwd_steps']:.0f} + "
          f"{want['ppermute_bwd_steps']:.0f} ppermute steps), step "
          f"{step_s * 1e3:.1f} ms under the counter ({smi})", flush=True)
    return {"config": cfg.name, "mesh": [1, 2], "seq": seq, "batch": batch,
            "mode": config.mode.value, "dryrun_trace_s": trace_s,
            "loss": loss, "step_ms_counted": step_s * 1e3,
            "collectives": {k: want[k] for k in keys},
            "ranks_equal": len(per_rank), "card": smi}


def dryrun_all_case(smi: str) -> dict:
    """22c: ``python -m repro_torch.launch.dryrun --all --mesh both`` in a
    subprocess on the card's host (one worker a core, up to 8), writing
    to ``build/dryrun_torch_chip``: 33 cells ok and 7 skipped on each
    production mesh, every ok cell with FLOPs, no unknown loop and every
    roofline key, in under :data:`DRYRUN_ALL_S` seconds."""
    import shutil
    out = os.path.join(ROOT, "build", "dryrun_torch_chip")
    shutil.rmtree(out, ignore_errors=True)
    jobs = min(8, os.cpu_count() or 1)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--mesh", "both", "--force", "--jobs",
                        str(jobs), "--out", out], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=2 * DRYRUN_ALL_S)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"22c: dryrun --all exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    roof_keys = ("compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "bsp_bound_s", "lci_bound_s", "overlap_speedup",
                 "model_flops_per_device", "useful_flop_ratio",
                 "roofline_fraction")
    by_mesh, trace = {}, {}
    for name in sorted(os.listdir(out)):
        art = json.load(open(os.path.join(out, name)))
        mesh = art["cell"].split("__")[2]
        st = by_mesh.setdefault(mesh, {"ok": 0, "skipped": 0})
        st[art["status"]] = st.get(art["status"], 0) + 1
        if art["status"] != "ok":
            continue
        a = art["analytic"]
        if not (a["flops"] > 0 and a["unknown_while"] == 0 and
                all(k in art["roofline"] for k in roof_keys)):
            raise AssertionError(f"22c: {art['cell']} lacks flops or a "
                                 "roofline key, or left a loop unknown")
        trace[art["cell"]] = art["trace_s"]
    want = {"ok": 33, "skipped": 7}
    if by_mesh != {"single": want, "multi": want}:
        raise AssertionError(f"22c: cells by mesh {by_mesh}, want {want} "
                             "on each")
    if seconds > DRYRUN_ALL_S:
        raise AssertionError(f"22c: dryrun --all took {seconds:.1f} s (limit"
                             f" {DRYRUN_ALL_S:.0f})")
    slowest = sorted(trace.items(), key=lambda kv: -kv[1])[:4]
    print(f"phase 22c dryrun --all on (16, 16) and (2, 16, 16): 33 ok + 7 "
          f"skipped on each in {seconds:.1f} s with {jobs} workers, slowest "
          f"traces {slowest} ({smi})", flush=True)
    return {"seconds": seconds, "jobs": jobs, "cells": by_mesh,
            "trace_s_sum": sum(trace.values()), "slowest": slowest,
            "card": smi}


def _tuplify(x):
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


def _example_calls(torch, keys: dict) -> dict:
    """The signatures an example child kept (JSON), as
    :func:`path_kernel_checks` takes them: B2, B3 and B5 by key; B4 and
    B1 on fresh draws at their shapes (the child's operands stay in the
    child)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    dt = {"torch.float32": torch.float32, "torch.bfloat16": torch.bfloat16}
    calls = {"flash": {}, "rmsnorm": {}, "moe_gmm": {}, "ssd_scan": {},
             "ssm_conv": {}, "doorbell": {}}
    for kind, ks in keys.items():
        for k in map(_tuplify, ks):
            if kind == "moe_gmm":
                xs, w1s, w2s, dn, act, no_rows = k
                x, w1, w2 = (torch.randn(s, generator=g, device=DEVICE,
                                         dtype=dt[dn]) * 0.1
                             for s in (xs, w1s, w2s))
                rows = None if no_rows else torch.full(
                    (xs[0],), xs[1], dtype=torch.int32, device=DEVICE)
                calls[kind][k] = (x, w1, w2, act, rows)
            elif kind == "doorbell":
                n, shape, dn, wire = k
                dtype = getattr(torch, dn.split(".")[1])
                rows = [(torch.randn(shape, generator=g, device=DEVICE)
                         .to(dtype) if dtype.is_floating_point else
                         torch.randint(0, 100, shape, generator=g,
                                       device=DEVICE, dtype=dtype))
                        for _ in range(n)]
                calls[kind][k] = (rows, wire)
            else:
                calls[kind][k] = k
    return calls


def example_child(name: str, report: str, argv) -> int:
    """22d's child: run ``examples/<name>``'s ``main(argv)`` with every
    kernel call kept by signature, then write the signatures and the
    launches to ``report/<name>.json``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "example", os.path.join(ROOT, "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = _kernel_launches()
    with _PathCalls() as path:
        mod.main(list(argv))
    launched = {k: v - before[k] for k, v in _kernel_launches().items()}
    keys = {kind: [list(map(lambda v: list(v) if isinstance(v, tuple)
                            else v, k)) for k in got]
            for kind, got in path.calls.items()}
    with open(os.path.join(report, name + ".json"), "w") as f:
        json.dump({"signatures": keys, "launches": launched}, f)
    return 0


def examples_case(torch, smi: str) -> tuple:
    """22d: each example in a subprocess on the card, its OK line its last
    line; returns the records and the kept signatures."""
    import shutil
    report = os.path.join(ROOT, "build", "examples_chip")
    os.makedirs(report, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    recs, keys = [], {}
    for name, args, ok in EXAMPLES:
        argv = list(args)
        if name == "torch_train_100m.py":
            ckpt = os.path.join(ROOT, "build", "train_100m_chip")
            shutil.rmtree(ckpt, ignore_errors=True)
            argv += ["--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--example", name, "--report", report, "--",
                            *argv], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=900)
        seconds = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines or lines[-1] != ok:
            raise AssertionError(f"22d {name} exited {r.returncode}, last "
                                 f"line {lines[-1:]}:\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-3000:]}")
        got = json.load(open(os.path.join(report, name + ".json")))
        for kind, ks in got["signatures"].items():
            keys.setdefault(kind, []).extend(ks)
        recs.append({"example": name, "args": argv, "seconds": seconds,
                     "ok_line": lines[-1], "launches": got["launches"],
                     "tail": lines[-4:]})
        print(f"phase 22d {name} {' '.join(argv)}: {lines[-1]} in "
              f"{seconds:.1f} s, launches "
              f"{ {k: v for k, v in got['launches'].items() if v} } ({smi})",
              flush=True)
    return recs, keys


def analysis_phase(torch, counters) -> tuple:
    """Phase 22: the counts set to 0 just before 22a and read just after
    22d (the children's launches added); every kernel call of 22a, 22b
    and 22d kept by signature and each kernel held against its plain
    version at each one after the counts are read.  Returns the launches
    by kernel and the path checks by kernel."""
    t22 = time.perf_counter()
    smi = _card_line()
    _free_card(torch)
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        cells = [dryrun_card_case(torch, *c, smi) for c in DRYRUN_CELLS]
        record("dryrun_vs_card", seconds=time.perf_counter() - t0,
               cells=cells)
        t0 = time.perf_counter()
        coll = collectives_card_case(torch, smi)
        record("collectives_vs_dryrun", seconds=time.perf_counter() - t0,
               **coll)
        own = _kernel_launches()
    every = dryrun_all_case(smi)
    record("dryrun_all", **every)
    t0 = time.perf_counter()
    examples, keys = examples_case(torch, smi)
    record("examples", seconds=time.perf_counter() - t0, examples=examples)
    children = {k: sum(e["launches"].get(k, 0) for e in examples)
                for k in own}
    launches = {"flash_attention": own["flash_attention"]
                + children["flash_attention"],
                "rmsnorm": own["rmsnorm"] + children["rmsnorm"],
                "moe_gmm": own["moe_gmm"] + children["moe_gmm"],
                "ssd_scan": own["ssd_scan"] + children["ssd_scan"],
                "ssm_conv": own["ssm_conv"] + children["ssm_conv"],
                "doorbell": own["stage_copy_rows"]
                + children["stage_copy_rows"]}
    if min(launches[k] for k in ("flash_attention", "rmsnorm", "moe_gmm",
                                 "ssd_scan")) == 0:
        raise AssertionError(f"phase 22 launched a kernel no time: "
                             f"{launches}")
    calls = path.calls
    for kind, call in _example_calls(torch, keys).items():
        for k, v in call.items():
            calls[kind].setdefault(k, v)
    _free_card(torch)
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, calls, prefix="analysis_path",
                                b4_scaled=True)
    del path, calls
    missing = [k for k, n in (("flash", launches["flash_attention"]),
                              ("rmsnorm", launches["rmsnorm"]),
                              ("moe_gmm", launches["moe_gmm"]),
                              ("ssd_scan", launches["ssd_scan"]),
                              ("ssm_conv", launches["ssm_conv"]),
                              ("doorbell", launches["doorbell"]))
               if n and not checks[k]]
    if missing:
        raise AssertionError(f"phase 22 launched {missing} at no signature "
                             "that was kept")
    record("phase22_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(v) for k, v in checks.items()}, cases=checks)
    record("phase22", seconds=time.perf_counter() - t22, launches=launches,
           launches_in_children=children, card=smi)
    return launches, checks


# ---------------------------------------------------------------------------
# phase 23: the four configs no earlier phase ran, at full width
# ---------------------------------------------------------------------------

def _config_run(torch, counters, label: str, run):
    """``run()`` with the counts set to 0 just before and read just after,
    every kernel call kept by signature; then (the run's weights freed)
    each kernel held against its plain version at each signature (B4 as
    the training paths hold it: on fresh draws at the path's shapes and
    row counts under phase 8's tolerance, and on the path's own operands
    relative to their scale: the init's 1/sqrt(L) weights put moonshot's
    expert outputs near 2e3, where a float32 sum in another order moves a
    small element past 1e-4).
    Returns (run's record, launches by kernel, B2's and B4's launches by
    variant, the checks)."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    _free_card(torch)
    with _PathCalls() as path:
        _zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = run()
        rec["seconds"] = time.perf_counter() - t0
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        own = _kernel_launches()
        by = {"flash_attention":
              dict(flash_attention_bhsd.launches_by_variant),
              "moe_gmm": dict(moe_gmm.launches_by_variant)}
    calls = path.calls
    del path
    _free_card(torch)
    checks = path_kernel_checks(torch, calls, prefix=label, b4_scaled=True)
    del calls
    launches = {"flash_attention": own["flash_attention"],
                "rmsnorm": own["rmsnorm"], "moe_gmm": own["moe_gmm"],
                "ssd_scan": own["ssd_scan"], "ssm_conv": own["ssm_conv"],
                "doorbell": own["stage_copy_rows"]}
    missing = [k for k, n in (("flash", launches["flash_attention"]),
                              ("rmsnorm", launches["rmsnorm"]),
                              ("moe_gmm", launches["moe_gmm"]))
               if n and not checks[k]]
    if missing:
        raise AssertionError(f"{label} launched {missing} at no signature "
                             "that was kept")
    if launches["ssd_scan"] or launches["ssm_conv"] or launches["doorbell"]:
        raise AssertionError(f"{label} launched the SSD scan, the SSM conv "
                             f"or the gather: {launches}")
    return rec, launches, by, checks


def configs_phase(torch, counters, profile: bool) -> tuple:
    """Phase 23: olmo-1b, minitron-8b, moonshot-v1-16b-a3b and
    command-r-plus-104b at full width, each through phase 6's float32
    gates (decode against forward > 0.95, the prefill token forward's
    last; moonshot at capacity factor E / k, its own 1.25 reported) at
    ``CONFIGS23``'s depth, then phase 7's bf16 prefill and launcher loop
    (launches exact a prefill call and a decode step, every B2 and B4
    launch "tc", none of B2 in decode), each run under
    :func:`_config_run`.  No payload byte crosses to the host
    (``transport/wire.py``'s copies).  Returns the launches by kernel,
    the checks by kernel and B2's and B4's launches by variant."""
    from repro_torch.configs import get_config
    from repro_torch.core.transport.wire import to_card, to_host
    t23 = time.perf_counter()
    smi = _card_line()
    total = dict.fromkeys(("flash_attention", "rmsnorm", "moe_gmm",
                           "ssd_scan", "doorbell"), 0)
    checks = {k: [] for k in ("flash", "rmsnorm", "moe_gmm", "ssd_scan",
                              "doorbell")}
    by_variant = {"flash_attention": {}, "moe_gmm": {}}
    for arch, want in CONFIGS23.items():
        short = arch.split("-")[0]
        host0 = (to_host.copies, to_card.copies)
        parity, l32, _, c32 = _config_run(
            torch, counters, f"p23_{short}_f32",
            lambda: model_parity_phase(torch, arch, want["f32_layers"]))
        _free_card(torch)
        layers = want["bf16_layers"]
        if layers == "fit":
            layers = _fitting_layers(torch, get_config(arch))
        served, l16, by, c16 = _config_run(
            torch, counters, f"p23_{short}_bf16",
            lambda: serving_phase(torch, arch, profile, layers=layers))
        host = (to_host.copies - host0[0], to_card.copies - host0[1])
        if host != (0, 0):
            raise AssertionError(f"{arch}: payload copies (to_host, to_card) "
                                 f"{host} on the path")
        for k in ("flash_attention", "moe_gmm"):
            if by[k]["tc"] != l16[k]:
                raise AssertionError(f"{arch} bf16: {k} launches {by[k]} "
                                     "not all tensor-core")
            by_variant[k][arch] = by[k]
        for k in total:
            total[k] += l32[k] + l16[k]
        for k in checks:
            checks[k] += c32[k] + c16[k]
        full = get_config(arch)
        record("config23", config=arch, card=smi,
               layers={"float32": parity["layers"],
                       "bfloat16": served["layers"],
                       "published": full.n_layers},
               depth_cut=CUTS23.get(arch, "none"),
               width={"d_model": full.d_model, "heads": full.n_heads,
                      "kv_heads": full.n_kv_heads, "d_ff": full.d_ff,
                      "vocab": full.vocab, "experts": full.n_experts},
               float32=parity, bfloat16=served,
               prefill_ms=served["prefill"]["ms"],
               prefill_tokens_per_s=served["prefill"]["tokens_per_s"],
               decode_ms_per_step=served["decode"]["ms_per_step"],
               peak_memory_bytes={"float32": parity["peak_memory_bytes"],
                                  "bfloat16": served["peak_memory_bytes"]},
               launches={"float32": l32, "bfloat16": l16},
               signatures={k: [c["case"] for c in c32[k] + c16[k]]
                           for k in checks if c32[k] or c16[k]})
        del parity, served
    if min(total[k] for k in ("flash_attention", "moe_gmm")) == 0:
        raise AssertionError(f"phase 23 launched a kernel no time: {total}")
    record("phase23", seconds=time.perf_counter() - t23, launches=total,
           launches_by_variant=by_variant, card=smi,
           signatures={k: len(v) for k, v in checks.items()})
    return total, checks, by_variant


def _card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip(
                          ).splitlines()[0].strip()


def _zero_counts(counters):
    """Every launch count to 0, by thread too, B2's and B4's counts by
    variant and B3's by shape."""
    for c in counters:
        c.launches = 0
        c.launches_by_thread = {}
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
                         "call and 8 decode steps to phases 7, 10, 13, "
                         "14 and 23 and to phase 20's whisper-tiny and "
                         "llama-3.2-vision prefill and decode (20a-b), "
                         "and of one training step to phases 19b-c")
    ap.add_argument("--spmd-rank", metavar="DIR",
                    help="run as one rank of phase 15's two-process run "
                         "(the SPMD launcher starts it), reporting to DIR")
    ap.add_argument("--serve-rank", metavar="DIR",
                    help="run as one rank of phase 16's two-process serve "
                         "cell (the SPMD launcher starts it), reporting to "
                         "DIR")
    ap.add_argument("--serve-cell", choices=("traffic", "burst"),
                    default="traffic",
                    help="the two-process serve cell --serve-rank runs")
    ap.add_argument("--example", metavar="NAME",
                    help="run examples/NAME with its kernel calls kept by "
                         "signature (phase 22d starts it), reporting to "
                         "--report; the example's arguments follow --")
    ap.add_argument("--report", metavar="DIR")
    ap.add_argument("example_args", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if args.spmd_rank:
        return spmd_rank(args.spmd_rank)
    if args.serve_rank:
        return serve_rank(args.serve_rank, args.serve_cell)
    if args.example:
        return example_child(args.example, args.report, args.example_args)
    from repro_torch.kernels import _build
    from repro_torch.kernels.doorbell import (stage_copy, stage_copy_push,
                                              stage_copy_rows)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
    from repro_torch.kernels.ssm_conv import ssm_conv
    counters = (stage_copy, stage_copy_rows, stage_copy_push,
                flash_attention_bhsd, rmsnorm, moe_gmm, ssd_scan_bhsp,
                ssm_conv)

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
                             "ssd_scan", "ssm_conv")
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

    # 11b. the SSM conv stage against its plain version
    t0 = time.perf_counter()
    conv = conv_kernel_phase(torch)
    record("ssm_conv_kernel_cases", seconds=time.perf_counter() - t0,
           ssm_conv=conv)

    # 12. mamba2-370m at full width in float32: decode against forward
    t0 = time.perf_counter()
    parity = model_parity_phase(torch, "mamba2-370m")
    record("ssm_model_parity", seconds=time.perf_counter() - t0, **parity)

    # 13. the ssm serving path: counts set to 0 just before, read after
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "mamba2-370m", args.profile)
    s_conv = ssm_conv.launches
    rms_by_shape["mamba2-370m"] = _rms_shapes(served)
    s_rms, s_ssd = rmsnorm.launches, ssd_scan_bhsp.launches
    ssd_by = {"mamba2-370m": _all_tc("ssm serving", ssd_scan_bhsp,
                                     "SSD-scan")}
    record("ssm_serving_main_path", seconds=time.perf_counter() - t0,
           flash_attention_launches=flash_attention_bhsd.launches,
           rmsnorm_launches=s_rms, moe_gmm_launches=moe_gmm.launches,
           ssd_scan_launches=s_ssd,
           ssd_scan_launches_by_variant=ssd_by["mamba2-370m"],
           ssm_conv_launches=s_conv, **served)
    if s_rms == 0 or s_ssd == 0:
        raise AssertionError("the ssm serving path launched no RMSNorm or "
                             "SSD-scan kernel")

    # 14. the hybrid serving path: counts set to 0 just before, read after
    _zero_counts(counters)
    t0 = time.perf_counter()
    served = serving_phase(torch, "hymba-1.5b", args.profile)
    y_conv = ssm_conv.launches
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
           ssd_scan_launches_by_variant=ssd_by["hymba-1.5b"],
           ssm_conv_launches=y_conv, **served)
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

    # 16. serving on the comm core: B1 at the serve plane's shapes against
    # its plain version, then counts set to 0 just before the path, read
    # just after
    gather = serve_gather_cases(torch)
    record("serve_plane_gather", cases=gather,
           max_abs_err=max(c["max_abs_err"] for c in gather))
    cases += gather
    _zero_counts(counters)
    t0 = time.perf_counter()
    serve = serve_phase(torch, card)
    v_launches = stage_copy_rows.launches
    v_ranks = sum(c["kernel_launches"] for c in serve["cells"]
                  if c["backend"] == "shm")
    for cell in serve["cells"]:
        record("serve_plane", **cell)
    record("serve_plane_mirrors_kmer", seconds=time.perf_counter() - t0,
           mirrors=serve["mirrors"], kmer=serve["kmer"])
    if v_launches + v_ranks == 0 or stage_copy.launches \
            or stage_copy_push.launches:
        raise AssertionError(f"the serve plane launched the gather "
                             f"{v_launches} times in process and {v_ranks} "
                             f"times in the server rank, the dense stage "
                             f"copy {stage_copy.launches} times and the "
                             f"push {stage_copy_push.launches} times (want "
                             "only the gather)")

    # 17. the in-graph collectives (counts set to 0 just before, read
    # just after), then tensor-parallel serving: counts set to 0 just
    # before 17b-d, read just after; every kernel call of 17a-d is kept
    # by signature, and each kernel is held against its plain version at
    # each one after the counts are read
    t17 = time.perf_counter()
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        coll = collectives_phase(torch)
        c_launches = stage_copy_rows.launches
        record("collectives", seconds=time.perf_counter() - t0, **coll)
        if stage_copy.launches or stage_copy_push.launches:
            raise AssertionError("the collectives launched the dense stage "
                                 "copy or the push")
        _zero_counts(counters)
        t0 = time.perf_counter()
        tp_gemma = tp_gemma_phase(torch)
        record("tp_gemma3", seconds=time.perf_counter() - t0, **tp_gemma)
        t0 = time.perf_counter()
        tp_small = tp_small_phase(torch)
        record("tp_small", seconds=time.perf_counter() - t0, **tp_small)
        t0 = time.perf_counter()
        tp2d = tp2d_phase(torch)
        record("tp2d_joint_kv", seconds=time.perf_counter() - t0, **tp2d)
        tp_launches = {"flash_attention": flash_attention_bhsd.launches,
                       "rmsnorm": rmsnorm.launches,
                       "moe_gmm": moe_gmm.launches,
                       "ssd_scan": ssd_scan_bhsp.launches,
                       "ssm_conv": ssm_conv.launches,
                       "doorbell": stage_copy_rows.launches}
    if min(tp_launches[k] for k in ("flash_attention", "rmsnorm",
                                    "moe_gmm", "ssd_scan")) == 0:
        raise AssertionError(f"the tensor-parallel paths launched a kernel "
                             f"no time: {tp_launches}")
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, path.calls)
    missing = [k for k, n in (("flash", tp_launches["flash_attention"]),
                              ("rmsnorm", tp_launches["rmsnorm"]),
                              ("moe_gmm", tp_launches["moe_gmm"]),
                              ("ssd_scan", tp_launches["ssd_scan"]),
                              ("ssm_conv", tp_launches["ssm_conv"]),
                              ("doorbell", c_launches
                               + tp_launches["doorbell"]))
               if n and not checks[k]]
    if missing:
        raise AssertionError(f"phase 17 launched {missing} at no signature "
                             "that was kept")
    record("phase17_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(v) for k, v in checks.items()},
           cases=checks)
    record("phase17", seconds=time.perf_counter() - t17,
           launches=tp_launches)
    flash += checks["flash"]
    rms += checks["rmsnorm"]
    moe += checks["moe_gmm"]
    ssd += checks["ssd_scan"]
    conv += checks["ssm_conv"]
    cases += checks["doorbell"]

    # 18. the recovery path: counts set to 0 just before 18a-b, read just
    # after; every kernel call kept by signature, and each kernel held
    # against its plain version at each one after the counts are read
    # (18c, the chaos-kill demo's resharded restore, ran in phase 15)
    t18 = time.perf_counter()
    with _PathCalls() as path:
        _zero_counts(counters)
        t0 = time.perf_counter()
        recovery = recovery_checkpoint_phase(torch)
        record("recovery_checkpoint", seconds=time.perf_counter() - t0,
               **recovery)
        t0 = time.perf_counter()
        pp = pipeline_comm_phase(torch)
        record("pipeline_1f1b", seconds=time.perf_counter() - t0, **pp)
        r_launches = {"flash_attention": flash_attention_bhsd.launches,
                      "rmsnorm": rmsnorm.launches,
                      "moe_gmm": moe_gmm.launches,
                      "ssd_scan": ssd_scan_bhsp.launches,
                      "ssm_conv": ssm_conv.launches,
                      "doorbell": stage_copy_rows.launches}
    if r_launches["flash_attention"] == 0 or r_launches["rmsnorm"] == 0 \
            or r_launches["moe_gmm"] or r_launches["ssd_scan"] \
            or r_launches["ssm_conv"]:
        raise AssertionError(f"the recovery path launched {r_launches} "
                             "(want B2 and B3, no B4, B5 or SSM conv)")
    t0 = time.perf_counter()
    checks = path_kernel_checks(torch, path.calls)
    missing = [k for k, n in (("flash", r_launches["flash_attention"]),
                              ("rmsnorm", r_launches["rmsnorm"]),
                              ("doorbell", r_launches["doorbell"]))
               if n and not checks[k]]
    if missing:
        raise AssertionError(f"phase 18 launched {missing} at no signature "
                             "that was kept")
    record("phase18_kernel_checks", seconds=time.perf_counter() - t0,
           signatures={k: len(v) for k, v in checks.items()},
           cases=checks)
    record("phase18", seconds=time.perf_counter() - t18,
           launches=r_launches)
    flash += checks["flash"]
    rms += checks["rmsnorm"]
    cases += checks["doorbell"]

    # 19. training on the card (:func:`training_phase`)
    grad_cases, g_launches, checks = training_phase(torch, counters,
                                                    args.profile)
    flash += checks["flash"]
    rms += checks["rmsnorm"]
    moe += checks["moe_gmm"]
    ssd += checks["ssd_scan"]
    conv += checks["ssm_conv"]
    cases += checks["doorbell"]

    # 20. the vlm and audio families (:func:`cross_phase`)
    x_launches, x_by_variant, x_flash, x_rms, x_grads = cross_phase(
        torch, counters, args.profile)
    flash += x_flash
    rms += x_rms
    grad_cases += x_grads
    flash_by["vlm and audio (phase 20)"] = x_by_variant

    # 21. training at tp > 1 (:func:`tp_training_phase`)
    p21_launches, p21_checks = tp_training_phase(torch, counters)
    flash += p21_checks["flash"]
    rms += p21_checks["rmsnorm"]
    moe += p21_checks["moe_gmm"]
    ssd += p21_checks["ssd_scan"]
    conv += p21_checks["ssm_conv"]
    cases += p21_checks["doorbell"]

    # 22. the analysis tools and the examples (:func:`analysis_phase`)
    p22_launches, p22_checks = analysis_phase(torch, counters)
    flash += p22_checks["flash"]
    rms += p22_checks["rmsnorm"]
    moe += p22_checks["moe_gmm"]
    ssd += p22_checks["ssd_scan"]
    conv += p22_checks["ssm_conv"]
    cases += p22_checks["doorbell"]

    # 23. the four configs no earlier phase ran (:func:`configs_phase`)
    p23_launches, p23_checks, p23_by = configs_phase(torch, counters,
                                                     args.profile)
    flash += p23_checks["flash"]
    rms += p23_checks["rmsnorm"]
    moe += p23_checks["moe_gmm"]
    flash_by["four configs (phase 23)"] = {
        k: sum(by[k] for by in p23_by["flash_attention"].values())
        for k in FLASH_DESIGN}

    def grad_err(prefix):
        return max(c["max_abs_err"] for c in grad_cases
                   if c["case"].startswith(prefix))

    def p23_signatures(kind):
        return [c["case"] for c in p23_checks[kind]]

    # the kernels line: headline numbers at each main path's shape
    head = next(c for c in cases if c["case"] == "rows_f32_64x16384_bf160")
    fhead = next(c for c in flash
                 if c["case"] == "gemma3_prefill_local512_bfloat16")
    rhead = next(c for c in rms if c["case"] == "serve_bfloat16_8192x1152")
    mhead = next(c for c in moe if c["case"] == "olmoe_decode_bfloat16")
    mpre = next(c for c in moe if c["case"] == "olmoe_prefill_bfloat16")
    shead = next(c for c in ssd if c["case"] == "mamba2_prefill_bfloat16")
    shymba = next(c for c in ssd if c["case"] == "hymba_prefill_bfloat16")
    chead = next(c for c in conv
                 if c["case"] == "mamba2_prefill_4x4096_bfloat16")
    timed = ("case", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "max_abs_err")
    flash += flash_moe + flash_ssm
    rms += rms_ssm
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "doorbell.stage_copy_rows", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES,
        "launches": launches + t_launches + p_launches + v_launches
        + v_ranks + c_launches + tp_launches["doorbell"]
        + r_launches["doorbell"] + g_launches["doorbell"]
        + p21_launches["doorbell"] + p22_launches["doorbell"]
        + p23_launches["doorbell"],
        "launches_by_path": {"message path (phase 4)": launches,
                             "transports (phase 15)": t_launches,
                             "two processes (phase 15)": p_launches,
                             "serve plane (phase 16)": v_launches,
                             "serve plane, server rank (phase 16)":
                                 v_ranks,
                             "collectives (phase 17a)": c_launches,
                             "tensor parallel (phase 17b-d)":
                                 tp_launches["doorbell"],
                             "recovery (phase 18)": r_launches["doorbell"],
                             "training (phase 19)": g_launches["doorbell"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["doorbell"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["doorbell"],
                             "four configs (phase 23)":
                                 p23_launches["doorbell"]},
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
        "replaces": FLASH_REPLACES,
        "launches": n_flash + m_flash + y_flash
        + tp_launches["flash_attention"] + r_launches["flash_attention"]
        + g_launches["flash_attention"] + x_launches["flash_attention"]
        + p21_launches["flash_attention"] + p22_launches["flash_attention"]
        + p23_launches["flash_attention"],
        "launches_by_path": {"gemma3-1b": n_flash, "olmoe-1b-7b": m_flash,
                             "mamba2-370m": 0, "hymba-1.5b": y_flash,
                             "tensor parallel (phase 17)":
                                 tp_launches["flash_attention"],
                             "recovery (phase 18)":
                                 r_launches["flash_attention"],
                             "training (phase 19)":
                                 g_launches["flash_attention"],
                             "vlm and audio (phase 20)":
                                 x_launches["flash_attention"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["flash_attention"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["flash_attention"],
                             "four configs (phase 23)":
                                 p23_launches["flash_attention"]},
        "signatures_phase23": p23_signatures("flash"),
        "max_abs_err": max(c["max_abs_err"] for c in flash),
        "plain_backward_max_abs_err": grad_err("flash"),
        "backward": "autograd of flash_attention_ref (tc: P in bf16), "
                    "recomputed from the saved q, k, v; " + PLAIN_BACKWARD,
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
                                   "library_causal_form",
                                   "library_unmasked_ms",
                                   "library_unmasked_form",
                                   "achieved_tflops", "bound_share"))}, {
        "name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
        "replaces": RMS_REPLACES,
        "launches": n_rms + m_rms + s_rms + y_rms + tp_launches["rmsnorm"]
        + r_launches["rmsnorm"] + g_launches["rmsnorm"]
        + x_launches["rmsnorm"] + p21_launches["rmsnorm"]
        + p22_launches["rmsnorm"] + p23_launches["rmsnorm"],
        "launches_by_path": {"gemma3-1b": n_rms, "olmoe-1b-7b": m_rms,
                             "mamba2-370m": s_rms, "hymba-1.5b": y_rms,
                             "tensor parallel (phase 17)":
                                 tp_launches["rmsnorm"],
                             "recovery (phase 18)": r_launches["rmsnorm"],
                             "training (phase 19)": g_launches["rmsnorm"],
                             "vlm and audio (phase 20)":
                                 x_launches["rmsnorm"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["rmsnorm"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["rmsnorm"],
                             "four configs (phase 23)":
                                 p23_launches["rmsnorm"]},
        "signatures_phase23": p23_signatures("rmsnorm"),
        "max_abs_err": max(c["max_abs_err"] for c in rms),
        "plain_backward_max_abs_err": grad_err("rmsnorm"),
        "backward": "autograd of rmsnorm_ref, recomputed from the saved "
                    "x and w; " + PLAIN_BACKWARD,
        "ms": rhead["kernel_ms"], "plain_ms": rhead["plain_ms"],
        "bound_ms": rhead["bound_ms"], "bound_by": "bytes",
        "library_ms": rhead["library_ms"], "shape": rhead["shape"],
        "launches_by_shape_by_path": rms_by_shape,
        "cases": _summary([c for c in rms if "kernel_ms" in c],
                          timed + ("copy_ms", "bound_share"))}, {
        "name": "moe_gmm", "route": "cuda", "source": MOE_SOURCE,
        "replaces": MOE_REPLACES, "launches": n_moe + tp_launches["moe_gmm"]
        + g_launches["moe_gmm"] + p21_launches["moe_gmm"]
        + p22_launches["moe_gmm"] + p23_launches["moe_gmm"],
        "launches_by_path": {"olmoe-1b-7b": n_moe,
                             "tensor parallel (phase 17)":
                                 tp_launches["moe_gmm"],
                             "training (phase 19)": g_launches["moe_gmm"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["moe_gmm"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["moe_gmm"],
                             "four configs (phase 23)":
                                 p23_launches["moe_gmm"]},
        "signatures_phase23": p23_signatures("moe_gmm"),
        "launches_by_variant_phase23": p23_by["moe_gmm"],
        "max_abs_err": max(c["max_abs_err"] for c in moe),
        "plain_backward_max_abs_err": grad_err("moe_gmm"),
        "backward": "autograd of moe_gmm_ref (tc: h rounded to bf16 once "
                    "after the float32 activation), recomputed from the "
                    "saved operands; " + PLAIN_BACKWARD,
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
        "replaces": SSD_REPLACES,
        "launches": s_ssd + y_ssd + tp_launches["ssd_scan"]
        + g_launches["ssd_scan"] + p21_launches["ssd_scan"]
        + p22_launches["ssd_scan"],
        "launches_by_path": {"mamba2-370m": s_ssd, "hymba-1.5b": y_ssd,
                             "tensor parallel (phase 17)":
                                 tp_launches["ssd_scan"],
                             "training (phase 19)": g_launches["ssd_scan"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["ssd_scan"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["ssd_scan"]},
        "max_abs_err": max(c["max_abs_err"] for c in ssd),
        "plain_backward_max_abs_err": grad_err("ssd_scan"),
        "backward": "autograd of ssd_scan_tc_ref (tc) or ssd_scan_ref "
                    "(simt), recomputed from the saved inputs; "
                    + PLAIN_BACKWARD,
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
                                   "tc_ref_h_final_limit_share"))}, {
        "name": "ssm_conv", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": s_conv + y_conv + tp_launches["ssm_conv"]
        + g_launches["ssm_conv"] + p21_launches["ssm_conv"]
        + p22_launches["ssm_conv"],
        "launches_by_path": {"mamba2-370m": s_conv, "hymba-1.5b": y_conv,
                             "tensor parallel (phase 17)":
                                 tp_launches["ssm_conv"],
                             "training (phase 19)": g_launches["ssm_conv"],
                             "training at tp > 1 (phase 21)":
                                 p21_launches["ssm_conv"],
                             "analysis tools and examples (phase 22)":
                                 p22_launches["ssm_conv"]},
        "max_abs_err": max(c["max_abs_err"] for c in conv),
        "backward": "autograd of ssm_conv_ref, recomputed from the saved "
                    "views and weights; " + PLAIN_BACKWARD,
        "ms": chead["kernel_ms"], "plain_ms": chead["plain_ms"],
        "bound_ms": chead["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": chead["shape"], "design": CONV_DESIGN,
        "signatures_held": len(conv),
        "cases": _summary([c for c in conv if "kernel_ms" in c],
                          timed + ("bound_share", "achieved_GB_per_s",
                                   "bitwise_float32_plain",
                                   "limit_share_plain"))}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
