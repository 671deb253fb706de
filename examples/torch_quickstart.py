"""Quickstart: the LCI-X public API in five minutes (the PyTorch port).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The mirror of ``examples/quickstart.py`` on ``repro_torch``: every
cluster binds ``--device`` (the card by default; ``cpu`` runs it without
one).  Walks the paper's core concepts end to end:
  1. runtime + resources (endpoints, the unified completion objects)
  2. endpoint-centric posting / Table-1 (send-recv, AM, RMA put)
  3. the ternary done/posted/retry status protocol + OFF idiom
  4. ASYNC completion graphs (comm ops as nodes, progress-completed)
  5. striping and progress policies (DESIGN.md §8)
  6. multithreaded progress workers + thread-safe CQs (DESIGN.md §10)
  7. burst posting: post_many doorbells + the OFF .batch() spelling
     (DESIGN.md §11)
  8. the unified attribute system: layered overrides + get_attr
     introspection on every resource, with the old-kwarg -> attr
     migration table (DESIGN.md §12)
  9. fused doorbells: packed single-descriptor bursts + the bf16 wire
     compression toggle (DESIGN.md §13)
  10. pluggable transport backends: shm rings in-process, then a real
      two-OS-process run via the SPMD launcher (DESIGN.md §14)
  11. the telemetry plane: attr-controlled stage timers, the unified
      counter snapshot, and Chrome trace export (DESIGN.md §15)
  12. the chaos plane: attr-driven fault injection healed by the
      reliability protocol, and the rank-death fail-fast (DESIGN.md §16)
  13. the serving engine: continuous batching on the comm core — paged
      KV slots, burst token delivery, exactly-once drains (DESIGN.md §17)
  14. an in-graph ring collective under ``spmd_map`` on rank threads

Posting is endpoint-centric since the comp/graph redesign (DESIGN.md §9).
Before:  post_send_x(r0, 1, buf, 16, tag).device(dev)()
After:   ep0.post_send(1, buf, 16, tag)          # stripe picks the device
         post_send_x(r0, 1, buf, 16, tag).endpoint(ep0)()   # deferred form
The raw post_*_x(...).device(...) spelling still works — endpoints are the
porcelain over it, and the `.endpoint(...)` OFF option is what completion
graphs use for their comm nodes.
"""
import argparse
import functools

import numpy as np

from repro_torch.core import (CommConfig, MatchingPolicy, post_am_x,
                              post_recv_x, post_send_x)
from repro_torch.core import LocalCluster as _LocalCluster


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device every cluster binds (default: the "
                         "card)")
    args = ap.parse_args(argv)
    # every cluster of the walk binds the chosen device
    LocalCluster = functools.partial(_LocalCluster, device=args.device)

    # -- 1. runtime lifecycle (paper §3.2.2): no global init; allocate --
    cfg = CommConfig(inject_max_bytes=64, bufcopy_max_bytes=4096)
    cluster = LocalCluster(n_ranks=2, config=cfg)
    r0, r1 = cluster[0], cluster[1]
    print(f"ranks: {r0.get_rank_me()}/{r0.get_rank_n()}")
    # a symmetric 2-device endpoint bundle on every rank: all posting
    # below rides these (stripe policy picks the device per op)
    eps = cluster.alloc_endpoint(n_devices=2, stripe="round_robin",
                                 name="quickstart")
    ep0, ep1 = eps

    # -- 2a. active messages with a remote completion queue ------------
    rcq = r1.alloc_cq()               # unified comp: signal/test/wait
    rcomp = r1.register_rcomp(rcq)
    status = ep0.post_am(1, np.arange(8, dtype=np.uint8), remote_comp=rcomp,
                         tag=42)
    print(f"inject AM -> {status.kind.name} (done = completed immediately)")
    msg = rcq.wait(cluster)           # progress-driven wait pops one status
    print(f"delivered: tag={msg.tag} payload={msg.get_buffer()[:4]}...")

    # -- 2b. send/recv with wildcard matching (OFF form: the wildcard
    #        matching policy is an option, endpoint= routes the device) --
    buf = np.zeros(16, np.uint8)
    post_recv_x(r1, 0, buf, 16, 0).matching_policy(
        MatchingPolicy.RANK_ONLY).endpoint(ep1)()
    post_send_x(r0, 1, np.full(16, 7, np.uint8), 16, 999).matching_policy(
        MatchingPolicy.RANK_ONLY).endpoint(ep0)()
    cluster.quiesce()
    print(f"wildcard recv got: {buf[:4]}...")

    # -- 2c. RMA put into registered memory -----------------------------
    target = np.zeros(32, np.uint8)
    region = r1.register_memory(target)
    ep0.post_put(1, np.arange(32, dtype=np.uint8), (region.rid, 0), 32)
    cluster.quiesce()
    print(f"RMA put landed: {target[:4]}...")

    # -- 3. back-pressure: retry is a value, not an exception -----------
    tiny = LocalCluster(2, cfg, fabric_depth=1)
    tiny[0]
    post_send_x(tiny[0], 1, np.zeros(8, np.uint8), 8, 0)()
    st = post_send_x(tiny[0], 1, np.zeros(8, np.uint8), 8, 0)()
    print(f"full fabric -> {st.kind.name} ({st.code.name}): caller decides")

    # -- 4. ASYNC completion graph: comm ops as graph nodes --------------
    #       An unfired OFF op is a node; graph.start() posts ready
    #       nodes, the progress engine signals completions, descendants
    #       fire as signals arrive.  No host-side synchronous fire.
    g = r0.alloc_graph("demo")
    inbox = np.zeros(16, np.uint8)
    recv = g.add_comm(post_recv_x(r1, 0, inbox, 16, 7).endpoint(ep1),
                      name="recv")
    send = g.add_comm(post_send_x(r0, 1, np.full(16, 3, np.uint8), 16,
                                  7).endpoint(ep0), name="send")
    summed = g.add_node(lambda r, s: int(inbox.sum()), deps=[recv, send])
    g.start()                         # posts the comm nodes
    ready, _ = g.test()               # non-blocking probe
    vals = g.wait()                   # drives the cluster's progress
    g.assert_partial_order()
    print(f"async graph: started ready={ready}, sum={vals[summed]} "
          f"(fire order {g.fire_order}); execute() is now a shim over "
          f"start+wait")

    # -- 5. striping: by_peer/by_size isolate traffic classes; progress
    #       stays explicit: nothing moves until someone drives devices ---
    for i in range(4):
        ep0.post_am(1, np.full(8, i, np.uint8), remote_comp=rcomp)
    while eps[0].progress() + eps[1].progress():
        pass                          # explicit, client-driven progress
    print(f"endpoint striping: posts/device = "
          f"{[d['posts'] for d in ep0.counters()['devices']]}")
    while not rcq.pop().is_retry():
        pass                          # drain the demo deliveries

    # -- 6. multithreaded progress (paper §4.2.3): progress="workers"
    #       spawns N real threads that drive the endpoint's devices
    #       through per-device try-locks — a thread that fails a lock
    #       moves on.  Worker-signaled queues must be thread-safe:
    #       alloc_cq(threadsafe=True) is the paper's §4.1.4 FAA queue. --
    import dataclasses
    import time

    from repro_torch.core import EndpointSpec
    wspec = EndpointSpec(name="workers-demo", n_devices=2,
                         progress="workers", n_workers=2)
    # symmetric bundles (streams match by device index), each with its
    # own worker threads: rank0's push the wire, rank1's deliver
    wep0 = r0.alloc_endpoint(spec=wspec)
    wep1 = r1.alloc_endpoint(spec=dataclasses.replace(wspec,
                                                      name="workers-demo@1"))
    wcq = r1.alloc_cq(threadsafe=True)
    wrc = r1.register_rcomp(wcq)
    with wep0, wep1:                  # starts/stops the worker threads
        for i in range(8):
            wep0.post_am(1, np.full(8, i, np.uint8), remote_comp=wrc)
        while wcq.pushes < 8:         # the workers deliver; we just wait
            time.sleep(1e-4)
    print(f"worker threads delivered {wcq.pushes} AMs (lock skips: "
          f"{wep1.counters()['workers']['lock_skips']})")

    # -- 7. burst posting (paper §4.3, DESIGN.md §11): a windowed hot
    #       loop coalesces K posts into one doorbell per stripe device —
    #       one packet-pool grab, one stacked payload copy, one fabric
    #       push, one telemetry bump, instead of one of each per message.
    #       A mid-burst retry splits the doorbell prefix-accept: re-post
    #       the failed suffix after driving progress. --------------------
    bursty = np.stack([np.full(8, i, np.uint8) for i in range(32)])
    statuses = ep0.post_am_many(1, list(bursty), rcomp,
                                tags=list(range(32)))
    pending = [s for s in statuses if s.is_retry()]
    while eps[0].progress() + eps[1].progress():
        pass
    delivered = 0
    while not rcq.pop().is_retry():
        delivered += 1
    print(f"burst posting: {delivered}/32 AMs in "
          f"{r0.engine.burst_posts} doorbell(s), {len(pending)} to re-post")

    # the OFF spelling batches deferred ops the same way
    batch = post_send_x(r0, 1, np.full(8, 1, np.uint8), 8, 70).endpoint(
        ep0).batch()
    post_send_x(r0, 1, np.full(8, 2, np.uint8), 8, 71).endpoint(
        ep0).batch(batch)
    got = [np.zeros(8, np.uint8), np.zeros(8, np.uint8)]
    sync2 = r1.alloc_sync(expected=2)
    for tag, buf in zip((70, 71), got):
        post_recv_x(r1, 0, buf, 8, tag, sync2)()
    batch.flush()                     # one doorbell for both sends
    sync2.wait(cluster)
    print(f"OFF .batch(): delivered {got[0][0]}, {got[1][0]} in order")

    # -- 8. the unified attribute system (DESIGN.md §12): every knob is
    #       one registry entry, resolved defaults -> REPRO_ATTR_* env ->
    #       LocalCluster(attrs=...) -> per-alloc named overrides, and
    #       queryable on every live resource via get_attr/.attrs.
    #
    #       old kwarg spelling                  -> attribute name
    #       ----------------------------------------------------------
    #       CommConfig(inject_max_bytes=...)    -> eager_max_bytes
    #       CommConfig(bufcopy_max_bytes=...)   -> rdv_threshold
    #       CommConfig(n_channels=...)          -> n_channels
    #       CommConfig(packets_per_lane=...)    -> packets_per_lane
    #       CommConfig(packet_bytes=...)        -> packet_bytes
    #       LocalCluster(fabric_depth=...)      -> fabric_depth
    #       LocalCluster(link_latency=...)      -> link_latency
    #       alloc_cq(capacity=...)              -> cq_capacity
    #       EndpointSpec(n_devices/stripe/...)  -> n_devices/stripe/
    #                                              progress/n_workers
    #       ProgressWorkerPool(burst=...)       -> worker_burst
    #       (old spellings keep working as deprecation shims) -----------
    tuned = LocalCluster(2, attrs={"eager_max_bytes": 16,
                                   "cq_capacity": 32})
    tcq = tuned[0].alloc_cq()                      # runtime layer: 32
    print(f"attrs: eager_max_bytes="
          f"{tuned[0].get_attr('eager_max_bytes')} "
          f"(source {tuned[0].attr_source('eager_max_bytes')}), "
          f"cq_capacity={tcq.get_attr('cq_capacity')}, "
          f"pool free_packets={tuned[0].get_attr('free_packets')}")
    tep = tuned[0].alloc_endpoint(stripe="by_size")   # per-alloc override
    print(f"attrs: endpoint stripe={tep.get_attr('stripe')} "
          f"width={tep.get_attr('width')}; try "
          f"REPRO_ATTR_RDV_THRESHOLD=64 python examples/torch_quickstart.py "
          f"to flip bulk sends to rendezvous")

    # -- 9. fused doorbells (DESIGN.md §13): eager bursts of >=
    #       fused_min_burst uniform ops collapse into ONE packed wire
    #       descriptor (one stage-copy, one push, one matching probe),
    #       and wire_bf16 folds f32->bf16 wire compression into that
    #       same staging copy — delivered payloads come back as f32. --
    fcl = LocalCluster(2, attrs={"eager_max_bytes": 64,
                                 "wire_bf16": True})
    feps = fcl.alloc_endpoint(n_devices=1, name="fused")
    print(f"attrs: doorbell_fused={fcl[0].get_attr('doorbell_fused')} "
          f"fused_min_burst={fcl[0].get_attr('fused_min_burst')} "
          f"wire_bf16={fcl[0].get_attr('wire_bf16')}")
    fcq = fcl[1].alloc_cq()
    frc = fcl[1].register_rcomp(fcq)
    fbufs = [np.linspace(0, 1, 4, dtype=np.float32)] * 8
    fsts = feps[0].post_am_many(1, fbufs, frc)     # one fused doorbell
    feps[1].progress()
    delivered = 0
    while fcq.pop().is_done():
        delivered += 1
    print(f"fused doorbell: {sum(1 for s in fsts if s.is_done())} posted "
          f"-> {delivered} delivered as f32 over a bf16 wire "
          f"({fcl[0].fabric.pushes} rows on 1 descriptor); flip it off "
          f"with attrs={{'doorbell_fused': False}} or "
          f"REPRO_ATTR_DOORBELL_FUSED=0")

    # -- 10. transport backends (DESIGN.md §14): the fabric is an attr.
    #       "sim" (default) is the in-process deque fabric every section
    #       above used; "shm" swaps in mmap'd SPSC ring buffers with a
    #       stable wire codec — same API, real bytes. -------------------
    tcl = LocalCluster(2, attrs={"fabric_backend": "shm"})
    tcq = tcl[1].alloc_cq()
    trc = tcl[1].register_rcomp(tcq)
    post_am_x(tcl[0], 1, np.arange(8, dtype=np.uint8), None, None, trc)()
    tcl.quiesce()
    st = tcq.pop()
    print(f"shm backend: backend={tcl.fabric.backend} "
          f"(source={tcl.attr_source('fabric_backend')}), AM delivered "
          f"through a {tcl.get_attr('shm_ring_bytes')}-byte ring: "
          f"{st.is_done()}")
    tcl.close()                       # unlinks the rings' directory
    #       The same backend spans OS processes: the SPMD launcher forks
    #       N ranks that meet in one shared set of rings (the paper's
    #       process mode, Figures 2/3).  Timeout-bounded — a wedged rank
    #       is reaped, never hung on.
    import subprocess
    import sys as _sys
    demo = subprocess.run(
        [_sys.executable, "-m", "repro_torch.launch.spmd", "--ranks", "2",
         "--backend", "shm", "--iters", "10", "--timeout", "60",
         "--device", args.device],
        capture_output=True, text=True, timeout=90)
    print(f"spmd 2-process shm demo: exit={demo.returncode}")
    for line in demo.stdout.splitlines():
        if "spmd-demo" in line:
            print(f"  {line}")

    # -- 11. the telemetry plane (DESIGN.md §15): observability is an
    #       attr.  telemetry_level=off (default) is a one-branch no-op
    #       on every hot path; "counters" unifies every legacy counter
    #       into one snapshot; "timers" adds per-stage span histograms;
    #       "trace" adds a Chrome-loadable timeline. -------------------
    import json as _json
    import tempfile as _tempfile
    ocl = LocalCluster(2, attrs={"telemetry_level": "trace",
                                 "eager_max_bytes": 1})  # bufcopy -> pool
    ocq = ocl[1].alloc_cq()
    orc = ocl[1].register_rcomp(ocq)
    for _ in range(32):
        post_am_x(ocl[0], 1, np.zeros(8, np.uint8), None, None, orc)()
        ocl.progress_all()
        while ocq.pop().is_done():
            pass
    ocl.quiesce()
    snap = ocl.telemetry_snapshot()   # mergeable across ranks/processes
    stages = sorted(snap["spans"])
    print(f"telemetry: level={ocl.get_attr('telemetry_level')} "
          f"({len(stages)} stages timed): {', '.join(stages[:6])}, ...")
    post_us = snap["spans"]["post"]["sum"] / 1e3
    print(f"telemetry: post count={snap['spans']['post']['count']} "
          f"total={post_us:.1f}us; counters: "
          f"device.posts={snap['counters']['device.posts']} "
          f"pool.gets={snap['counters']['pool.gets']}")
    # every resource carries its slice as a readonly attr
    print(f"telemetry: device attr block -> "
          f"{ocl[0].default_device.get_attr('telemetry')['counters']}")
    with _tempfile.TemporaryDirectory() as td:
        path = ocl.export_trace(f"{td}/trace.json")
        n_ev = len(_json.load(open(path))["traceEvents"])
        print(f"telemetry: exported {n_ev} Chrome trace_event slices "
              f"(load at chrome://tracing); try "
              f"REPRO_ATTR_TELEMETRY_LEVEL=timers on any benchmark")

    # -- 12. the chaos plane (DESIGN.md §16): faults are attrs too.
    #       Non-zero chaos_* wraps the fabric in a fault-injecting
    #       transport; reliability="auto" arms seq-stamping, cumulative
    #       acks, and retransmit — so 5% drop + dup + reorder still
    #       delivers exactly-once, in order.  REPRO_ATTR_CHAOS_DROP=0.05
    #       does the same to any run from the environment. -------------
    ccl = LocalCluster(2, attrs={"chaos_drop": 0.05, "chaos_dup": 0.05,
                                 "chaos_reorder": 0.05, "chaos_seed": 7})
    ccq = ccl[1].alloc_cq()
    crc = ccl[1].register_rcomp(ccq)
    for i in range(200):
        st = post_am_x(ccl[0], 1, np.full(32, i % 256, np.uint8), None,
                       None, crc).tag(i)()
        while st.is_retry():
            ccl.progress_all()
            st = post_am_x(ccl[0], 1, np.full(32, i % 256, np.uint8),
                           None, None, crc).tag(i)()
    ccl.quiesce()                     # drives retransmits until healed
    ctags = []
    while True:
        st = ccq.pop()
        if st.is_retry():
            break
        ctags.append(st.tag)
    faults = ccl.fabric.fault_counters()
    rel = ccl[0].rel.counters()
    assert ctags == list(range(200)), "chaos beat the reliability plane"
    print(f"chaos: 200/200 delivered in order despite "
          f"{faults['dropped']} drops, {faults['duped']} dups, "
          f"{faults['reordered']} reorders "
          f"({rel['retransmits']} retransmits, "
          f"{ccl[1].rel.counters()['dups_dropped']} dups swallowed); "
          f"try REPRO_ATTR_CHAOS_DROP=0.05 on the whole test suite")
    # rank death is the fault the protocol can't heal — it fails fast
    # instead: posts toward a dead peer err ERR_PEER_DEAD at post time,
    # outstanding ones complete ERR_PEER_DEAD on the next sweep (the
    # no-hang guarantee).  The SPMD launcher's --chaos-kill drives the
    # full recovery: heartbeat detection -> shrink_mesh -> resharded
    # restore (see python -m repro_torch.launch.spmd --help).
    ccl[0].mark_peer_dead(1)
    st = post_am_x(ccl[0], 1, np.zeros(8, np.uint8), None, None, crc)()
    print(f"chaos: post to dead peer -> {st.code.name} at post time")
    ccl.close()

    # -- 13. the serving engine (DESIGN.md §17): continuous batching
    #       whose whole data plane is the comm core.  Prompts ride a
    #       by_size prefill endpoint, token returns a separate decode
    #       endpoint; every engine tick is a CompletionGraph whose
    #       first-token posts are comm NODES; decode steps burst their
    #       16-byte token rows through post_am_many; drain worker
    #       threads pop the thread-safe result CQ; and the paged-KV
    #       geometry is all attrs with get_attr introspection. ----------
    from repro_torch.serving import (ContinuousBatcher, ServePlane,
                                     SyntheticModel, TokenClient)
    scl = LocalCluster(2)
    plane = ServePlane(scl)           # rank 0 client, rank 1 server
    model = SyntheticModel(seed=7, device=args.device)  # token oracle
    server = ContinuousBatcher(plane, model, kv_slots=4, kv_page_tokens=8,
                               kv_evict="preempt_longest")
    sclient = TokenClient(plane, model, drain_workers=2)
    rng = np.random.default_rng(7)
    for _ in range(12):
        prompt = rng.integers(0, 32000, rng.integers(4, 40)).astype(np.int32)
        max_new = int(rng.integers(1, 9))
        rid, st = sclient.submit(prompt, max_new)
        while st.is_retry():
            server.step()
            rid, st = sclient.submit(prompt, max_new, rid=rid)
    while not (server.completed >= 12 and server.idle):
        server.step()                 # prefill/decode/deliver interleave
    while sclient.drain.drained < sclient.expected_tokens:
        sclient.pump()
    report = sclient.collect()        # verifies vs the model oracle
    assert report["lost"] == report["duplicated"] == 0, report
    print(f"serving: {report['completed']}/12 streams exactly-once, "
          f"{report['tokens']} tokens, {server.slots.preemptions} "
          f"preemptions, kv_slots={server.get_attr('kv_slots')} -> see "
          f"benchmarks/serve_traffic.py for the 1k-client open loop")
    scl.close()

    # -- 14. the in-graph layer: ring collectives.  spmd_map runs one
    #       function once per rank of a mesh, each rank on its own
    #       thread with a Comm whose model axis is a bound LciAxis (the
    #       port's shard_map); a local Comm degenerates to local math ---
    import torch
    from repro_torch.distributed import Mesh, P, spmd_map
    from repro_torch.distributed.comm import local_comm
    x = torch.ones((8, 4), device=args.device)
    w = torch.ones((4, 4), device=args.device)
    y = local_comm().ag_matmul(x, w)  # one rank: the local matmul
    with Mesh((1, 4), ("data", "model"), device=args.device) as mesh:
        ring = spmd_map(lambda comm, xs, w: comm.ag_matmul(xs, w), mesh,
                        in_specs=(P("model", None), P()),
                        out_specs=P(None, None))
        y4 = ring(x, w)               # each rank: ring all-gather matmul
    assert torch.equal(y4, y), "the ring's all-gather matmul drifted"
    print(f"ag_matmul: {tuple(y.shape)} locally, the same on a (1, 4) mesh "
          f"of rank threads; see launch/dryrun.py for the 512-rank meshes")
    print("quickstart OK")


if __name__ == "__main__":
    main()
