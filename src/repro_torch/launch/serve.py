"""Serving launcher: continuous batching with the LCI scheduler (port).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --device cpu --requests 8 --max-new 6 [--transport]

The mirror of ``repro/launch/serve.py`` with the reference's flags, plus
``--device {cuda,cpu}`` (default ``cuda``).  The model's weights are
random, drawn from seed 0; each engine round decodes the whole active batch
at the scheduler's position front through ``make_serve_step`` (one
device->host read of the sampled tokens per round).  ``--transport``
routes requests over the host runtime's endpoints: prompts ride a
by-size-striped prefill endpoint, generated tokens a separate decode
endpoint.  The vlm and audio configs are refused, as the reference's
launcher refuses them (its prompts carry no image or audio): their
serving entry points are ``serving.engine``'s ``precompute_cross_kv``,
``make_prefill_step`` and ``make_serve_step``.

:func:`serve` is the loop itself, callable with any config and params.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config, get_smoke
from ..core.attrs import parse_attr_args
from ..core.concurrency import drain as drain_cq
from ..core.runtime import LocalCluster, resolve_device
from ..models.common import ModelConfig
from ..models.registry import build_model
from ..serving import (PagedKVAllocator, ServeScheduler, ServeTransport,
                       init_cache, make_serve_step)

#: prompt length, as the reference's launcher draws prompts
PROMPT_LEN = 8


def serve(cfg: ModelConfig, params, *, requests: int = 16,
          max_new: int = 12, max_batch: int = 8, cache_len: int = 128,
          device=None, transport: Optional[ServeTransport] = None,
          drain_workers: int = 0) -> Dict:
    """Serve ``requests`` prompts of PROMPT_LEN ids drawn from
    ``np.random.default_rng(0)`` (as the reference's launcher draws them)
    until every one has ``max_new`` tokens.  Returns counts, timings and
    ``results``: the generated ids of each request, in submission
    order."""
    dev = resolve_device(device)
    step = make_serve_step(cfg)
    state = {"cache": init_cache(cfg, cache_len, max_batch, device=dev),
             "calls": 0}

    def decode_fn(tokens, positions):
        # the engine decodes the whole active batch at the scheduler's
        # position front (the cache length is the batch max; the
        # per-request positions are not used, as in the reference)
        pad = max_batch - len(tokens)
        toks = torch.from_numpy(np.pad(tokens, (0, pad)).astype(np.int32))
        nxt, state["cache"] = step(params, state["cache"], toks.to(dev))
        state["calls"] += 1
        return nxt.cpu().numpy()[:len(tokens)]

    alloc = PagedKVAllocator(n_pages=256, page_size=16)
    sched = ServeScheduler(decode_fn, max_batch=max_batch, allocator=alloc,
                           transport=transport)
    cq = sched.alloc_cq(threadsafe=drain_workers > 0)
    drain = (sched.start_result_drain(cq, drain_workers)
             if drain_workers > 0 else None)
    rng = np.random.default_rng(0)
    order: List[int] = []
    got: Dict[int, np.ndarray] = {}

    def collect(pairs):
        for rid, toks in pairs:
            got[rid] = np.asarray(toks, np.int32)

    t0 = time.perf_counter()
    for _ in range(requests):
        prompt = rng.integers(0, cfg.vocab, size=PROMPT_LEN)
        if transport is not None:
            order.append(sched.submit_remote(prompt, max_new))
        else:
            st = sched.submit(prompt, max_new, comp=cq, allow_retry=False)
            if st.is_retry():
                raise RuntimeError("submit was refused with retry")
            order.append(st.user_context)
    steps = 0
    while sched.completed < requests:
        sched.step()
        if transport is not None:
            transport.pump()
            collect(transport.poll_results())
        steps += 1
        if steps > requests * max_new * 4:
            raise RuntimeError("scheduler stalled")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if transport is not None:
        transport.pump()
        collect(transport.poll_results())
    statuses = drain.stop() if drain is not None else []
    statuses += drain_cq(cq)
    collect((st.tag, st.get_buffer()) for st in statuses)
    n_tok = sum(len(t) for t in got.values())
    return {"requests": requests, "completed": sched.completed,
            "tokens": n_tok, "seconds": dt, "rounds": steps,
            "decode_calls": state["calls"], "retries": sched.retries,
            "results": [got.get(rid) for rid in order]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--transport", action="store_true",
                    help="route requests over prefill/decode endpoints")
    ap.add_argument("--prefill-devices", type=int, default=2)
    ap.add_argument("--drain-workers", type=int, default=0,
                    help="drain the result CQ from N worker threads")
    ap.add_argument("--attr", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="runtime-level attribute override for the "
                         "transport cluster (repeatable)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm" or cfg.is_encdec:
        # as the reference's launcher: its prompts carry no image or audio
        raise SystemExit("serve demo targets decoder-only archs")
    model = build_model(cfg, device=args.device)
    params, _ = model.init(0)
    if args.attr and not args.transport:
        raise SystemExit("--attr tunes the transport cluster; it needs "
                         "--transport")
    if args.drain_workers > 0 and args.transport:
        raise SystemExit("--drain-workers drains the local result CQ; with "
                         "--transport results arrive via "
                         "transport.poll_results() instead — pick one")
    transport = None
    if args.transport:
        cluster = LocalCluster(2, attrs=parse_attr_args(args.attr),
                               device=args.device)
        transport = ServeTransport(cluster, n_prefill=args.prefill_devices)
        echo = cluster.attrs_echo()
        overridden = {k: v for k, v in echo["values"].items()
                      if echo["sources"].get(k) not in (None, "default",
                                                        "discovered")}
        if overridden:
            print(f"[serve] transport attrs (non-default): {overridden}")
    out = serve(cfg, params, requests=args.requests, max_new=args.max_new,
                max_batch=args.max_batch, cache_len=args.cache_len,
                device=model.device, transport=transport,
                drain_workers=args.drain_workers)
    if transport is not None:
        per_dev = [d["posts"] for d in
                   transport.counters()["prefill"][0]["devices"]]
        print(f"[serve] prefill endpoint posts per device: {per_dev}")
    if args.drain_workers > 0:
        print(f"[serve] {args.drain_workers} drain workers collected "
              f"{out['completed']} results concurrently")
    dt = out["seconds"]
    print(f"[serve] {cfg.name} on {model.device}: {args.requests} requests, "
          f"{out['tokens']} tokens in {dt:.2f}s ({out['tokens'] / dt:.1f} "
          f"tok/s, {out['rounds']} engine rounds, {out['retries']} "
          f"admission retries)")
    return out


if __name__ == "__main__":
    main()
