"""Serving demo: continuous batching with LCI admission semantics (the
PyTorch port).

    PYTHONPATH=src python examples/torch_serve_demo.py [--arch olmo-1b] \
        [--device cpu]

The mirror of ``examples/serve_demo.py`` on ``repro_torch``: builds the
reduced (smoke) model on ``--device`` (the card by default) with weights
drawn from seed 0, trains nothing — the demo is the *engine*: paged-KV
admission (packet pool), retry/backlog under page pressure, completion
queues for finished requests, greedy decode.  Decoder-only archs (the
vlm and audio configs need a memory the prompts do not carry).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_smoke
from repro_torch.models.registry import build_model
from repro_torch.serving import PagedKVAllocator, ServeScheduler
from repro_torch.serving.engine import init_cache, make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=[a for a in ARCH_NAMES])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    if cfg.family == "vlm" or cfg.is_encdec:
        raise SystemExit("demo targets decoder-only archs")
    model = build_model(cfg, device=args.device)
    params, _ = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} ({n_params:,} params) on {args.device}")

    cache = init_cache(cfg, 128, args.max_batch, device=args.device)
    serve = make_serve_step(cfg)
    box = {"cache": cache}

    def decode_fn(tokens, positions):
        pad = args.max_batch - len(tokens)
        toks = torch.as_tensor(np.pad(tokens, (0, pad)), dtype=torch.int32,
                               device=args.device)
        nxt, box["cache"] = serve(params, box["cache"], toks)
        return nxt.cpu().numpy()[:len(tokens)]

    alloc = PagedKVAllocator(n_pages=48, page_size=16)   # page pressure!
    sched = ServeScheduler(decode_fn, max_batch=args.max_batch,
                           allocator=alloc)
    cq = sched.alloc_cq()      # unified comp API (routes via transport when present)
    rng = np.random.default_rng(0)
    t0 = time.time()
    backlogged = 0
    for i in range(args.requests):
        st = sched.submit(rng.integers(0, cfg.vocab, size=6),
                          args.max_new, comp=cq, allow_retry=False)
        backlogged += st.code.name == "POSTED_BACKLOG"
    print(f"submitted {args.requests} requests "
          f"({backlogged} parked in the backlog under page pressure)")
    rounds = 0
    while sched.completed < args.requests:
        sched.step()
        rounds += 1
        assert rounds < 10_000
    dt = time.time() - t0
    n_tok = 0
    while True:
        st = cq.pop()
        if st.is_retry():
            break
        n_tok += len(st.get_buffer())
    print(f"done: {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s), "
          f"{rounds} engine rounds, free pages back to "
          f"{alloc.free_pages}/48")
    print(f"backlog: {backlogged}")
    print("serve demo OK")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
