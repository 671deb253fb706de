"""End to end: train a ~100M-param dense LM for a few hundred steps
(the PyTorch port).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \
        [--tiny] [--device cpu]

The mirror of ``examples/train_100m.py`` on ``repro_torch``: the full
production path — config -> model -> AdamW (float32 master) -> train loop
with async checkpointing, straggler monitoring, metrics CSV, and
deterministic step-indexed data — on ``--device`` (the card by default).
``--tiny`` shrinks the model for a fast smoke run; the default is a true
~100M-parameter model.  Checkpoints and the metrics CSV go to
``--ckpt-dir`` (default ``build/torch_train_100m`` in the checkout).
Resume: rerun the same command after an interrupt.
"""
import argparse
import os
import time

import torch

from repro_torch.data import SyntheticPipeline
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import make_train_step, train_state_init
from repro_torch.train.loop import LoopConfig, train_loop

CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "build", "torch_train_100m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = ModelConfig(name="lm-tiny", family="dense", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                          vocab=2048, tp_target=4, dtype=torch.float32)
    else:
        # ~100M params: 12L x 640d x swiglu(1792) + 32k vocab (tied)
        cfg = ModelConfig(name="lm-100m", family="dense", n_layers=12,
                          d_model=640, n_heads=10, n_kv_heads=5,
                          d_ff=1792, vocab=32000, tie_embeddings=True,
                          tp_target=4, dtype=torch.float32)
    model = build_model(cfg, device=args.device)
    opt = AdamWConfig(lr=cosine_schedule(args.lr, 20, args.steps))
    state, specs = train_state_init(model, 0, opt)
    n = sum(t.numel() for t in _leaves(state.params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps "
          f"@ {args.seq}x{args.batch} on {args.device}")

    step_fn = make_train_step(model, specs, opt)
    pipe = SyntheticPipeline(vocab=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch, n_motifs=256,
                             motif_len=16)
    t0 = time.time()
    state, hist = train_loop(
        state, step_fn, pipe,
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=100, log_every=20,
                   metrics_csv=f"{args.ckpt_dir}/metrics.csv"))
    dt = time.time() - t0
    tok_s = len(hist) * args.seq * args.batch / dt
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} | "
          f"{dt:.0f}s total, {tok_s:,.0f} tok/s on {args.device}")
    assert hist[-1]["loss"] < hist[0]["loss"], "did not learn"
    print("train_100m OK")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
