#!/usr/bin/env python3
"""On the card only: training losses of mamba2-370m at full width and
several depths, the first steps of ``make_train_step`` on one fixed
``SyntheticPipeline`` batch (2 x 1024 tokens, AdamW at a constant 1e-3,
bf16 params with the float32 master; seed 0), as ``chip_smoke.py``
phase 19c trains it.  Prints one JSON line a depth.

    python3 tools/probe_train_depth.py [--layers 2,8,48] [--steps 4]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", default="2,8,48")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_train_depth: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state_init
    _build.build()
    for layers in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(get_config(args.arch), n_layers=layers)
        model = build_model(cfg, device="cuda")
        opt = AdamWConfig(lr=1e-3)
        state, specs = train_state_init(model, 0, opt)
        step = make_train_step(model, specs, opt)
        batch = SyntheticPipeline(vocab=cfg.vocab, seq_len=1024,
                                  global_batch=2).get_batch(0, device="cuda")
        losses = []
        for _ in range(args.steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        print(json.dumps({"arch": args.arch, "layers": layers,
                          "losses": losses}), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
