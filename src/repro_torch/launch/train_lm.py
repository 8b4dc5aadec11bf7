"""End-to-end training example: train a small LM from the zoo on synthetic
data and watch the loss fall.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \
        --steps 30

The port of the JAX package's `examples/train_lm.py`, with its flags and
defaults (a dense model of the `--arch` family cut to `--d-model` and
`--layers`, about 25M parameters by default), plus `--device` (the card
unless told otherwise). The ~100M configuration of the reference's loss
curve:

    python -m repro_torch.launch.train_lm --d-model 768 --layers 12 \
        --steps 300 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synth_tokens import synthetic_lm_batches
from repro_torch.training.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_config(args.arch).replace(
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 128), n_kv_heads=2,
        head_dim=64, d_ff=4 * args.d_model, vocab=args.vocab)
    print(f"arch={cfg.name} (reduced) params={cfg.param_count()/1e6:.1f}M")

    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    batches = synthetic_lm_batches(torch.Generator(device=dev).manual_seed(1),
                                   vocab=cfg.vocab, batch=args.batch,
                                   seq=args.seq)
    losses = []
    t0 = time.time()
    for i, batch in zip(range(args.steps), batches):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}  "
                  f"grad_norm={float(metrics['grad_norm']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    print("done.")
    return losses


if __name__ == "__main__":
    main()
