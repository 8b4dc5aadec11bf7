"""Training launcher: any --arch at the smoke size, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
        --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2 \
        --checkpoint /tmp/state        # then --resume /tmp/state

The JAX package's `launch/train.py` with the same flags and defaults,
plus `--device` (the card unless told otherwise). As there, `--reduced`
is `store_true` with `default=True`, so the smoke-sized model always
runs. Parameters come from a `torch.Generator` seeded 0 on the device,
batches from `data.synth_tokens` seeded 1. `--checkpoint` saves the whole
`TrainState` (parameters, AdamW master and moments, counts) after the
last step and `--resume` restores one before the first
(`checkpoint/io.py`).

The reference runs its step under a mesh (`--model-axis` shards the
parameters over `model`); the port's sharding rules are not written yet
(`ROADMAP.md`, queue A item 8), so `--model-axis` above 1 is refused
rather than run unsharded.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import ASSIGNED, get_config, smoke
from repro_torch.data.synth_tokens import synthetic_lm_batches
from repro_torch.training.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ASSIGNED)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_axis > 1:
        raise SystemExit(
            f"--model-axis {args.model_axis}: the port has no sharding rules "
            "yet (ROADMAP.md, queue A item 8: sharding/rules.py as DTensor "
            "placements); it trains on one device")

    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg)
    if args.resume:
        state = restore_pytree(args.resume, state)
        print(f"resumed from {args.resume} at step {int(state.step)}")

    step = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    fe_shape = ((cfg.n_frontend_tokens, cfg.d_model)
                if cfg.frontend else None)
    batches = synthetic_lm_batches(torch.Generator(device=dev).manual_seed(1),
                                   vocab=cfg.vocab, batch=args.batch,
                                   seq=args.seq, frontend_shape=fe_shape)
    losses = []
    t0 = time.time()
    for i, batch in zip(range(args.steps), batches):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}  "
                  f"grad={float(metrics['grad_norm']):.3f}  "
                  f"{(time.time()-t0)/(i+1):.2f}s/step", flush=True)
    if args.checkpoint:
        save_pytree(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")
    return state, losses


if __name__ == "__main__":
    main()
