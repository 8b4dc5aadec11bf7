"""Production serving launcher: batched greedy decoding for any --arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 4 --new-tokens 16

The same flags and defaults as the JAX package's launcher, plus
`--device` (the card unless told otherwise). As there, `--reduced` is
`store_true` with `default=True`, so the smoke-sized model always runs.
Parameters and prompt come from seeded `torch.Generator`s (seeds 0 and 1).
The port serves dense stacks only (ROADMAP queue A item 7).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ASSIGNED, get_config, smoke
from repro_torch.models import init_params
from repro_torch.serving.engine import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ASSIGNED)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke(cfg)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    t0 = time.time()
    out = greedy_generate(params, cfg, prompt, steps=args.new_tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"{cfg.name}: generated {args.batch}x{args.new_tokens} tokens "
          f"in {time.time()-t0:.1f}s (incl. first-call costs)")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
