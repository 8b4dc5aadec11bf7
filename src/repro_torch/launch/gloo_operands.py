"""Gloo's collectives on CUDA operands: given directly, or staged through
the host, on the one card (card only).

    PYTHONPATH=src python -m repro_torch.launch.gloo_operands [--world 4]

Starts `--world` gloo ranks on the card (`substrate.run_probe`) and, on
each, times the two collectives of the distributed path at their phase 8
shapes — the sharded fit's all-gather of (4, 1024) f32 rows and the
sharded ingest's all-reduce of a (8, 1024, 1024) f32 Sigma — with the
CUDA operand handed to gloo as it lies and with it copied to the host
first and back after, in turns (direct, staged, staged, direct; 3
rounds; host clock around a synchronize, after a barrier), requires the
same bits both ways, and tries an all-to-all on a CUDA operand.
`substrate.collectives` hands operands over as they lie; this is the
measurement behind that choice.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.substrate import run_probe

_RANK = r"""
import json, time
import torch
import torch.distributed as dist
from repro_torch.substrate import all_gather_into, init_from_env

rank, world = init_from_env(device=torch.device("cuda"))


def gather(x, staged):
    src = x.cpu() if staged else x
    out = src.new_empty((world * x.shape[0], *x.shape[1:]))
    all_gather_into(out, src, None)
    return out.to(x.device) if staged else out


def reduce(x, staged):
    out = x.to("cpu", copy=True) if staged else x.clone()
    dist.all_reduce(out)
    return out.to(x.device) if staged else out


res = {}
for name, fn, shape in (("all_gather", gather, (4, 1024)),
                        ("all_reduce", reduce, (8, 1024, 1024))):
    x = torch.randn(shape, device="cuda")
    res[name] = {"same_bits": bool(torch.equal(fn(x, True), fn(x, False)))}
    for staged in (False, True, True, False) * 3:
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(x, staged)
        torch.cuda.synchronize()
        key = "staged_ms" if staged else "direct_ms"
        res[name].setdefault(key, []).append((time.perf_counter() - t) * 1e3)
x = torch.arange(8.0, device="cuda").reshape(4, 2) + 10 * rank
out = torch.empty_like(x)
dist.all_to_all_single(out, x)
res["all_to_all"] = out.flatten().tolist()
print("GLOO " + json.dumps(res))
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gloo_operands: needs a CUDA device")
    run = run_probe(_RANK, world=args.world, timeout=300, pg_timeout=120)
    if not run.ok:
        raise SystemExit(run.report())
    lines = [json.loads([s for s in r.stdout.splitlines()
                         if s.startswith("GLOO ")][0][5:]) for r in run.ranks]
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{args.world} gloo ranks on one card")
    for op in ("all_gather", "all_reduce"):
        for key in ("direct_ms", "staged_ms"):
            ts = sorted(t for ln in lines for t in ln[op][key])
            print(f"{op} {key[:-3]}: median {ts[len(ts) // 2]:.3f} ms, "
                  f"min {ts[0]:.3f}, max {ts[-1]:.3f} (all ranks)")
        if not all(ln[op]["same_bits"] for ln in lines):
            raise SystemExit(f"{op}: staged and direct differ")
    want = [[float(2 * r + i + 10 * j) for j in range(args.world)
             for i in range(2)] for r in range(args.world)]
    if [ln["all_to_all"] for ln in lines] != want:
        raise SystemExit("all_to_all on CUDA operands gave the wrong rows")
    print("all_to_all on CUDA operands: right rows on every rank")


if __name__ == "__main__":
    main()
