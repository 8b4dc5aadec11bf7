"""Where the serving path's time goes on the card: one prefill and a few
decode steps of a configuration at full width, under `torch.profiler`.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

The configuration is the serving cell of `serving/cell.py`, the one that
`chip_smoke.py`'s phase 6 gates (granite-3-2b, batch 4, prompts of 2048
tokens, 16 new tokens): one prefill and the 15 decode steps that
`greedy_generate` runs after it are profiled.

For each phase it prints the host wall time (ending in a synchronize),
the device's busy time (the union of its kernels' intervals) and so its
idle share, the kernels launched, and the device time by kernel group
(the flash kernel, matrix products, the rest) and by kernel name. It
needs a CUDA device and raises without one.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.models import Batch, forward_decode, forward_prefill
from repro_torch.serving.cell import NEW_TOKENS, make_cell


def _group(name: str) -> str:
    low = name.lower()
    if any(w in low for w in ("fista_", "ista_step", "rank_update",
                              "rank_c", "logistic_", "group_threshold")):
        return "the port's DSML kernels"
    if "flash_fwd" in low:
        return "flash_attention kernel"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90_", "splitk")):
        return "matrix products"
    return "other (elementwise, norms, RoPE, softmax, copies)"


def device_report(label: str, prof, wall_s: float, reps: int) -> None:
    """Print what a `torch.profiler` profile of `reps` runs taking
    `wall_s` seconds on the host shows of the card: its busy time (the
    union of the kernels' intervals) and idle share, kernels per run,
    and device time by kernel group and by kernel name."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"{label}: the profiler recorded no device activity")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        by_group[_group(e.name)] += us
    wall_us = wall_s * 1e6
    print(f"{label}: wall {wall_s * 1e3 / reps:.3f} ms per run, device busy "
          f"{busy / 1e3 / reps:.3f} ms per run (idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}), {len(kernels) / reps:.0f} "
          f"kernels per run")
    for grp, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {grp}: {us / 1e3 / reps:.3f} ms per run "
              f"({us / busy:.3f} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / reps:9.3f} ms  {name[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    cfg, params, prompt = make_cell("cuda")
    B, S = prompt.shape
    steps = NEW_TOKENS - 1                 # greedy_generate's decode steps
    cache_len = S + NEW_TOKENS

    def prefill():
        return forward_prefill(params, cfg, Batch(tokens=prompt),
                               cache_len=cache_len)

    def decode(logits, caches):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for i in range(steps):
            logits, caches = forward_decode(params, cfg, tok, S + i, caches)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return tok

    decode(*prefill())                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode(logits, caches)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{cfg.name} without the profiler: prefill {(t1 - t0) * 1e3:.1f} "
          f"ms, decode {(t2 - t1) * 1e3 / steps:.2f} ms per step")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_report(f"{cfg.name} prefill (batch {B}, prompt {S})", prof, wall, 1)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode(logits, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_report(f"{cfg.name} decode step (batch {B}, cache {cache_len})",
            prof, wall, steps)
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.cpu_parent is None]
    print(f"  host: {len(ops) / steps:.0f} top-level PyTorch calls per step")
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=15,
                                    max_name_column_width=40))


if __name__ == "__main__":
    main()
