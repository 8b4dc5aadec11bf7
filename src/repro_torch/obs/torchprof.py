"""Optional bridge to `torch.profiler`, the port's counterpart of the JAX
package's `jax.profiler` bridge.

Kept out of `repro_torch.obs.__init__` so that the telemetry core
imports nothing outside the standard library. Import this module when
you want the host's and the card's kernels on a timeline beside the obs
spans:

    from repro_torch.obs import torchprof
    with torchprof.profiler_trace("trace-dir") as prof:
        run_workload()
    # trace-dir/trace.<pid>.json opens in Perfetto or chrome://tracing
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profiler_trace(log_dir: str, **kwargs):
    """Profile the block with `torch.profiler` (the CPU, and CUDA where a
    card is present) and write its Chrome trace to
    `log_dir/trace.<pid>.json` on exit. Yields the profiler, whose
    `key_averages()` gives time by kernel; `kwargs` go to
    `torch.profiler.profile`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import registry as _registry
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _registry.inc("obs.torchprof.trace")
    with profile(activities=activities, **kwargs) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace.{os.getpid()}.json"))
