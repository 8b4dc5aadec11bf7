"""repro_torch.obs — process-local runtime telemetry.

The port's own copy of the JAX package's `repro.obs` (the port imports
nothing of that package): the same counter, gauge, histogram and span
names, the same `REPRO_OBS` switch. Usage from library code:

    from repro_torch import obs
    obs.inc("stream.ingest.chunks")
    with obs.span("stream.refit"):
        ...

Disable with `REPRO_OBS=0` in the environment (checked once at
import). Export helpers live in `repro_torch.obs.export`; summarize a
saved snapshot with `python -m repro_torch.obs SNAPSHOT.json`; trace the
card with `repro_torch.obs.torchprof.profiler_trace`.
"""
from .registry import (  # noqa: F401
    HIST_SAMPLE_CAP,
    MAX_TRACE_EVENTS,
    Registry,
    counter_total,
    enabled,
    get_registry,
    hist_quantiles,
    hist_stats,
    inc,
    observe,
    reset,
    set_gauge,
    span,
)
from .export import (  # noqa: F401
    chrome_trace,
    load_snapshot,
    snapshot,
    summarize,
    to_prometheus,
    write_chrome_trace,
    write_snapshot,
)
