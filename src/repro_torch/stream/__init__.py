"""Streaming DSML: online sufficient-statistics estimation and serving.

The port's counterpart of the JAX package's `repro.stream`. The paper's
statistics `(Sigma, c)` are additive over samples, so the whole DSML
pipeline runs online: minibatches fold into a fixed-size `StreamState`
(optionally decayed or windowed), one `rank_update` launch a chunk on
the card, and `refit` re-runs Algorithm 1 from the state with warm
starts. `StreamingDsmlService` is the serving driver. The sharded
accumulator (`accumulate_stats_fn`, `accumulate_stats_sharded`,
`ingest_sharded`) runs the ingest over a data x task `DeviceMesh` on
`torch.distributed`, and the service takes it with `mesh=`.
"""
from repro_torch.stream.accumulate import (
    accumulate_stats_fn, accumulate_stats_sharded, ingest_sharded,
)
from repro_torch.stream.guard import IngestGuard, QuarantineRecord
from repro_torch.stream.health import RefitHealth, refit_health
from repro_torch.stream.refit import (
    RefitInfo, jaccard_support, refit, refit_logistic,
)
from repro_torch.stream.serve import (
    ModelGeneration, ServeResult, ServingFront, bucket_rows,
)
from repro_torch.stream.service import StreamingDsmlService
from repro_torch.stream.state import (
    StreamState, WindowState, ingest, ingest_stats, init_stream_state,
    init_window, merge, window_ingest, window_stats,
)

__all__ = [
    "accumulate_stats_fn", "accumulate_stats_sharded", "ingest_sharded",
    "IngestGuard", "QuarantineRecord",
    "RefitHealth", "refit_health",
    "RefitInfo", "jaccard_support", "refit", "refit_logistic",
    "ModelGeneration", "ServeResult", "ServingFront", "bucket_rows",
    "StreamingDsmlService",
    "StreamState", "WindowState", "ingest", "ingest_stats",
    "init_stream_state", "init_window", "merge", "window_ingest",
    "window_stats",
]
