"""Test-support utilities shipped inside the package.

`repro_torch.testing.faults` is the deterministic fault-injection
harness for the streaming service (poisoned chunks, refit divergence,
torn checkpoints); `repro_torch.testing.interleave` is the
deterministic thread-interleaving harness for its serving front;
`repro_torch.testing.collectives.count_collectives` counts the
`torch.distributed` calls a rank makes. All live in the package so that deployments can chaos-test and race-test
their own services.
"""
from repro_torch.testing.collectives import count_collectives
from repro_torch.testing.faults import (
    FaultEvent, FaultSchedule, DivergenceInjector, apply_batch_fault,
    build_schedule, make_clean_batch, truncate_file,
)
from repro_torch.testing.interleave import (
    Gates, InterleaveScheduler, instrument,
)

__all__ = [
    "count_collectives",
    "FaultEvent", "FaultSchedule", "DivergenceInjector",
    "apply_batch_fault", "build_schedule", "make_clean_batch",
    "truncate_file",
    "Gates", "InterleaveScheduler", "instrument",
]
