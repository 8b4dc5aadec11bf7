"""DSML as a framework feature: shared-support multi-task probes (the
port's counterpart of the JAX package's `repro.multitask`)."""
from repro_torch.multitask.sparse_probe import (
    ProbeData,
    default_threshold,
    lasso_probe_sweep,
    pool_features,
    probe_predict,
    sparse_probe_fit,
    standardize,
    synthetic_probe_tasks,
)

__all__ = ["ProbeData", "default_threshold", "lasso_probe_sweep", "pool_features",
           "probe_predict", "sparse_probe_fit", "standardize",
           "synthetic_probe_tasks"]
