"""Backbone model zoo (the JAX package's `repro.models`)."""
from repro_torch.models.backbone import (
    forward_features,
    Batch,
    forward_decode,
    forward_prefill,
    forward_train,
    init_caches,
    init_params,
    stack_plan,
)
from repro_torch.models.config import (
    ModelConfig,
    MoeConfig,
    RglruConfig,
    SsdConfig,
)

__all__ = [
    "Batch", "forward_decode", "forward_features", "forward_prefill", "forward_train",
    "init_caches", "init_params", "stack_plan",
    "ModelConfig", "MoeConfig", "RglruConfig", "SsdConfig",
]
