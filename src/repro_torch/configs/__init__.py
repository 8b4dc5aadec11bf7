"""Architecture configs (assigned pool + the paper's own experiment config)."""
from repro_torch.configs.registry import (
    ASSIGNED, PORT_ONLY, expert_share, get_config, list_archs, smoke,
)

__all__ = ["ASSIGNED", "PORT_ONLY", "expert_share", "get_config",
           "list_archs", "smoke"]
