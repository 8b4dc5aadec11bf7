"""Architecture configs (assigned pool + the paper's own experiment config)."""
from repro_torch.configs.registry import ASSIGNED, get_config, list_archs, smoke

__all__ = ["ASSIGNED", "get_config", "list_archs", "smoke"]
