from .adamw import OptimizerConfig, adamw_init, adamw_update, global_norm
from .schedule import lr_at_step

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_at_step"]
