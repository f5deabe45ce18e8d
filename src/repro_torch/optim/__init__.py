"""Optimizers of the port."""
from .adamw import (OptState, adamw_update, cosine_lr, global_norm,
                    init_opt_state)

__all__ = ["OptState", "adamw_update", "cosine_lr", "global_norm",
           "init_opt_state"]
