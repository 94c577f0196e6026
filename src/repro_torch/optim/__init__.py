"""Optimizers: AdamW with a cosine schedule and int8 moments."""
from repro_torch.optim.adamw import (Moment, OptConfig, adamw_update,
                                     cosine_lr, global_norm, init_opt_state)

__all__ = ["Moment", "OptConfig", "adamw_update", "cosine_lr", "global_norm",
           "init_opt_state"]
