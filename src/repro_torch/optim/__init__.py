"""Optimizers of the training path."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_schedule,
                                     opt_state_from_reference)
