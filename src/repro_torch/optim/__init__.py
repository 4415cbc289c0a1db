"""Optimizers of the training path."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_schedule,
                                     opt_state_from_reference)
from repro_torch.optim.quantized import (adamw8bit_update,
                                         init_opt_state_8bit,
                                         opt_state_8bit_from_reference)
