"""Pytree optimizers of the port (plain nested dicts of tensors)."""
from repro_torch.optim.sgd import sgd_update, sgd_momentum_init, \
    sgd_momentum_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import constant_lr, cosine_lr, \
    warmup_cosine_lr
