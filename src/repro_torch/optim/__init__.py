"""Pytree optimizers of the port (plain nested dicts of tensors)."""
from repro_torch.optim.sgd import sgd_update
