"""Parameter pytrees between the two packages, by way of numpy.

The JAX package's parameter pytree — handed over as nested dicts of
numpy arrays — becomes the port's nested dict of tensors and back,
leaf for leaf with no transposition: the port keeps the reference's
layouts at its public functions (dense weights ``(in, out)``, conv
weights HWIO, inputs NHWC), so the two trees mean the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (``None`` = the CUDA device). Each leaf is copied, so
    the result never aliases the caller's arrays."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=dev, dtype=dtype) if dtype is not None \
            else t.to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (bf16
    leaves widen to f32: numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return tree_map(leaf, tree)
