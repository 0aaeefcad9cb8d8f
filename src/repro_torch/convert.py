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


#: leaves kept in f32 whatever ``dtype`` a conversion asks for: the MoE
#: router is f32 whatever the param dtype (as ``init_moe`` draws it)
F32_LEAVES = ("router",)


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (``None`` = the CUDA device), cast to ``dtype`` when one
    is given (``F32_LEAVES`` stay f32). Each leaf is copied, so the
    result never aliases the caller's arrays."""
    dev = resolve_device(device)

    def convert(node, name=None):
        if isinstance(node, dict):
            return {k: convert(node[k], k) for k in sorted(node)}
        t = torch.from_numpy(np.array(node, copy=True))
        if dtype is not None and name not in F32_LEAVES:
            return t.to(device=dev, dtype=dtype)
        return t.to(dev)

    return convert(tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (bf16
    leaves widen to f32: numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return tree_map(leaf, tree)
