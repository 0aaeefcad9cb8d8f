"""Parameter pytrees to ``.npz`` and back, in the reference's file format.

Each leaf of a nested dict of tensors becomes one array of the archive
under the '/'-joined keys of its path — the key strings the reference
writer builds from ``jax.tree_util`` key paths (each dict key rendered
as ``[<repr of the key>]``, then stripped of ``[``, ``]``, ``'`` and
``.``), so either package loads the other's files. A bfloat16 leaf is
stored as the reference stores it: its raw 16-bit patterns as a ``<V2``
array (numpy has no bfloat16).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.tree import tree_unflatten


def _key(k) -> str:
    return re.sub(r"[\[\]'\.]", "", f"[{k!r}]")


def _paths(tree, prefix=()):
    """(path key string, leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_paths(tree[k], prefix + (_key(k),)))
        return out
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, params, extra: Dict[str, Any] | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(leaf) for k, leaf in _paths(params)}
    if extra:
        for k, v in extra.items():
            flat[f"__extra__/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def load_checkpoint(path: str, params_template):
    """Restores into the template's tree structure, dtypes and devices:
    each array is cast to its template leaf's dtype (a ``<V2`` array is
    read as bfloat16 bits)."""
    with np.load(path) as z:
        leaves = []
        for k, t in _paths(params_template):
            if k not in z:
                raise KeyError(f"checkpoint missing key {k!r}")
            a = z[k]
            if a.dtype == np.dtype("V2"):
                x = torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                x = torch.from_numpy(np.array(a, copy=True))
            leaves.append(x.to(device=t.device, dtype=t.dtype))
    return tree_unflatten(params_template, leaves)


def load_extra(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith("__extra__/")}
