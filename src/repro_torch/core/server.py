"""FL server: FedAvg aggregation (paper Eq. 1).

Aggregates the first-K_t arrivals' local models weighted by local
dataset size:

    w^{t+1} = sum_k |D_k| w_k^t / sum_k |D_k|

The per-leaf weighted sum is the ``fedavg_combine`` CUDA kernel for
tensors on the GPU (one pass over K stacked models), the plain version
on the CPU.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map


def _alphas(data_sizes) -> np.ndarray:
    # float64 |D_k| normalization, then ONE cast
    w = np.asarray(data_sizes, np.float64)
    return (w / w.sum()).astype(np.float32)


def fedavg(models: Sequence, data_sizes: Sequence[float]):
    """Weighted average of K param pytrees. Eq. (1)."""
    if not models or len(models) != len(data_sizes):
        raise ValueError("fedavg needs one data size per model (K >= 1)")
    alphas = _alphas(data_sizes)
    with torch.no_grad():
        return tree_map(
            lambda *leaves: kops.fedavg_combine(torch.stack(leaves), alphas),
            *models)


def winner_alphas(num_users: int, winners: Sequence[int],
                  data_sizes: Sequence[float]) -> np.ndarray:
    """Dense (num_users,) f32 merge-weight vector for a masked Eq. (1):
    normalized |D_k| shares at the winners' indices, exact zero
    elsewhere. One definition shared by the host and silo merges."""
    sizes = np.asarray(data_sizes, np.float64)
    alphas = np.zeros(num_users, np.float32)
    alphas[list(winners)] = (sizes / sizes.sum()).astype(np.float32)
    return alphas


def fedavg_masked(stacked_params, alphas):
    """Eq. (1) as a masked reduction over the FULL cohort stack.

    ``stacked_params``: (U, ...) pytree holding every user's local model;
    ``alphas``: (U,) f32 merge weights — normalized |D_k| shares for the
    round's winners, exactly zero elsewhere. Equivalent to ``fedavg``
    over the winners' gathered models (summed in index order), with no
    per-winner gather / restack.
    """
    with torch.no_grad():
        return tree_map(lambda leaf: kops.fedavg_combine(leaf, alphas),
                        stacked_params)


def fedavg_delta(global_params, deltas: Sequence, data_sizes):
    """Delta form: w + sum_k alpha_k (w_k - w). Equivalent to Eq. (1) when
    every delta is (w_k - w)."""
    alphas = _alphas(data_sizes)

    def combine(g, *ds):
        upd = kops.fedavg_combine(torch.stack(ds), alphas)
        return (g.float() + upd.float()).to(g.dtype)

    with torch.no_grad():
        return tree_map(combine, global_params, *deltas)
