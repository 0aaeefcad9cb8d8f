"""Robust Eq. 1 merge — the fault layer's guard pass.

``robust_merge`` extends the plain masked FedAvg with three moves:

  1. per-row corruption factors ``c_k`` and delta-norm clip scales are
     folded into one shrink factor ``s_k``, applied in delta space:
     ``row' = g + s_k · (row − g)`` (``kernels/ops.robust_combine``;
     ``s_k == 1`` is an exact bit-level passthrough);
  2. quarantine: rows whose (scaled) delta normsq is non-finite are
     masked out of the weight vector, and the surviving mass is
     renormalized by ``f = Σw_requested / Σw_surviving`` — exactly 1.0
     when nothing was quarantined (x/x is exact in IEEE-754), so a
     clean round is bit-identical to the plain merge;
  3. the zero-alpha-row guard extends to the all-quarantined case: when
     NO mass survives (winnerless round, every update quarantined, or
     λ = 0 stale-only), the old global is kept.

Everything runs on the tensors' device with no host sync; the caller
reads the quarantine count (one sync a merge). Bit-transparency
contract: with clean rows, all-ones scales and no stale group, each
leaf is ``gather_combine``'s sum over the same rows in the same order,
times an exact 1.0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class FaultMergeContext:
    """Per-merge robust-guard inputs the engine hands the backend
    (the fault twin of ``repro_torch.channel.MergeContext``).

    ``weights``: dense (U,) f32 fresh merge weights from
    ``fault_alphas`` (zero at non-candidates); ``corrupt``: (U,) f32
    per-user delta corruption factors (1 = clean); ``stale``: last
    round's buffered stragglers as ``(params pytree, f32 weight)``
    pairs. ``quarantine``/``clip_norm`` come from the spec. After the
    merge the backend writes ``n_quarantined`` back for the engine's
    history accounting.
    """
    weights: np.ndarray
    corrupt: np.ndarray
    quarantine: bool
    clip_norm: float
    stale: List[Tuple[Any, float]] = field(default_factory=list)
    n_quarantined: int = 0


def row_delta_normsq(stack, glob):
    """(K,) f32 ``Σ_leaves ||row_k − g||²`` over a stacked pytree: one
    ``delta_norm_leaves`` call over every leaf's (K, ...) rows, the
    per-leaf sums added in leaf order."""
    d2, _ = kops.delta_norm_leaves(tree_leaves(stack), tree_leaves(glob))
    tot = d2[0]
    for leaf_d2 in d2[1:]:
        tot = tot + leaf_d2
    return tot


def robust_merge(trained, weights, corrupt, glob, stale=None,
                 stale_weights=None, *, quarantine: bool = True,
                 clip_norm: float = 0.0):
    """Guarded Eq. 1 over a fresh group and an optional stale group.

    trained: (K, ...) stacked pytree of fresh merge candidates, or None
      (stale-only merge); ``weights``: (K,) f32 merge weights already
      normalized on host over the JOINT fresh+stale mass (zero rows are
      non-candidates); ``corrupt``: (K,) f32 per-row delta corruption
      factors (1 = clean) or None; ``glob``: the old global pytree;
      ``stale``/``stale_weights``: (M, ...) stacked stale updates and
      their λ-discounted normalized weights.

    Returns ``(new_glob, n_quarantined)`` — a fresh pytree (never a view
    of ``glob``) and the int32 device count of positive-weight rows
    masked by the quarantine.
    """
    dev = tree_leaves(glob)[0].device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    groups = []
    if trained is not None:
        groups.append((trained, f32(weights),
                       None if corrupt is None else f32(corrupt)))
    if stale is not None:
        groups.append((stale, f32(stale_weights), None))
    if not groups:
        raise ValueError("robust_merge needs at least one group")

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    z_req, z_eff = zero, zero
    n_quar = torch.zeros((), dtype=torch.int32, device=dev)
    prepared = []          # (stack, eff_weights, row_scales)
    for stack, w, c in groups:
        nf = row_delta_normsq(stack, glob)
        if c is not None:
            nf = nf * (c * c)
        if clip_norm > 0:
            clip = torch.tensor(clip_norm, dtype=torch.float32, device=dev)
            # NaN/Inf normsq rows compare False -> scale 1; quarantine
            # (not clipping) is what removes them
            s_clip = torch.where(nf > clip * clip, clip / torch.sqrt(nf),
                                 one)
        else:
            s_clip = torch.ones_like(nf)
        scale = s_clip if c is None else c * s_clip
        if quarantine:
            finite = torch.isfinite(nf)
            eff = torch.where(finite, w, zero)
            n_quar = n_quar + ((w > 0) & ~finite).sum(dtype=torch.int32)
        else:
            eff = w
        z_req = z_req + w.sum()
        z_eff = z_eff + eff.sum()
        prepared.append((stack, eff, scale))

    has = z_eff > 0.0
    # exact 1.0 when nothing was quarantined: z_req and z_eff are then
    # the same f32 sum of the same values, and x/x == 1.0 in IEEE-754
    f = torch.where(has, z_req / torch.where(has, z_eff, one), one)

    def merge_leaf(g, *stack_leaves):
        acc = None
        for (_, eff, scale), leaf in zip(prepared, stack_leaves):
            term = kops.robust_combine(leaf, eff, scale, g)
            acc = term if acc is None else acc + term
        return torch.where(has, f * acc.float(), g.float()).to(g.dtype)

    new_glob = tree_map(merge_leaf, glob, *[p[0] for p in prepared])
    return new_glob, n_quar


def fault_alphas(num_users: int, merged_now, sizes, stale_sizes,
                 staleness_discount: float):
    """Host-side joint Eq. 1 weights over fresh + stale candidates.

    Fresh candidate k contributes mass ``|D_k|``, stale candidate m
    mass ``λ · |D_m|``; both are normalized over the joint total in
    float64 and cast to f32 — with no stale entries this is EXACTLY
    ``core.server.winner_alphas`` (same math, bit-transparency
    contract). λ only discounts stale updates *relative to* fresh
    ones: a stale-only round still merges at full mass (its shares
    normalize to 1), unless λ = 0 which drops stale updates entirely.

    Returns ``(dense (num_users,) f32 fresh weights, (M,) f32 stale
    weights)``.
    """
    fresh = np.asarray([float(s) for s in sizes], np.float64)
    stale = staleness_discount * np.asarray(
        [float(s) for s in stale_sizes], np.float64)
    z = fresh.sum() + stale.sum()
    raw = np.zeros(num_users, np.float32)
    if z <= 0:
        return raw, np.zeros(len(stale), np.float32)
    if len(merged_now):
        raw[[int(u) for u in merged_now]] = (fresh / z).astype(np.float32)
    return raw, (stale / z).astype(np.float32)
