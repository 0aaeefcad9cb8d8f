"""Cross-silo FL: the paper's protocol over silos (port of
``repro/core/silo.py``).

Each silo is one FL "user": it holds a full replica of the model and its
own non-IID data shard. One FL round on the device is:

  1. every silo runs a local SGD step on its own batch
     (``torch.func.vmap(grad)`` over the silo axis, then the fused SGD
     step: ``kernels.ops.fused_sgd_leaves``, one launch for every leaf);
  2. every silo computes its Eq. 2 priority against the incoming global
     model (``core.priority.stacked_model_priorities``: the
     ``delta_norm`` kernel, one launch for every leaf);
  3. the HOST runs the CSMA contention with those priorities (Eq. 3 +
     counter) and hands back per-silo merge weights alpha_k (zero for
     the silos not selected);
  4. the merge  w <- w + sum_k alpha_k (w_k - w)  is the only traffic
     between silos; selection gates it as the paper gates airtime.

The reference's stacked layout is kept: a leaf's leading axis is the
silo. The replicas after a merge are one merged tensor expanded over
that axis (``Tensor.expand``, no copy), so they are bit-equal by
construction; a round's local step trains a fresh contiguous copy of
them and leaves the state it was given as it was. Multi-device placement
of the silo axis (the reference's pod mesh) is not ported: one device
holds every silo.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.client import sgd_epoch_scan
from repro_torch.core.priority import stacked_model_priorities
from repro_torch.models.model import compute_loss
from repro_torch.tree import tree_map


def stack_for_silos(params, n_silos: int):
    """Replicate a param pytree into (n_silos, ...) stacked form (views
    of ``params``: one tensor a leaf, expanded over the silo axis)."""
    return tree_map(
        lambda p: p.unsqueeze(0).expand((n_silos,) + tuple(p.shape)),
        params)


def make_silo_merge(merge_dtype: str = "float32"):
    """Returns ``merge_stacked(local_stacked, global_params, alphas)``:
    the selection-gated merge  w <- w + sum_k alpha_k (w_k - w),
    re-broadcast to stacked form. The deltas are taken in f32 and cast to
    ``merge_dtype``, the product over silos is in ``merge_dtype``, and
    the update is added to the global in f32 and cast back — the
    reference's order. ``merge_dtype="bfloat16"`` is the reference's
    beyond-paper lever (half the bytes between silos). Plain torch, as
    the reference's is a plain einsum outside any Pallas kernel."""
    mdt = getattr(torch, merge_dtype)

    def merge_stacked(local_stacked, global_params, alphas):
        a = alphas.float().to(mdt)

        def merge(wl, wg):
            delta = (wl.float() - wg.float()[None]).to(mdt)
            upd = torch.einsum("s,s...->...", a, delta)
            merged = (wg.float() + upd.float()).to(wl.dtype)
            return merged.unsqueeze(0).expand(wl.shape)

        return tree_map(merge, local_stacked, global_params)

    return merge_stacked


def make_fl_round_step(cfg, lr: float = 1e-2, long_context: bool = False,
                       do_merge: bool = True,
                       merge_dtype: str = "float32"):
    """Returns ``fl_round(stacked_params, batch, alphas) ->
    (per_silo_losses, new_stacked_params, priorities)``.

    ``per_silo_losses`` is the (S,) vector of each silo's own local loss.
    ``stacked_params``: (S, ...) pytree, silo-stacked (left as it was).
    ``batch``: ``{"tokens": (S, B, L+1), ...}`` silo-major.
    ``alphas``: (S,) f32 merge weights from the host-side CSMA contention
    — summing to 1 over the selected silos, 0 elsewhere.

    The local step's update ``(p.f32 - lr * g.f32).to(p.dtype)`` is the
    fused SGD step, on a fresh copy of the stack. ``do_merge=False``: a
    local-only round (the trained stack comes back unmerged).
    ``merge_dtype``: as in ``make_silo_merge``.
    """
    loss_fn = functools.partial(compute_loss, cfg=cfg,
                                long_context=long_context)
    local_step = sgd_epoch_scan(loss_fn, lr)
    merge_stacked = make_silo_merge(merge_dtype)

    def fl_round(stacked_params, batch, alphas):
        # (1) per-silo local training, one step on each silo's batch
        local = tree_map(lambda p: p.clone(
            memory_format=torch.contiguous_format), stacked_params)
        local, losses = local_step(local, tree_map(lambda a: a[:, None],
                                                   batch))
        # (2) Eq. 2 priority per silo against the global entering the
        #     round (the silo-0 replica: every replica is equal)
        global_params = tree_map(lambda p: p[0], stacked_params)
        priorities = stacked_model_priorities(local, global_params)
        if not do_merge:
            return losses[:, 0], local, priorities
        # (4) the selection-gated merge: the only traffic between silos
        return (losses[:, 0], merge_stacked(local, global_params, alphas),
                priorities)

    return fl_round


def silo_batch_struct(cfg, n_silos: int, batch: int, seq: int):
    """A silo round's batch on the ``meta`` device (shape and dtype)."""
    return {"tokens": torch.empty((n_silos, batch, seq + 1),
                                  dtype=torch.int32, device="meta")}
