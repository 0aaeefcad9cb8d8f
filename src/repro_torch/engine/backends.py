"""Execution backends — where the round's *learning* happens.

A Backend owns model state + per-user data and exposes three moves to
the engine:

    init_state(init_params)          -> opaque global state
    train_round(state, t, train_ids, need_priority) -> TrainResult
    merge(state, train_result, winners)             -> new state
    global_params(state)             -> params pytree (for eval)

One implementation so far:

  HostBackend  the paper's simulation, fused round path only: ONE
               device-resident step per round — ``local_epochs`` folded
               into the batch axis, every user's local SGD run over the
               stacked ``(U, ...)`` cohort (``fused_sgd`` kernel, one
               launch per leaf per step), Eq. 2 priorities from the
               trained stack (``delta_norm`` kernel, one launch per
               leaf), and the Eq. 1 merge a gather-K reduction in
               delivery order (``gather_combine`` kernel, one launch per
               leaf). The trained stack is overwritten IN PLACE with the
               merged global and stays on the device for the next round
               (the reference donates the buffer; this is the same
               saving said directly). Requires a rectangular cohort
               (equal per-user example counts) and a full-cohort round.

               The reference's other round paths (``stacked``,
               ``ragged``, ``sparse``), its sweep path, the AirComp and
               robust merges, non-plain objectives and cohort sharding
               are not ported yet; asking for one raises
               ``NotImplementedError`` naming it. Nothing downgrades
               silently.

Epoch batching stays on the host with each client's own rng stream, so
fixed seeds give the reference's winner sequences. Contention stays on
the host too (physical-medium simulation); backends never see the CSMA
layer.

Numerics: float32 throughout. TF32 is switched OFF for matmuls and for
cuDNN convolutions when this module is imported — the reference is
float32, and cuDNN would otherwise run the CNN's convolutions in TF32.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.client import Client, sgd_epoch_scan
from repro_torch.core.priority import stacked_model_priorities
from repro_torch.device import resolve_device
from repro_torch.engine.types import TrainResult
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def label_heterogeneity(user_data: Sequence, num_classes: int = 10,
                        label_key: str = "y") -> np.ndarray:
    """Per-user total-variation distance to the population label mix.

    Returns (num_users,) scores in [0, 1]; zeros when the data carries
    no labels (token streams, unlabeled pytrees). Consumed by
    heterogeneity-aware strategies via ``SelectionContext.heterogeneity``.
    """
    labels = []
    for d in user_data:
        y = d.get(label_key) if isinstance(d, dict) else None
        if y is None:
            return np.zeros(len(user_data))
        labels.append(np.asarray(y, np.int64).ravel())
    # width follows the data when labels exceed the declared class count
    width = max(num_classes,
                1 + max((int(y.max()) for y in labels if y.size),
                        default=0))
    hists = np.stack([np.bincount(y, minlength=width).astype(np.float64)
                      for y in labels])
    rows = hists.sum(axis=1, keepdims=True)
    probs = hists / np.maximum(rows, 1.0)
    pop = hists.sum(axis=0) / max(hists.sum(), 1.0)
    tv = 0.5 * np.abs(probs - pop[None]).sum(axis=1)
    # a zero-example user has an all-zero probs row, which would score
    # TV 0.5 against any population mix — maximal apparent divergence
    # from NO evidence. Score empty users 0.0 instead.
    return np.where(rows[:, 0] > 0, tv, 0.0)


def compact_weights(k_pad: int, positions: Sequence[int],
                    sizes: Sequence[float]):
    """(idx, w) inputs of ``kernels.ops.gather_combine``: (k_pad,) int32
    row indices and (k_pad,) f32 Eq. 1 merge weights, delivery-ordered
    and zero-padded.

    The weight math mirrors ``core.server.winner_alphas`` exactly
    (float64 |D_k| normalization, then one cast), so the compact and
    dense-masked formulations feed bit-identical per-row weights. Pad
    rows carry index 0 and EXACT-zero weight — the masked reduce drops
    them, and appending exact +0.0 terms leaves an f32 sum's bits
    unchanged, so the pad width never leaks into the merged global.
    """
    idx = np.zeros(k_pad, np.int32)
    w = np.zeros(k_pad, np.float32)
    m = len(positions)
    if m:
        idx[:m] = positions
        s = np.asarray(sizes, np.float64)
        w[:m] = (s / s.sum()).astype(np.float32)
    return idx, w


class Backend:
    """Contract only — see module docstring. Subclasses must set
    ``num_users`` and ``heterogeneity`` ((num_users,) in [0,1])."""
    num_users: int
    heterogeneity: np.ndarray

    def init_state(self, init_params):
        raise NotImplementedError

    def train_round(self, state, t: int, train_ids: List[int],
                    need_priority: bool) -> TrainResult:
        raise NotImplementedError

    def merge(self, state, train_result: TrainResult, winners: List[int],
              merge_ctx=None, fault_ctx=None, attempts=None):
        """Eq. 1 over ``winners``. ``merge_ctx`` / ``fault_ctx`` are the
        reference's AirComp and robust-merge contexts — backends that
        don't implement one must reject it non-None. ``attempts`` is the
        round's attempt winner list (consumed only by h-carrying
        objectives; backends without objective support ignore it)."""
        raise NotImplementedError

    def global_params(self, state):
        return state

    def num_examples(self, u: int) -> int:
        raise NotImplementedError

    # ---- checkpoint hooks --------------------------------------------
    def client_stream_states(self):
        """Per-client rng snapshots for checkpoint/resume, or None when
        the backend owns no client streams."""
        return None

    def restore_client_streams(self, states) -> None:
        if states is None:
            return
        raise NotImplementedError(
            f"{type(self).__name__} has no client streams to restore")

    # ---- optional contracts: the engine asks before it relies on one -
    def sweep_capable(self) -> bool:
        return False

    def sparse_capable(self) -> bool:
        return False

    def objective_active(self) -> bool:
        """True when the backend was built with a non-plain objective."""
        return False

    def objective_needs_h(self) -> bool:
        """True when merges must run on h-carrying rounds even without
        deliveries (feddyn)."""
        return False


class HostBackend(Backend):
    """Paper-scale simulation over host data, fused round path (see the
    module docstring).

    ``round_mode``: ``None`` or ``"fused"``; the reference's
    ``"stacked"``, ``"ragged"`` and ``"sparse"`` raise
    ``NotImplementedError``.
    ``k_max``: the round's winner budget (the spec's ``k_per_round``) —
    the compact merge pad width.
    ``device``: where the cohort lives. ``None`` is the CUDA device and
    raises without one; only an explicit ``"cpu"`` runs on the CPU.
    """

    def __init__(self, loss_fn, user_data: Sequence, *, lr: float = 1e-2,
                 batch_size: int = 32, local_epochs: int = 1, seed: int = 0,
                 num_classes: int = 10,
                 round_mode: Optional[str] = None, mesh=None,
                 k_max: Optional[int] = None, objective=None, device=None):
        if round_mode is None:
            round_mode = "fused"
        if round_mode not in ("fused", "stacked", "ragged", "sparse"):
            raise ValueError(f"unknown round_mode {round_mode!r}")
        if round_mode != "fused":
            raise NotImplementedError(
                f"round_mode={round_mode!r} is not ported yet: only the "
                "fused round path is (pass round_mode='fused')")
        if mesh is not None:
            raise NotImplementedError(
                "mesh: sharding the cohort over devices is not ported yet")
        if objective is not None and not objective.is_plain:
            raise NotImplementedError(
                "objective: non-plain objectives (fedprox / feddyn / "
                "fedavgm / fedadam) are not ported yet")
        self.device = resolve_device(device)
        self.num_users = len(user_data)
        self.heterogeneity = label_heterogeneity(user_data, num_classes)
        self.seed = seed                     # the clients' stream seed
        # Clients carry the per-user data, example counts and rng streams
        self.clients = [
            Client(u, user_data[u], loss_fn, lr=lr, batch_size=batch_size,
                   local_epochs=local_epochs, seed=seed)
            for u in range(self.num_users)
        ]
        self._batch_size = batch_size
        self._local_epochs = local_epochs
        self._k_max = int(k_max) if k_max else None
        self._epoch_run = sgd_epoch_scan(loss_fn, lr)

        ns = {c.num_examples for c in self.clients}
        self._rect = (len(ns) == 1
                      and batch_size <= self.clients[0].num_examples)
        if not self._rect:
            raise NotImplementedError(
                "uneven cohort (per-user example counts differ, or fall "
                "below batch_size): it needs round_mode='ragged', which "
                "is not ported yet")
        self._xstack = None        # (U, n, ...) user data, on the device
        self._resident = None      # device-resident merged cohort stack
        self._resident_key = None  # the global-state object it mirrors

    # ------------------------------------------------------------------
    def init_state(self, init_params):
        """The global state: ``init_params`` on this backend's device
        (the caller's tensors themselves when they already lie there —
        nothing in the backend ever writes into the global state)."""
        return tree_map(
            lambda p: torch.as_tensor(p).detach().to(self.device),
            init_params)

    def num_examples(self, u):
        return self.clients[u].num_examples

    def _can_fuse(self, train_ids) -> bool:
        return self._rect and len(train_ids) == self.num_users

    # ------------------------------------------------- fused round path
    def _ensure_xstack(self):
        """Stack the rectangular per-user data to (U, n, ...) ON THE
        DEVICE, once: per round only the host-drawn index matrix is
        uploaded, not the batches."""
        if self._xstack is not None:
            return
        self._nb = max(1, self.clients[0].num_examples // self._batch_size)
        self._xstack = tree_map(
            lambda *xs: torch.from_numpy(
                np.stack([np.asarray(x) for x in xs])).to(self.device),
            *[c.data for c in self.clients])

    def _bcast(self, state):
        """A fresh contiguous (U, ...) stack of the global — never a
        view of ``state``, which training must not overwrite."""
        U = self.num_users
        return tree_map(
            lambda p: p.unsqueeze(0).expand((U,) + tuple(p.shape))
            .contiguous(), state)

    def _fused_merge(self, trained, idx, w, old_glob):
        """The ONE Eq. 1 merge of the digital path: gather the ``idx``
        rows out of the trained stack, reduce them under the compact
        weights in delivery order, keep ``old_glob`` when no weight is
        nonzero. ``old_glob`` is only read — on round 0 it may still be
        the caller's init_params. The new global is a fresh tensor per
        leaf; the trained stack's buffer is then overwritten with its
        broadcast and becomes next round's resident stack."""
        with torch.no_grad():
            new_glob = tree_map(
                lambda l, g: kops.gather_combine(l, idx, w, g),
                trained, old_glob)
            new_stack = tree_map(
                lambda g, l: l.copy_(g.unsqueeze(0).expand_as(l)),
                new_glob, trained)
        return new_glob, new_stack

    def _draw_big(self):
        """(U, ep*take) epoch-permutation index matrix for ONE round:
        every client draws one permutation per local epoch from ITS OWN
        rng stream, on the host, client by client and epoch by epoch,
        laid out with each user's epochs concatenated."""
        U, bs, nb, E = (self.num_users, self._batch_size, self._nb,
                        self._local_epochs)
        n = self.clients[0].num_examples
        take = nb * bs
        perms = np.empty((E, U, take), np.int64)
        for e in range(E):
            for c in self.clients:
                perms[e, c.uid] = c._rng.permutation(n)[:take]
        return perms.transpose(1, 0, 2).reshape(U, E * take)

    def _gather_rows(self, rows, big_rows):
        """(R, ep*nb, bs, ...) round batches for the data rows ``rows``
        (user ids) under the per-row index matrix ``big_rows``
        ((R, ep*take) slice of ``_draw_big``'s output): one device-side
        fancy-index over the pre-stacked data."""
        R = len(rows)
        bs, nb, E = self._batch_size, self._nb, self._local_epochs
        r = torch.as_tensor(np.asarray(rows, np.int64),
                            device=self.device)[:, None]
        big = torch.from_numpy(np.ascontiguousarray(big_rows)).to(self.device)
        return tree_map(
            lambda leaf: leaf[r, big].reshape(
                (R, E * nb, bs) + tuple(leaf.shape[2:])),
            self._xstack)

    def _fused_batches(self):
        """(U, E*nb, bs, ...) full-cohort round batches."""
        big = self._draw_big()
        return self._gather_rows(np.arange(self.num_users), big)

    def _train_round_fused(self, state, need_priority) -> TrainResult:
        self._ensure_xstack()
        if self._resident is not None and self._resident_key is state:
            stack = self._resident          # device-resident since merge
        else:
            stack = self._bcast(state)      # first round / unmerged round
        # the stack buffer is trained in place below
        self._resident = self._resident_key = None
        # Every row of `stack` equals the global at round start, so
        # `state` is the Eq. 2 reference. The reference package slices
        # row 0 of the stack, a value there; here that would be a view
        # of the buffer the SGD kernel is about to overwrite. `state`
        # never aliases the stack (`_bcast` and the merge both produce
        # fresh tensors), so it is used as is.
        trained, losses = self._epoch_run(stack, self._fused_batches())
        # per-user loss = mean over the LAST epoch's batches
        loss_u = losses[:, -self._nb:].mean(dim=1)
        if need_priority:
            prios = stacked_model_priorities(trained, state)
            # priorities leave the device as f32, widened on the host
            priorities = prios.cpu().numpy().astype(np.float64)
        else:
            priorities = np.ones(self.num_users)
        return TrainResult(
            losses=loss_u.cpu().numpy().astype(np.float64),
            priorities=priorities,
            local_handle={"fused_stack": trained})

    # ------------------------------------------------------------------
    def train_round(self, state, t, train_ids, need_priority):
        if not train_ids:
            return TrainResult(losses={},
                               priorities=np.ones(self.num_users),
                               local_handle={})
        if not self._can_fuse(train_ids):
            raise NotImplementedError(
                "partial-cohort round: it needs round_mode='stacked' / "
                "'ragged', which are not ported yet")
        return self._train_round_fused(state, need_priority)

    def extract_local(self, train_result, u):
        """User u's trained params as freshly materialized tensors, safe
        to hold across the merge (which overwrites the trained stack)."""
        stack = train_result.local_handle["fused_stack"]
        return tree_map(lambda p: p[u].clone(), stack)

    def _k_pad(self, m: int) -> int:
        """Compact merge width: ``k_max`` when set (so every round's
        merge pads identically), else the delivery count itself."""
        if self._k_max and m <= self._k_max:
            return self._k_max
        return max(m, 1)

    def merge(self, state, train_result, winners, merge_ctx=None,
              fault_ctx=None, attempts=None):
        if merge_ctx is not None:
            raise NotImplementedError(
                "merge_ctx: the AirComp merge is not ported yet")
        if fault_ctx is not None:
            raise NotImplementedError(
                "fault_ctx: the robust merge is not ported yet")
        handle = train_result.local_handle
        trained = handle.get("fused_stack") \
            if isinstance(handle, dict) else None
        if trained is None:
            raise ValueError(
                "merge needs the fused train handle of this round (each "
                "handle merges once: its stack is overwritten)")
        winners = [int(u) for u in winners]
        idx, w = compact_weights(
            self._k_pad(len(winners)), winners,
            [self.clients[u].num_examples for u in winners])
        if idx.size and idx.max() >= self.num_users:
            raise IndexError(f"winner id {int(idx.max())} out of range")
        # one upload of the host-assembled (k_pad,) vectors per merge
        new_glob, new_stack = self._fused_merge(
            trained, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(w).to(self.device), state)
        handle["fused_stack"] = None     # buffer reused as the new stack
        self._resident = new_stack       # stays on device for round t+1
        self._resident_key = new_glob
        return new_glob

    # ---- checkpoint hooks --------------------------------------------
    def client_stream_states(self):
        return [copy.deepcopy(c._rng.bit_generator.state)
                for c in self.clients]

    def restore_client_streams(self, states) -> None:
        if states is None:
            return
        for c, s in zip(self.clients, states):
            c._rng.bit_generator.state = s
