"""Execution backends — where the round's *learning* happens.

A Backend owns model state + per-user data and exposes three moves to
the engine:

    init_state(init_params)          -> opaque global state
    train_round(state, t, train_ids, need_priority) -> TrainResult
    merge(state, train_result, winners)             -> new state
    global_params(state)             -> params pytree (for eval)

Two implementations:

  HostBackend  the paper's simulation. Three round paths, the fastest
               that applies wins, and the sweep over the first:

               fused    (default) ONE device-resident step per round —
                        ``local_epochs`` folded into the batch axis,
                        every user's local SGD run over the stacked
                        ``(U, ...)`` cohort (``fused_sgd`` kernel, one
                        launch per step for every leaf), Eq. 2
                        priorities from the trained stack (``delta_norm``
                        kernel, one launch for every leaf), and ONE Eq. 1
                        merge a round in delivery order, one launch per
                        leaf, in one of four forms:

                 * digital (no context): a gather-K reduction
                   (``gather_combine``);
                 * objective (a non-plain ``ObjectiveSpec``): the same
                   reduction, then the FedAvgM / FedAdam server step on
                   the pseudo-gradient (``server_opt_leaves``, one launch
                   for every leaf, skipped on a merge with no delivered
                   weight), then the FedDyn h update over the round's
                   attempt winners; the local step runs the FedProx /
                   FedDyn gradient law
                   (``objectives.local.objective_epoch_scan``);
                 * AirComp (``merge_ctx``, the channel layer's
                   over-the-air merge): the same reduction under the
                   power-control coefficients, plus a receiver-noise
                   plane drawn on the device, times the rescale
                   (``aircomp_combine``);
                 * robust (``fault_ctx``, the fault layer's guard): the
                   candidates' rows gathered once, their delta norms
                   (``delta_norm``, one launch for every leaf of a group),
                   then the quarantine / clip / shrink
                   merge of ``faults.robust.robust_merge``
                   (``robust_combine``, once per leaf for the fresh group
                   and once more for a stale group).

                        The trained stack is overwritten IN PLACE with
                        the merged global and stays on the device for the
                        next round (the reference donates the buffer;
                        this is the same saving said directly). Requires
                        a rectangular cohort (equal per-user example
                        counts) and a full-cohort round.
               stacked  per-epoch training of the ``(S, ...)`` stack of
                        the round's S = ``len(train_ids)`` users (the same
                        ``sgd_epoch_scan``, one ``fused_sgd`` launch a
                        step), one ``delta_norm`` launch for the round's
                        priorities, and a gather merge over the winners'
                        rows. Used for partial-cohort rounds
                        (``trains_before_selection`` strategies) and when
                        asked for; needs every trained user to have the
                        same batch count.
               ragged   per-user training (``Client.train``: U = 1
                        launches), one ``delta_norm`` launch a user, and
                        the gather merge over the stacked winners — when
                        batch counts differ and nothing stacks, for a
                        one-user round, or when asked for.

               The gather merge (stacked / ragged handles) has the fused
               merge's four forms: digital ``gather_combine`` (on a
               stacked handle straight out of the trained stack at the
               winners' rows, bit-equal to the reference's restack),
               AirComp ``aircomp_combine`` over the stacked winners, and
               the robust merge over the stacked winners (also the
               stale-only round with no fresh winner). Objectives run in
               the fused round only, as in the reference.

               sparse   winner-sparse rounds (``sparse_*``): Eq. 2
                        priorities come BEFORE selection
                        (``sparse_priorities``: the exact chunked
                        train-and-discard prepass over (C, ...) broadcasts
                        of the global, one host read a chunk, or the
                        ``stale`` cache of each user's last-trained
                        priority), contention runs over the whole cohort,
                        and only the K winners train, as one compact
                        (K_max, ...) stack (``sparse_train``; pad rows at
                        index 0 with zero weight). The merge is the fused
                        merge in all four forms over that stack, indexed
                        by delivery POSITION; the AirComp coefficients,
                        the robust weights and the FedDyn h rows are read
                        by user id. Train FLOPs and memory a round scale
                        with K; with ``prepass`` the winners, priorities
                        and globals are the fused path's bits.

               sweep    (``sweep_*``) E independent experiments over the
                        fused path's cohort: the (E, U, ...) stack trains
                        as E * U rows of the same loop (one ``fused_sgd``
                        launch a step for every lane, each lane's
                        objective law on its own rows), Eq. 2 for every
                        lane in one ``delta_norm`` call over the E x L
                        leaf list, then each lane's merge through the
                        fused merges above, on its (U, ...) view of the
                        stack. ``FLEngine.run`` on the fused path is its
                        E = 1 case. Its sparse twin (``sweep_sparse_*``)
                        trains the (E, K_max, ...) winner stack as
                        E * K_max rows and merges each lane on its
                        (K_max, ...) view.

               cohort split (``mesh``, a ``sharding.cohort_mesh``):
                        where the reference shards its cohort axis (the
                        ``sharding/cohort.py`` predicates: a ``"cohort"``
                        axis of size D > 1 that divides U, the sparse
                        path's K_max, or a sweep's E or U), the stack is
                        D contiguous chunks, chunk i on the mesh's i-th
                        device (made the current CUDA device for its
                        work), each trained and reduced by Eq. 2 with
                        the same kernels (one launch a chunk); a merge
                        copies the rows it reads onto the backend's
                        device in delivery order and runs there as
                        above, and the new global goes back to every
                        chunk. Under a split of the fused or sparse
                        stack each user's data lives on its chunk's
                        device. The paths read every stack as chunks
                        (``chunks_of``): an unsplit stack is one chunk,
                        so one code path serves both. A row's result
                        does not depend on the rows beside it, so a
                        split run is bit-equal to the unsplit run. Where
                        the reference runs unsplit (no mesh, a 1-long
                        axis, no cohort axis, a count the axis does not
                        divide) so does this.

  SiloBackend  the cross-silo path (``core/silo.py``): one FL user a
               silo, every silo's local step in one ``vmap`` (the
               ``fused_sgd`` and ``delta_norm`` kernels), and the
               selection-gated merge  w <- w + sum_k alpha_k (w_k - w)
               over the trained stack. The silo replicas are one merged
               tensor expanded over the silo axis.

Epoch batching stays on the host with each client's own rng stream, so
fixed seeds give the reference's winner sequences. Contention stays on
the host too (physical-medium simulation); backends never see the CSMA
layer.

Numerics: float32 throughout. TF32 is switched OFF for matmuls and for
cuDNN convolutions when this module is imported — the reference is
float32, and cuDNN would otherwise run the CNN's convolutions in TF32.
"""
from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.client import Client, batch_epoch, sgd_epoch_scan
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.priority import (model_priority, priority_product,
                                       stacked_model_priorities)
from repro_torch.core.rngs import client_rng
from repro_torch.core.server import winner_alphas
from repro_torch.device import resolve_device
from repro_torch.engine.types import TrainResult
from repro_torch.faults.robust import robust_merge
from repro_torch.kernels import ops as kops
from repro_torch.kernels.contention import counter_key, counter_uniform53
from repro_torch.objectives.local import objective_epoch_scan
from repro_torch.objectives.server import build_objective_table
from repro_torch.sharding.cohort import (COHORT_AXIS, shardable,
                                         sweep_sharding, sweep_shardable,
                                         winner_shardable)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def aircomp_noise(key, leaf_index: int, shape, device) -> torch.Tensor:
    """Standard-normal f32 receiver-noise plane of one leaf of one AirComp
    merge, computed on ``device``. ``key`` is the merge context's
    ``(noise entropy, round)`` pair. Element ``e`` is a Box-Muller
    normal, ``sqrt(-2 log u1) * cos(2 pi u2)`` in f64 and then cast to
    f32, of two 53-bit uniforms on (0, 1] (``counter_uniform53`` under
    ``counter_key(entropy, round)``, event ``leaf_index``, rows 0 and 1,
    column ``e``): a function of ``(entropy, round, leaf_index, e)``
    alone, so no two leaves or rounds share draws, a run is reproducible
    bit for bit, and the CPU and the card compute the same integers and
    uniforms (the f64 ``log`` / ``cos`` of the two may differ in the last
    ulp, which the f32 cast almost always absorbs). The reference draws
    threefry ``normal(fold_in(fold_in(key, t), i))`` instead: the two
    agree in distribution only."""
    entropy, t = key
    shape = tuple(shape)
    u = counter_uniform53(counter_key(entropy, t), leaf_index, 2,
                          math.prod(shape), device)
    z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos((2.0 * math.pi) * u[1])
    return z.to(torch.float32).reshape(shape)


@dataclass
class SweepState:
    """Device + host state of one in-flight sweep of E lanes.

    ``glob`` holds the E lanes' globals (one pytree a lane, fresh
    tensors that never alias ``stack``); ``stack`` is the ``(E, U, ...)``
    cohort, every user row of lane e equal to ``glob[e]`` at round start
    — the device-resident stack the merge leaves, or None while a train
    call owns it. ``rngs[e][u]`` is lane e / user u's epoch-permutation
    stream, seeded from the LANE's spec seed (``client_rng``), so each
    lane draws the batches a sequential run of that spec would.

    ``obj`` is the sweep's ``ObjectiveTable`` (None: every lane plain
    FedAvg); ``m`` / ``v`` the lanes' server moments (one pytree a lane)
    and ``h`` the ``(E, U, ...)`` FedDyn state, all on the device.

    A sparse sweep's ``stack`` is the ``(E, K_max, ...)`` winner stack
    (None before its first merge); ``pending`` holds the round's (E, U,
    ep*take) prepass draws for the winner retrain, and ``prio_cache``
    the (E, U) stale priorities of ``sparse_priority="stale"`` (None
    before the first round).

    ``split`` is the dim a cohort split cuts the dense ``(E, U, ...)``
    stack along (0: whole lanes a chunk, 1: users), or None; the stack
    is then a ``_Split`` and the globals, m / v and h stay on the
    backend's device.
    """
    num_lanes: int
    glob: List[Any]
    stack: Any
    rngs: List[List[np.random.Generator]]
    obj: Any = None
    m: Optional[List[Any]] = None
    v: Optional[List[Any]] = None
    h: Any = None
    pending: Any = None
    prio_cache: Optional[np.ndarray] = None
    split: Optional[int] = None


@dataclass
class SweepTrainResult:
    """One sweep training pass, as device tensors: the trained ``(E, R,
    ...)`` stack (the merge overwrites it) and the ``(E, R)`` f32
    priorities and losses — the only values the engine reads on the host
    each round (``read``). R is the cohort, or K_max on a sparse sweep."""
    trained: Any
    losses: Any
    priorities: Any
    host: Any = None

    def read(self):
        """``(priorities, losses)`` as (E, R) float64 host arrays, in ONE
        copy: the round's one sync (a second call returns the same
        arrays). Read before anything else is queued (a later copy would
        wait for it)."""
        if self.host is None:
            both = torch.stack((self.priorities, self.losses.float())).cpu()
            trace.synced(self.priorities.device)
            self.host = tuple(both.numpy().astype(np.float64))
        return self.host


def _bounds(n: int, parts: int):
    """``parts`` contiguous ``[lo, hi)`` ranges over ``n`` rows."""
    return [(i * n // parts, (i + 1) * n // parts) for i in range(parts)]


def _to(tree, dev):
    """``tree`` on ``dev`` (the tensors themselves when already there)."""
    return tree_map(lambda p: p.to(dev), tree)


def _on(dev):
    """The context a chunk's work on ``dev`` runs in: a CUDA device is
    made current (a kernel wrapper launches on the current device only,
    ``kernels/build.launch_stream``); nothing on any other device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _pinned(dev) -> torch.device:
    """``dev`` with its index: an index-less ``cuda`` means the current
    device, which each chunk's work changes (``_on``). Raises as
    ``resolve_device`` does for a CUDA device without CUDA."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _cat(xs, dim=0):
    """The chunks' tensors ``xs`` as one (the tensor itself for one)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


class _Split:
    """A stack cut into chunks over the cohort mesh: ``parts[i]`` (a
    pytree) holds the ``bounds[i]`` range of the cut dim on ``devs[i]``.
    The cut dim is the rows of a ``(R, ...)`` stack, or on an ``(E, R,
    ...)`` sweep stack (``lanes``) the lanes (``dim`` 0) or the users
    (1). An unsplit stack is one chunk (``chunks_of``)."""

    def __init__(self, parts, bounds, devs, lanes=False, dim=0):
        self.parts, self.bounds, self.devs = parts, bounds, devs
        self.lanes, self.dim = lanes, dim
        self._his = np.asarray([hi for _, hi in bounds])

    def chunks(self):
        """``(part, lo, hi, dev, lane slice)`` for every chunk: the lane
        slice is the sweep lanes the part holds (all on a user cut)."""
        for part, (lo, hi), dev in zip(self.parts, self.bounds, self.devs):
            lanes = (slice(lo, hi) if self.lanes and self.dim == 0
                     else slice(None))
            yield part, lo, hi, dev, lanes

    def groups(self, ids):
        """``(chunk, positions in ids, the chunk's own row ids)`` for each
        chunk that holds some of the cut-dim ids ``ids``."""
        own = np.searchsorted(self._his, ids, side="right")
        return [(c, np.nonzero(own == c)[0], ids[own == c] - self.bounds[c][0])
                for c in np.unique(own)]

    @staticmethod
    def in_order(outs, groups, dev):
        """The pytrees ``outs`` (one a group of ``groups``, on ``dev``) as
        one, their rows put back in the order of the ids."""
        if len(outs) == 1:
            return outs[0]
        order = torch.from_numpy(np.argsort(
            np.concatenate([g[1] for g in groups]), kind="stable")).to(dev)
        return tree_map(lambda *ps: torch.cat(ps).index_select(0, order),
                        *outs)

    def rows(self, ids, dev, lane=0):
        """A fresh ``(len(ids), ...)`` pytree on ``dev``: the rows ``ids``
        (of lane ``lane`` on a sweep stack), in order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if self.lanes and self.dim == 0:
            c = int(np.searchsorted(self._his, lane, side="right"))
            groups = [(c, np.arange(len(ids)), ids)]
            view = lambda x: x[lane - self.bounds[c][0]]  # noqa: E731
        else:
            groups = self.groups(ids)
            view = ((lambda x: x[lane]) if self.lanes  # noqa: E731
                    else (lambda x: x))
        return self.in_order([tree_map(
            lambda x, c=c, loc=loc: torch.index_select(
                view(x), 0, torch.from_numpy(loc).to(self.devs[c])).to(dev),
            self.parts[c]) for c, _, loc in groups], groups, dev)


def chunks_of(stack, lanes=False) -> _Split:
    """``stack`` as chunks: a ``_Split`` as it is, any other stack (a
    ``(R, ...)`` one, or an ``(E, R, ...)`` sweep stack with ``lanes``)
    as one chunk on its own device. Every path reads a stack through
    this, so the unsplit path is the one-chunk case of the split one."""
    if isinstance(stack, _Split):
        return stack
    lead = tree_leaves(stack)[0]
    return _Split([stack], [(0, lead.shape[0])], [lead.device], lanes)


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
        """Eq. 1 over ``winners``. ``merge_ctx`` (a
        ``channel.MergeContext``) switches the digital reduction to the
        AirComp analog superposition; ``fault_ctx`` (a
        ``faults.robust.FaultMergeContext``) to the robust merge guard,
        which writes ``n_quarantined`` back into it. Backends that
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
        """True when the engine selects BEFORE training and trains only
        the winners (``sparse_priorities`` / ``sparse_train``)."""
        return False

    def sweep_sparse_capable(self) -> bool:
        return False

    def priority_cache_state(self):
        """The stale-priority cache for checkpoint / resume, or None when
        the backend keeps none (everything but ``sparse_priority=
        "stale"``)."""
        return None

    def restore_priority_cache(self, state) -> None:
        if state is not None:
            raise NotImplementedError(
                f"{type(self).__name__} has no priority cache to restore")

    def objective_active(self) -> bool:
        """True when the backend was built with a non-plain objective."""
        return False

    def objective_needs_h(self) -> bool:
        """True when merges must run on h-carrying rounds even without
        deliveries (feddyn)."""
        return False


class HostBackend(Backend):
    """Paper-scale simulation over host data (see the module docstring
    for the fused / stacked / ragged round paths).

    ``round_mode``: ``"fused"`` (the default), ``"stacked"``,
    ``"ragged"`` or ``"sparse"`` (winner-sparse rounds; needs ``k_max``
    and a rectangular cohort). ``None`` follows the reference's legacy
    ``prefer_vmap`` flag: ``"fused"`` when it is true, else
    ``"ragged"``; an explicit ``round_mode`` overrides the flag.
    ``k_max``: the round's winner budget (the spec's ``k_per_round``) —
    the compact merge pad width, and the sparse path's train width.
    ``sparse_priority`` (``"prepass"`` | ``"stale"``) and
    ``sparse_chunk`` (rows a prepass chunk trains) set the sparse path's
    Eq. 2 ordering (``sparse_priorities``).
    ``device``: where the cohort lives. ``None`` is the CUDA device and
    raises without one; only an explicit ``"cpu"`` runs on the CPU.
    ``mesh``: an optional ``sharding.cohort_mesh``. Where the reference
    would shard (``shardable(U)`` on the fused path, ``winner_shardable
    (k_max)`` without an objective on the sparse one, ``sweep_shardable
    (E, U)`` on a sweep) over a cohort axis of D > 1 devices, the stack
    runs as D chunks, chunk i on the mesh's i-th device, made current for
    the chunk's work (the module docstring); ``device=None`` is then the
    mesh's first device. A device may repeat in the mesh: its chunks run
    in turn.
    """

    def __init__(self, loss_fn, user_data: Sequence, *, lr: float = 1e-2,
                 batch_size: int = 32, local_epochs: int = 1, seed: int = 0,
                 prefer_vmap: bool = True, num_classes: int = 10,
                 round_mode: Optional[str] = None, mesh=None,
                 k_max: Optional[int] = None,
                 sparse_priority: str = "prepass", sparse_chunk: int = 256,
                 objective=None, device=None):
        if round_mode is None:
            round_mode = "fused" if prefer_vmap else "ragged"
        if round_mode not in ("fused", "stacked", "ragged", "sparse"):
            raise ValueError(f"unknown round_mode {round_mode!r}")
        if round_mode == "sparse" and not k_max:
            raise ValueError(
                "round_mode='sparse' needs k_max (the spec's "
                "k_per_round): it sizes the compact winner stack")
        if sparse_priority not in ("prepass", "stale"):
            raise ValueError(
                f"unknown sparse_priority {sparse_priority!r}; "
                "known: ('prepass', 'stale')")
        self._objective = objective
        obj_on = objective is not None and not objective.is_plain
        if obj_on and round_mode in ("stacked", "ragged"):
            raise ValueError(
                "non-plain objectives run in the fused round only; "
                f"round_mode={round_mode!r} is the per-round fallback path")
        # "stacked" / "fused" stack what they can, "ragged" never
        self._mode = round_mode
        self._prefer_vmap = round_mode != "ragged"
        self.num_users = len(user_data)
        self._k_max = int(k_max) if k_max else None
        # the cohort split: the reference's predicates, then a cohort
        # axis of more than one device (a 1-long axis splits nothing)
        self._mesh = mesh
        self._shard = shardable(self.num_users, mesh)
        D = (mesh.shape[COHORT_AXIS]
             if mesh is not None and COHORT_AXIS in mesh.shape else 1)
        self._devs = None
        if D > 1 and getattr(mesh, "devices", None) is not None:
            axis = list(mesh.shape).index(COHORT_AXIS)
            self._devs = [_pinned(d) for d in np.moveaxis(
                np.asarray(mesh.devices), axis, 0).reshape(D, -1)[:, 0]]
            device = _pinned(self._devs[0] if device is None else device)
        self._split_fused = self._shard and D > 1
        self._split_sparse = (D > 1 and bool(self._k_max)
                              and winner_shardable(self._k_max, mesh)
                              and not obj_on)
        if (self._split_fused or self._split_sparse) and self._devs is None:
            raise ValueError("a cohort split needs a mesh of devices, not "
                             "a shape-only mesh")
        self.device = resolve_device(device)
        self.heterogeneity = label_heterogeneity(user_data, num_classes)
        self.seed = seed                     # the clients' stream seed
        # Clients carry the per-user data, example counts and rng streams
        self.clients = [
            Client(u, user_data[u], loss_fn, lr=lr, batch_size=batch_size,
                   local_epochs=local_epochs, seed=seed)
            for u in range(self.num_users)
        ]
        self._loss_fn = loss_fn
        self._lr = lr
        self._batch_size = batch_size
        self._local_epochs = local_epochs
        self._sparse_priority = sparse_priority
        self._sparse_chunk = int(sparse_chunk)
        self._epoch_run = sgd_epoch_scan(loss_fn, lr)

        # a cohort that is not rectangular runs its rounds on the stacked
        # or ragged path
        ns = {c.num_examples for c in self.clients}
        self._rect = (len(ns) == 1
                      and batch_size <= self.clients[0].num_examples)
        if self._mode == "sparse" and not self._rect:
            raise ValueError(
                "round_mode='sparse' needs a rectangular cohort (equal "
                "per-user example counts >= batch_size): the prepass "
                "and compact gather-K train steps stack user data into "
                "one (U, n, ...) tensor; use round_mode=None (auto) or "
                "'ragged' for uneven cohorts")
        if obj_on and not self._rect:
            raise ValueError(
                "non-plain objectives need a rectangular cohort (equal "
                "per-user example counts >= batch_size): the objective "
                "gradient law runs in the fused round only")
        self._xstack = None        # (U, n, ...) user data, on the device
        # under a split of the fused or sparse stack: chunk i's users'
        # (U_i, n, ...) data on the mesh's i-th device instead
        # (``_ensure_xstack``)
        self._xsplit = None
        # AirComp noise: ``(key, leaf_index, shape, device) -> N(0, 1)``
        # plane; tests swap in the reference's threefry planes here
        self._noise_draw = aircomp_noise
        self._resident = None      # device-resident merged cohort stack
        self._resident_key = None  # the global-state object it mirrors
        # ---- sparse-path state ----------------------------------------
        self._stale_prios = None   # (U,) f64 last-trained priorities
        self._pending_big = None   # this round's (U, ep*take) prepass draws
        # ---- objectives state (lazy, on the device) -------------------
        self._obj_runs = {}           # use_h -> objective_epoch_scan
        self._obj_m = None            # server-opt first moment (~ glob)
        self._obj_v = None            # server-opt second moment
        self._obj_h = None            # (U, ...) per-user FedDyn h-state
        self._param_dtypes = None     # the global's leaf dtypes (init_state)

    # ------------------------------------------------------------------
    def init_state(self, init_params):
        """The global state: ``init_params`` on this backend's device
        (the caller's tensors themselves when they already lie there —
        nothing in the backend ever writes into the global state)."""
        state = tree_map(
            lambda p: torch.as_tensor(p).detach().to(self.device),
            init_params)
        self._param_dtypes = tree_map(lambda p: p.dtype, state)
        return state

    def num_examples(self, u):
        return self.clients[u].num_examples

    def _can_stack(self, train_ids) -> bool:
        if not self._prefer_vmap or len(train_ids) < 2:
            return False
        nbs = {max(1, self.clients[u].num_examples // self._batch_size)
               for u in train_ids}
        return len(nbs) == 1

    def _can_fuse(self, train_ids) -> bool:
        return (self._mode == "fused" and self._rect
                and len(train_ids) == self.num_users)

    # ------------------------------------------------ objectives helpers
    def objective_active(self) -> bool:
        return (self._objective is not None
                and not self._objective.is_plain)

    def objective_needs_h(self) -> bool:
        return self.objective_active() and self._objective.uses_h

    def _obj_run(self, use_h: bool):
        """The ``objective_epoch_scan`` closure, with or without h."""
        if use_h not in self._obj_runs:
            self._obj_runs[use_h] = objective_epoch_scan(
                self._loss_fn, self._lr, use_h)
        return self._obj_runs[use_h]

    def _ensure_obj_h(self, state):
        """(U, ...) FedDyn h tensors on the device, zero-initialised on
        first touch (no RNG — the objectives subsystem draws nothing)."""
        if self._obj_h is None:
            U = self.num_users
            self._obj_h = tree_map(
                lambda p: torch.zeros((U,) + tuple(p.shape), dtype=p.dtype,
                                      device=self.device), state)
        return self._obj_h

    def objective_state(self):
        """Host numpy copies of the server-opt moments and the FedDyn
        h-state (None for a piece this objective never materialised),
        or None without an active objective. bf16 leaves widen to f32
        (``convert.params_to_numpy``)."""
        if not self.objective_active():
            return None
        host = lambda x: None if x is None else params_to_numpy(x)  # noqa: E731
        return {"m": host(self._obj_m), "v": host(self._obj_v),
                "h": host(self._obj_h)}

    def restore_objective_state(self, state) -> None:
        """Inverse of ``objective_state``: each leaf back on the device in
        the dtype of the global's leaf it belongs to (``to_device``), so a
        bf16 model's m / v / h come back bf16 — the widening to f32 was
        exact, and so is the cast back."""
        if state is None:
            return
        self._obj_m = self.to_device(state.get("m"))
        self._obj_v = self.to_device(state.get("v"))
        self._obj_h = self.to_device(state.get("h"))

    def to_device(self, tree):
        """A host numpy tree of the global's structure (a global, m / v,
        an (E, ...) or (U, ...) stack of them) as tensors on this
        backend's device, each leaf in the dtype of the global's leaf
        that ``init_state`` recorded (the snapshot's dtype before any
        ``init_state``). None stays None."""
        if tree is None:
            return None
        if self._param_dtypes is None:
            return params_from_numpy(tree, device=self.device)
        return tree_map(lambda a, dt: params_from_numpy(
            a, device=self.device, dtype=dt), tree, self._param_dtypes)

    def adopt_sweep_objective(self, st) -> None:
        """E = 1 delegation continuity: after ``run()`` went through the
        sweep path, lane 0's m / v / h become this backend's, so a later
        per-round round or checkpoint picks up the same state."""
        if st.obj is None:
            return
        self._obj_m = st.m[0] if st.m is not None else None
        self._obj_v = st.v[0] if st.v is not None else None
        self._obj_h = (None if st.h is None
                       else tree_map(lambda x: x[0], st.h))

    # ------------------------------------------------- fused round path
    def _ensure_xstack(self):
        """Stack the rectangular per-user data to (U, n, ...) ON THE
        DEVICE, once: per round only the host-drawn index matrix is
        uploaded, not the batches."""
        if self._xstack is not None or self._xsplit is not None:
            return
        self._nb = max(1, self.clients[0].num_examples // self._batch_size)
        with trace.span("setup.xstack"):
            if not (self._split_fused or self._split_sparse):
                self._xstack = tree_map(
                    lambda *xs: torch.from_numpy(
                        np.stack([np.asarray(x) for x in xs])).to(
                            self.device),
                    *[c.data for c in self.clients])
                return
            bounds = _bounds(self.num_users, len(self._devs))
            self._xsplit = _Split([tree_map(
                lambda *xs: torch.from_numpy(
                    np.stack([np.asarray(x) for x in xs])).to(dev),
                *[c.data for c in self.clients[lo:hi]])
                for (lo, hi), dev in zip(bounds, self._devs)],
                bounds, self._devs)

    def _bcast(self, state, rows: Optional[int] = None):
        """A fresh contiguous (rows, ...) stack of the global (``rows``
        defaults to the cohort size) — never a view of ``state``, which
        training must not overwrite (``contiguous()`` would hand back
        ``state``'s own storage for one row: a copy is always made)."""
        S = self.num_users if rows is None else rows
        return tree_map(
            lambda p: p.unsqueeze(0).expand((S,) + tuple(p.shape))
            .clone(memory_format=torch.contiguous_format), state)

    def _fused_merge(self, trained, idx, w, old_glob):
        """The ONE Eq. 1 merge of the digital path: gather the ``idx``
        rows out of the trained stack, reduce them under the compact
        weights in delivery order, keep ``old_glob`` when no weight is
        nonzero. ``old_glob`` is only read — on round 0 it may still be
        the caller's init_params. Returns the new global, a fresh tensor
        per leaf; the caller then overwrites the trained stack's buffer
        with its broadcast (``_restack``; a sweep, ``_end_sweep_merge``),
        and that buffer becomes next round's resident stack."""
        with torch.no_grad():
            return self._average(trained, idx, w, old_glob)

    @staticmethod
    def _average(trained, idx, w, old_glob):
        """Eq. 1 per leaf: one ``gather_combine`` launch each."""
        return tree_map(lambda l, g: kops.gather_combine(l, idx, w, g),
                        trained, old_glob)

    @staticmethod
    def _restack(new_glob, trained):
        """Overwrite the trained stack's buffer (every chunk's) with the
        broadcast of the new global; it becomes next round's resident
        stack."""
        with torch.no_grad():
            for part, _, _, dev, _ in chunks_of(trained).chunks():
                with _on(dev):
                    tree_map(lambda g, l: l.copy_(g.unsqueeze(0).expand_as(l)),
                             _to(new_glob, dev), part)
        return trained

    def _fused_merge_air(self, trained, idx, alphas, coeffs, sigma, key):
        """AirComp twin of ``_fused_merge``: per leaf, the noisy
        superposition of the ``idx`` rows read straight out of the
        trained stack (no gathered copy), under the compact alphas and
        power-control coefficients, with a receiver-noise plane
        ``sigma * N(0, 1)`` drawn on the device (none at ``sigma == 0``,
        which gives the bits of a zero plane). The weights and the
        rescale are formed once a merge, on the device. Returns the new
        global, as the digital merge does."""
        leaves = tree_leaves(trained)
        sig = torch.tensor(sigma, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            w, scale = kops.aircomp_weights(alphas, coeffs, self.device)
            noise = iter([
                sig * self._noise_draw(key, i, l.shape[1:], self.device)
                if sigma != 0.0 else None for i, l in enumerate(leaves)])
            return tree_map(
                lambda l: kops.aircomp_combine_weighted(
                    l, w, scale, next(noise), idx=idx), trained)

    def _merge_fused_faults(self, state, trained, idx, winners, ctx):
        """Robust-guard twin of ``_fused_merge``: compact the dense (U,)
        fault-context weight / corruption vectors down to the (k_pad,)
        merge candidates ``idx`` (on the device; pads: exact-zero
        weight, corruption 1.0
        = the passthrough branch), gather their rows ONCE (both the
        delta norms and the combine read them), stack the stale group,
        and run ``robust_merge``. ``state`` (the old global, the guard's
        delta reference) is only read. Returns the new global; writes
        ``ctx.n_quarantined`` — one host sync a merge."""
        m = len(winners)
        k_pad = idx.shape[0]
        w = np.zeros(k_pad, np.float32)
        c = np.ones(k_pad, np.float32)
        if m:
            sel = [int(u) for u in winners]
            w[:m] = np.asarray(ctx.weights, np.float32)[sel]
            c[:m] = np.asarray(ctx.corrupt, np.float32)[sel]
        with torch.no_grad():
            rows = tree_map(lambda l: torch.index_select(l, 0, idx), trained)
            stale, stale_w = self._stale_group(ctx.stale, state)
            new_glob, nq = robust_merge(
                rows, w, c, state, stale, stale_w,
                quarantine=bool(ctx.quarantine),
                clip_norm=float(ctx.clip_norm))
        ctx.n_quarantined = int(nq)
        return new_glob

    @staticmethod
    def _stale_group(stale, like):
        """The ``(params, weight)`` stale entries as one (M, ...) stack on
        the device of ``like`` (the old global) and in its leaf dtypes —
        an entry restored from a checkpoint is host numpy — and their
        (M,) f32 weights; ``(None, None)`` when there is none."""
        if not stale:
            return None, None
        stack = tree_map(
            lambda g, *ls: torch.stack([torch.as_tensor(x).to(
                device=g.device, dtype=g.dtype) for x in ls]),
            like, *[p for p, _ in stale])
        return stack, np.asarray([w for _, w in stale], np.float32)

    def _draw_perms(self, rngs):
        """(E, U, ep*take) epoch-permutation index tensor for ONE round
        of E lanes, ``rngs[e][u]`` lane e / user u's stream: one
        permutation per (lane, local epoch, user), drawn on the host in
        that order, each user's epochs laid out one after the other. A
        single run is the one lane of its clients' own streams."""
        E, U = len(rngs), self.num_users
        bs, nb, ep = self._batch_size, self._nb, self._local_epochs
        n = self.clients[0].num_examples
        take = nb * bs
        perms = np.empty((E, ep, U, take), np.int64)
        for e in range(E):
            for k in range(ep):
                for u in range(U):
                    perms[e, k, u] = rngs[e][u].permutation(n)[:take]
        return perms.transpose(0, 2, 1, 3).reshape(E, U, ep * take)

    def _draw_big(self):
        """(U, ep*take) index matrix of one round of this backend's own
        clients (``_draw_perms`` of their streams, one lane)."""
        return self._draw_perms([[c._rng for c in self.clients]])[0]

    def _gather_rows(self, rows, big_rows, dev=None):
        """(R, ep*nb, bs, ...) round batches for the data rows ``rows``
        (user ids) under the per-row index matrix ``big_rows``
        ((R, ep*take) slice of ``_draw_big``'s output), on ``dev`` (the
        backend's device by default): one device-side fancy-index over
        the pre-stacked data — under a cohort split one a chunk that
        holds some of the rows, copied to ``dev`` and put in order."""
        dev = self.device if dev is None else dev
        if self._xsplit is None:
            return _to(self._gather_from(self._xstack, rows, big_rows,
                                         self.device), dev)
        split, big_rows = self._xsplit, np.asarray(big_rows)
        groups = split.groups(np.asarray(rows, np.int64))
        return split.in_order([_to(self._gather_from(
            split.parts[c], loc, big_rows[pos], split.devs[c]), dev)
            for c, pos, loc in groups], groups, dev)

    def _gather_from(self, xstack, rows, big_rows, dev):
        R = len(rows)
        bs, nb, E = self._batch_size, self._nb, self._local_epochs
        r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)[:, None]
        big = torch.from_numpy(np.ascontiguousarray(big_rows)).to(dev)
        return tree_map(
            lambda leaf: leaf[r, big].reshape(
                (R, E * nb, bs) + tuple(leaf.shape[2:])),
            xstack)

    def _fused_batches(self):
        """(U, E*nb, bs, ...) full-cohort round batches."""
        return self._gather_rows(np.arange(self.num_users), self._draw_big())

    def _draw_winner_perms(self, gens, rows: int):
        """(rows, ep*take) index matrix of winner-only draws: row j takes
        one permutation per local epoch from ``gens[j]`` (the stale
        sparse mode draws nothing for anyone else); rows past
        ``len(gens)`` are pads at index 0."""
        bs, nb, ep = self._batch_size, self._nb, self._local_epochs
        n = self.clients[0].num_examples
        take = nb * bs
        big = np.zeros((rows, ep * take), np.int64)
        for j, gen in enumerate(gens):
            for k in range(ep):
                big[j, k * take:(k + 1) * take] = gen.permutation(n)[:take]
        return big

    def _train_rows(self, stack, batched, anchor, h=None):
        """Local SGD over the rows of ``stack``, IN PLACE, under this
        backend's objective law (``anchor``: the proximal anchor, a
        global that never aliases ``stack``; ``h``: the rows' FedDyn
        state when the objective carries it). Returns ``(trained, (R,)
        losses)``, a row's loss the mean over its LAST epoch's
        batches."""
        if self.objective_active():
            extra = (h,) if self._objective.uses_h else ()
            trained, losses = self._obj_run(self._objective.uses_h)(
                stack, batched, anchor, self._objective.prox_coeff, *extra)
        else:
            trained, losses = self._epoch_run(stack, batched)
        return trained, losses[:, -self._nb:].mean(dim=1)

    def _train_chunks(self, state, resident, rows, big_rows, h, split,
                      need_priority=True):
        """Local SGD and Eq. 2 over the R = ``len(rows)`` rows (user ids;
        ``big_rows`` their draws): one chunk on this device, or with
        ``split`` D chunks over the mesh, chunk i on its i-th device
        (made current, ``_on``). Each chunk trains a fresh broadcast of
        ``state`` (or its part of ``resident``, the stack the last merge
        left) on its gathered batches and its rows of ``h`` (the rows'
        FedDyn state or None), then reduces by Eq. 2 when
        ``need_priority``: one launch of each kernel a chunk.

        ``state`` never aliases the stack (``_bcast`` and the merge both
        produce fresh tensors), so it is the Eq. 2 reference and the
        proximal anchor as it is (the reference package slices row 0 of
        the stack; here that would be a view of the buffer the SGD kernel
        overwrites). Returns ``(trained, (R,) losses, (R,) priorities or
        ones)``: ``trained`` the stack, a ``_Split`` of D chunks; the
        other two on this device."""
        plan = self._plan(len(rows), split)
        res = None if resident is None else chunks_of(resident)
        parts, losses, prios = [], [], []
        for i, ((lo, hi), dev) in enumerate(plan):
            with _on(dev):
                glob = _to(state, dev)
                stack = (res.parts[i] if res is not None
                         else self._bcast(glob, hi - lo))
                hc = None if h is None else tree_map(
                    lambda x: x[lo:hi].to(dev), h)
                trained, loss = self._train_rows(
                    stack, self._gather_rows(rows[lo:hi], big_rows[lo:hi],
                                             dev), glob, hc)
                parts.append(trained)
                losses.append(loss.to(self.device))
                prios.append(stacked_model_priorities(trained, glob)
                             .to(self.device) if need_priority
                             else torch.ones(hi - lo, dtype=torch.float32,
                                             device=self.device))
        trained = (parts[0] if len(parts) == 1 else
                   _Split(parts, [b for b, _ in plan], [d for _, d in plan]))
        return trained, _cat(losses), _cat(prios)

    def _plan(self, n, split):
        """``((lo, hi), device)`` for each chunk of ``n`` rows: one on
        this device, or with ``split`` one on each device of the mesh."""
        if not split:
            return [((0, n), self.device)]
        return list(zip(_bounds(n, len(self._devs)), self._devs))

    def _train_round_fused(self, state, need_priority) -> TrainResult:
        self._ensure_xstack()
        # the stack the last merge left mirrors ``state``: trained in
        # place (the buffer stays on the device from round to round)
        resident = (self._resident if self._resident_key is state
                    else None)
        self._resident = self._resident_key = None
        h = self._ensure_obj_h(state) if self.objective_needs_h() else None
        trained, loss_u, prios = self._train_chunks(
            state, resident, np.arange(self.num_users), self._draw_big(), h,
            self._split_fused, need_priority)
        # priorities leave the device as f32 with the losses, widened on
        # the host
        both = torch.stack((prios, loss_u.float())).cpu().numpy() \
            .astype(np.float64)
        return TrainResult(
            losses=both[1],
            priorities=both[0] if need_priority else np.ones(self.num_users),
            local_handle={"fused_stack": trained})

    def _train_round_stacked(self, state, train_ids, need_priority):
        """The round's S = ``len(train_ids)`` users trained as one
        ``(S, ...)`` stack, epoch by epoch: each epoch draws
        ``batch_epoch`` from every client's own stream in ``train_ids``
        order (the fused path's ``_draw_big`` draws, so the paths pick
        the same winners) and runs ``sgd_epoch_scan`` over it; then ONE
        ``stacked_model_priorities`` call. Losses: the mean over the last
        epoch's batches, per user."""
        stack = self._bcast(state, len(train_ids))
        for _ in range(self._local_epochs):
            per_user = [batch_epoch(self.clients[u]._rng,
                                    self.clients[u].data, self._batch_size)
                        for u in train_ids]
            batched = tree_map(
                lambda *xs: torch.from_numpy(np.stack(xs)).to(self.device),
                *per_user)
            stack, losses = self._epoch_run(stack, batched)
        loss_vec = losses.mean(dim=1).cpu().numpy()
        priorities = np.ones(self.num_users)
        if need_priority:
            prios = stacked_model_priorities(stack, state).cpu().numpy()
            priorities[train_ids] = prios
        return TrainResult(
            losses={u: float(loss_vec[i]) for i, u in enumerate(train_ids)},
            priorities=priorities,
            local_handle={"stacked": stack,
                          "index": {u: i for i, u in enumerate(train_ids)}})

    def _train_round_ragged(self, state, train_ids, need_priority):
        """Per-user training (``Client.train``, U = 1 launches) and one
        ``model_priority`` call a user."""
        priorities = np.ones(self.num_users)
        locals_, losses = {}, {}
        for u in train_ids:
            locals_[u], loss = self.clients[u].train(state)
            losses[u] = float(loss)
            if need_priority:
                priorities[u] = float(model_priority(locals_[u], state))
        return TrainResult(losses=losses, priorities=priorities,
                           local_handle=locals_)

    # ------------------------------------------------------------------
    def train_round(self, state, t, train_ids, need_priority):
        if not train_ids:
            return TrainResult(losses={},
                               priorities=np.ones(self.num_users),
                               local_handle={})
        if self._can_fuse(train_ids):
            return self._train_round_fused(state, need_priority)
        if self.objective_active():
            raise RuntimeError(
                "non-plain objective on an unfused round (partial "
                "cohort?): objectives run in the fused round only")
        if self._can_stack(train_ids):
            return self._train_round_stacked(state, train_ids,
                                             need_priority)
        return self._train_round_ragged(state, train_ids, need_priority)

    @staticmethod
    def _local(handle, u):
        """User u's trained params on a stacked or ragged handle (a view
        of the handle's tensors)."""
        if "stacked" in handle:
            i = handle["index"][u]
            return tree_map(lambda p: p[i], handle["stacked"])
        return handle[u]

    def extract_local(self, train_result, u):
        """User u's trained params as freshly materialized tensors, safe
        to hold across the merge (which overwrites the fused handle's
        trained stack) — the fault layer's straggler capture."""
        handle = train_result.local_handle
        for key in ("fused_stack", "sparse_stack"):
            if key not in handle:
                continue
            j = (int(u) if key == "fused_stack"
                 else handle["winners"].index(int(u)))
            return tree_map(lambda p: p[0],
                            chunks_of(handle[key]).rows([j], self.device))
        return tree_map(lambda p: p.clone(), self._local(handle, u))

    def _k_pad(self, m: int) -> int:
        """Compact merge width: ``k_max`` when set (so every round's
        merge pads identically), else the delivery count itself."""
        if self._k_max and m <= self._k_max:
            return self._k_max
        return max(m, 1)

    def _objective_merge(self, obj, state, trained, idx, w, w_host,
                         attempts, m, v, h):
        """Objective twin of ``_fused_merge`` for the objective ``obj``
        with its server moments ``m`` / ``v`` (None, or pytrees like
        ``state``) and FedDyn state ``h`` ((U, ...) or None): the h update
        over the round's ATTEMPT winners, then the shared Eq. 1 average,
        then the server step on the pseudo-gradient (``server_opt_leaves``,
        one launch for every leaf) when the aggregator carries m / v.
        ``attempts`` is the pair ``(user ids, rows)``: the attempt
        winners and their rows in ``trained`` (the user ids themselves on
        a (U, ...) stack, delivery positions on the sparse (K_max, ...)
        one). Returns ``(new_glob, m', v')``.

        The h update ``h_u <- h_u - alpha * (w_u^end - w_glob)`` reads
        only the trained rows of the attempt winners and ``state``, so it
        runs first, before the stack is overwritten; it writes each
        user's row of ``h`` in place once (the winners are distinct: an
        indexed write, no float atomics; a pad slot is never written);
        ``alpha == 0`` skips it, so h stays bitwise. A merge whose
        weights are all zero (attempts but no deliveries: only an
        h-carrying objective dispatches one) skips the server step on the
        host — the global is the average, which is the old global's bits,
        and m / v stay as they were, bitwise. The new global and moments
        are fresh tensors."""
        with torch.no_grad():
            uids, pos = attempts if attempts is not None else ([], [])
            if obj.uses_h and len(uids) and obj.alpha_coeff != 0.0:
                dst = torch.as_tensor([int(u) for u in uids],
                                      dtype=torch.int64, device=self.device)
                src = torch.as_tensor([int(p) for p in pos],
                                      dtype=torch.int64, device=self.device)
                neg_alpha = -float(np.float32(obj.alpha_coeff))
                for hh, l, g in zip(tree_leaves(h), tree_leaves(trained),
                                    tree_leaves(state)):
                    hh[dst] = hh[dst] + neg_alpha * (l[src] - g)
            new_glob = self._average(trained, idx, w, state)
            if obj.uses_server and np.any(w_host != 0.0):
                outs, ms, vs = kops.server_opt_leaves(
                    tree_leaves(new_glob), tree_leaves(state),
                    tree_leaves(m), tree_leaves(v), obj.server_consts())
                new_glob = tree_unflatten(state, outs)
                m, v = tree_unflatten(state, ms), tree_unflatten(state, vs)
        return new_glob, m, v

    def merge(self, state, train_result, winners, merge_ctx=None,
              fault_ctx=None, attempts=None):
        """Eq. 1 over ``winners`` (delivery order): the robust merge
        when ``fault_ctx`` is given, else the AirComp merge when
        ``merge_ctx`` is, else the objective merge when a non-plain
        objective is active, else the digital one. ``attempts`` (the
        round's attempt winners) feed the FedDyn h update. The old global
        ``state`` is only read. On the fused handle (rows = user ids) and
        the sparse one (rows = delivery positions in the (K_max, ...)
        winner stack) the trained stack becomes the new resident stack; a
        stacked or ragged handle takes the gather merge
        (``_gather_merge``)."""
        handle = train_result.local_handle
        winners = [int(u) for u in winners]
        attempts = [int(u) for u in (attempts or [])]
        if "fused_stack" in handle:
            key, pos, att_pos = "fused_stack", winners, attempts
        elif "sparse_stack" in handle:
            key = "sparse_stack"
            pos = [handle["winners"].index(u) for u in winners]
            att_pos = [handle["winners"].index(u) for u in attempts]
            if handle[key] is None and not handle["winners"]:
                # a stale-mode round without winners trained nothing:
                # only a stale-only robust merge lands here
                if fault_ctx is None or winners:
                    raise ValueError("merge of an untrained sparse round "
                                     "needs a stale-only robust merge")
                return self._gather_merge_faults(state, handle, [],
                                                 fault_ctx)
        else:
            return self._gather_merge(state, handle, winners, merge_ctx,
                                      fault_ctx)
        trained = handle[key]
        if trained is None:
            raise ValueError(
                "merge needs the train handle of this round (each handle "
                "merges once: its stack is overwritten)")
        k_pad = self._k_pad(len(winners))
        if winners and max(winners) >= self.num_users:
            raise IndexError(f"winner id {max(winners)} out of range")
        idx, w = compact_weights(
            k_pad, pos, [self.clients[u].num_examples for u in winners])
        # one upload of the host-assembled (k_pad,) vectors per merge
        idx_d = torch.from_numpy(idx).to(self.device)
        uses_h = (merge_ctx is None and fault_ctx is None
                  and self.objective_needs_h())
        rows, idx_d, att_pos = self._merge_rows(
            trained, idx, idx_d, att_pos if uses_h else [])
        if fault_ctx is not None:
            new_glob = self._merge_fused_faults(
                state, rows, idx_d, winners, fault_ctx)
        else:
            w_d = torch.from_numpy(w).to(self.device)
            if merge_ctx is None and self.objective_active():
                obj = self._objective
                if obj.uses_server and self._obj_m is None:
                    self._obj_m = tree_map(torch.zeros_like, state)
                    self._obj_v = tree_map(torch.zeros_like, state)
                h = self._ensure_obj_h(state) if obj.uses_h else None
                new_glob, self._obj_m, self._obj_v = \
                    self._objective_merge(obj, state, rows, idx_d, w_d,
                                          w, (attempts, att_pos),
                                          self._obj_m, self._obj_v, h)
            elif merge_ctx is None:
                new_glob = self._fused_merge(rows, idx_d, w_d, state)
            else:
                # coefficients by user id; the pad slots take user 0's,
                # which their zero alpha masks
                uids = np.zeros(k_pad, np.int64)
                uids[:len(winners)] = winners
                coeffs = np.asarray(merge_ctx.coeffs, np.float32)[uids]
                new_glob = self._fused_merge_air(
                    rows, idx_d, w_d,
                    torch.from_numpy(coeffs).to(self.device),
                    float(merge_ctx.noise_sigma), merge_ctx.key)
        handle[key] = None               # buffer reused as the new stack
        # stays on device for round t+1
        self._resident = self._restack(new_glob, trained)
        self._resident_key = new_glob
        return new_glob

    def _merge_rows(self, stack, idx, idx_d, att_pos=(), lane=None):
        """The operands of a merge of ``stack`` (lane ``lane`` of a sweep
        stack): the rows, the (k_pad,) row ids ``idx`` (``idx_d`` on
        this device) and the FedDyn attempts' rows ``att_pos``. One
        chunk: the stack itself (the lane's view), with the ids as they
        are. Chunks over the mesh: the rows ``idx`` then ``att_pos``
        copied onto this device in that order, at positions ``0..k_pad
        - 1`` and after; the merge reads the same rows in the same order,
        so it gives the same bits. Returns ``(rows, idx_d', att_pos')``."""
        split = chunks_of(stack, lanes=lane is not None)
        if len(split.parts) == 1:
            part = split.parts[0]
            return (part if lane is None else self._lane(part, lane),
                    idx_d, list(att_pos))
        k_pad = len(idx)
        ids = np.concatenate([np.asarray(idx, np.int64),
                              np.asarray(att_pos, np.int64)])
        return (split.rows(ids, self.device, lane or 0),
                torch.arange(k_pad, dtype=idx_d.dtype, device=self.device),
                list(range(k_pad, k_pad + len(att_pos))))

    # ------------------------------- gather merge (stacked / ragged)
    def _gather_merge(self, state, handle, winners, merge_ctx, fault_ctx):
        """Eq. 1 on a stacked or ragged handle. The digital merge is one
        ``gather_combine`` a leaf: on a stacked handle straight out of
        the trained stack at the winners' row positions (no stacked
        copy; the same rows in the same delivery order as the
        reference's restack, so the same bits), on a ragged one over the
        stacked winners. The new global is fresh; no resident stack
        mirrors it, so the one of an earlier fused round is dropped."""
        self._resident = self._resident_key = None
        if fault_ctx is not None:
            return self._gather_merge_faults(state, handle, winners,
                                             fault_ctx)
        sizes = [self.clients[u].num_examples for u in winners]
        if merge_ctx is not None:
            return self._gather_merge_air(handle, sizes, winners, merge_ctx)
        if "stacked" in handle:
            trained = handle["stacked"]
            pos = [handle["index"][u] for u in winners]
        else:
            trained = self._stack_winners(handle, winners)
            pos = list(range(len(winners)))
        idx, w = compact_weights(self._k_pad(len(winners)), pos, sizes)
        with torch.no_grad():
            return self._average(trained, torch.from_numpy(idx).to(
                self.device), torch.from_numpy(w).to(self.device), state)

    def _stack_winners(self, handle, winners):
        """The winners' trained params as one (m, ...) stack, in
        delivery order."""
        if "stacked" in handle:
            rows = torch.as_tensor([handle["index"][u] for u in winners],
                                   dtype=torch.int64, device=self.device)
            return tree_map(lambda l: torch.index_select(l, 0, rows),
                            handle["stacked"])
        return tree_map(lambda *ls: torch.stack(ls),
                        *[handle[u] for u in winners])

    def _gather_merge_faults(self, state, handle, winners, ctx):
        """Robust merge over the stacked winners of a stacked or ragged
        handle (their fault-context weights and corruption factors),
        plus the stale group; also the stale-only round, where there is
        no fresh winner (``robust_merge`` takes ``trained=None``).
        Writes ``ctx.n_quarantined`` — one host sync a merge."""
        trained = weights = corrupt = None
        with torch.no_grad():
            if winners:
                trained = self._stack_winners(handle, winners)
                weights = np.asarray(ctx.weights, np.float32)[winners]
                corrupt = np.asarray(ctx.corrupt, np.float32)[winners]
            stale, stale_w = self._stale_group(ctx.stale, state)
            glob, nq = robust_merge(
                trained, weights, corrupt, state, stale, stale_w,
                quarantine=bool(ctx.quarantine),
                clip_norm=float(ctx.clip_norm))
        ctx.n_quarantined = int(nq)
        return glob

    def _gather_merge_air(self, handle, sizes, winners, merge_ctx):
        """AirComp over the stacked winners: alphas normalised over the
        winners, their power-control coefficients, and per leaf
        ``aircomp_combine`` with no ``idx`` and the noise plane
        ``sigma * self._noise_draw(key, i, shape, device)`` (none at
        ``sigma == 0``, which gives the bits of a zero plane)."""
        dev = self.device
        s = np.asarray(sizes, np.float64)
        alphas = torch.from_numpy((s / s.sum()).astype(np.float32)).to(dev)
        coeffs = torch.from_numpy(
            np.asarray(merge_ctx.coeffs, np.float32)[winners]).to(dev)
        sigma = float(merge_ctx.noise_sigma)
        sig = torch.tensor(sigma, dtype=torch.float32, device=dev)
        with torch.no_grad():
            stacked = self._stack_winners(handle, winners)
            merged = [
                kops.aircomp_combine(
                    leaf, alphas, coeffs,
                    sig * self._noise_draw(merge_ctx.key, i, leaf.shape[1:],
                                           dev) if sigma != 0.0 else None)
                for i, leaf in enumerate(tree_leaves(stacked))]
        return tree_unflatten(stacked, merged)

    # ------------------------------------------------ winner-sparse path
    # Contention-first rounds: Eq. 2 priorities come BEFORE selection,
    # then only the K winners train, as one compact (K_max, ...) stack,
    # and the fused merges reduce it by delivery position. Train FLOPs and
    # peak memory a round scale with K, not U.
    def sparse_capable(self) -> bool:
        return (self._mode == "sparse" and self._rect
                and bool(self._k_max))

    def sparse_priorities(self, state, need_priority: bool):
        """Pre-selection Eq. 2: ``(priorities (U,) f64, losses (U,) f64
        or None)``.

        ``"prepass"`` draws the round's FULL epoch permutations (every
        client's stream: the fused path's draws, kept for the winner
        retrain) and, when priorities are needed, trains a fresh (C, ...)
        broadcast of the global over each chunk of C = ``sparse_chunk``
        users and keeps only its losses and priorities (one host read a
        chunk; peak memory O(C · params) whatever U). Each row's bits are
        those of the fused round's row, so the priorities, the winners
        and the retrained winners are the fused path's. ``"stale"`` serves
        each user's last-trained priority from the cache (ones before its
        first contact) and draws nothing: O(K) work a round, the same
        winners in distribution only."""
        U = self.num_users
        if self._sparse_priority == "stale":
            if not need_priority:
                return np.ones(U), None
            if self._stale_prios is None:
                self._stale_prios = np.ones(U, np.float64)
            return self._stale_prios.copy(), None
        self._ensure_xstack()
        self._pending_big = big = self._draw_big()
        if not need_priority:
            return np.ones(U), None
        C = max(1, min(self._sparse_chunk, U))
        prios, losses = np.empty(U), np.empty(U)
        h = self._ensure_obj_h(state) if self.objective_needs_h() else None
        for lo in range(0, U, C):
            rows = np.arange(lo, min(lo + C, U))
            hc = (None if h is None
                  else tree_map(lambda x: x[lo:lo + len(rows)], h))
            trained, loss_c = self._train_rows(
                self._bcast(state, len(rows)),
                self._gather_rows(rows, big[rows]), state, hc)
            p = stacked_model_priorities(trained, state)
            both = torch.stack((p, loss_c.float())).cpu().numpy()
            prios[rows], losses[rows] = both.astype(np.float64)
        return prios, losses

    def sparse_train(self, state, winners: List[int]) -> TrainResult:
        """Compact winner training: the K_max rows (winners in delivery
        order, then pads at index 0 with zero merge weight) train on the
        winners' batches — from the prepass draws when present, else
        fresh winner-only draws from the winners' own streams — as one
        stack: the resident (K_max, ...) stack when it mirrors ``state``,
        else a fresh broadcast. The Eq. 2 priorities of the trained rows
        are always computed (``"stale"`` caches them). Returns a
        ``{"sparse_stack", "winners"}`` handle for ``merge``. A round
        with no winner and no draws trains nothing and consumes no
        stream: its handle is empty and the resident stack stays."""
        K, m = self._k_max, len(winners)
        if m > K:
            raise ValueError(f"{m} winners exceed k_max={K}")
        winners = [int(u) for u in winners]
        big, self._pending_big = self._pending_big, None
        if not m and big is None:
            return TrainResult(
                losses={}, priorities=np.ones(self.num_users),
                local_handle={"sparse_stack": None, "winners": []})
        self._ensure_xstack()
        rows = np.zeros(K, np.int64)
        rows[:m] = winners
        if big is not None:
            big_rows = big[rows]
        else:
            big_rows = self._draw_winner_perms(
                [self.clients[u]._rng for u in winners], K)
        resident = (self._resident if self._resident_key is state
                    else None)
        self._resident = self._resident_key = None
        h = None
        if self.objective_needs_h():
            # pad rows gather user 0's h: zero weight, row discarded
            r = torch.from_numpy(rows).to(self.device)
            h = tree_map(lambda x: x[r], self._ensure_obj_h(state))
        trained, loss_k, prios_k = self._train_chunks(
            state, resident, rows, big_rows, h, self._split_sparse)
        pk, lk = torch.stack((prios_k, loss_k.float())).cpu().numpy() \
            .astype(np.float64)
        if self._sparse_priority == "stale" and m:
            if self._stale_prios is None:
                self._stale_prios = np.ones(self.num_users, np.float64)
            self._stale_prios[rows[:m]] = pk[:m]
        return TrainResult(
            losses={u: float(lk[j]) for j, u in enumerate(winners)},
            priorities=np.ones(self.num_users),
            local_handle={"sparse_stack": trained, "winners": winners})

    def priority_cache_state(self):
        return (None if self._stale_prios is None
                else self._stale_prios.copy())

    def restore_priority_cache(self, state) -> None:
        if state is not None:
            self._stale_prios = np.asarray(state, np.float64).copy()

    # ---- checkpoint hooks --------------------------------------------
    def client_stream_states(self):
        return [copy.deepcopy(c._rng.bit_generator.state)
                for c in self.clients]

    def restore_client_streams(self, states) -> None:
        if states is None:
            return
        for c, s in zip(self.clients, states):
            c._rng.bit_generator.state = s

    # -------------------------------------------------- sweep round path
    # E independent experiments share every round's training: the
    # (E, U, ...) stack trains as E * U rows of the fused round's loop
    # (one ``fused_sgd`` launch a local step for every lane), and the
    # lanes' Eq. 2 priorities are one ``delta_norm_leaves`` call over the
    # E x L leaf list. The merge runs lane by lane through the fused
    # round's own merges, on each lane's (U, ...) view of the stack; one
    # broadcast copy a leaf then restacks every lane at once.
    def sweep_capable(self) -> bool:
        """Sweeps need the fused full-cohort shape: fused mode and a
        rectangular cohort (equal per-user example counts)."""
        return self._mode == "fused" and self._rect

    def _lane_stack(self, globs, rows: Optional[int] = None, split=None):
        """A fresh contiguous (E, rows, ...) stack (``rows`` defaults to
        the cohort size), lane e's rows all equal to ``globs[e]``; with
        ``split`` (0 or 1) a ``_Split`` of it over the mesh, along the
        lanes or the users."""
        R = self.num_users if rows is None else rows
        if split is not None:
            plan = self._plan(len(globs) if split == 0 else R, True)
            return _Split([
                self._lane_stack([_to(g, dev) for g in globs[lo:hi]], R)
                if split == 0 else
                self._lane_stack([_to(g, dev) for g in globs], hi - lo)
                for (lo, hi), dev in plan],
                [b for b, _ in plan], [d for _, d in plan], lanes=True,
                dim=split)
        return tree_map(
            lambda *ls: torch.stack(ls).unsqueeze(1).expand(
                (len(ls), R) + tuple(ls[0].shape)).contiguous(), *globs)

    def _new_sweep(self, globs, seeds, objectives, stream_states=None,
                   objective_state=None, sparse=False) -> SweepState:
        if sparse and not self.sweep_sparse_capable():
            raise ValueError(
                "sparse sweep needs round_mode='sparse' (k_max set) "
                "and a rectangular cohort")
        if not sparse and not self.sweep_capable():
            raise ValueError(
                "sweep needs round_mode='fused' and a rectangular "
                "cohort (equal per-user example counts)")
        self._ensure_xstack()
        rngs = [[client_rng(s, u) for u in range(self.num_users)]
                for s in seeds]
        for lane, states in zip(rngs, stream_states or []):
            for gen, gs in zip(lane, states):
                gen.bit_generator.state = gs
        split = None
        E, U = len(seeds), self.num_users
        if (not sparse and sweep_shardable(E, U, self._mesh)
                and self._mesh.shape[COHORT_AXIS] > 1):
            if self._devs is None:
                raise ValueError("a cohort split needs a mesh of devices, "
                                 "not a shape-only mesh")
            split = sweep_sharding(self._mesh, E, U)
        # a sparse sweep's (E, K_max, ...) stack first exists in a round
        st = SweepState(num_lanes=E, glob=list(globs),
                        stack=None if sparse else self._lane_stack(
                            globs, split=split),
                        rngs=rngs, split=split)
        table = build_objective_table(objectives or [])
        if table is not None:
            st.obj = table
            saved = objective_state or {}
            E, U = st.num_lanes, self.num_users

            def lanes(key):
                x = saved.get(key)
                if x is None:
                    return [tree_map(torch.zeros_like, g) for g in globs]
                return [self.to_device(tree_map(lambda a: a[e], x))
                        for e in range(E)]
            if table.use_srv:
                st.m, st.v = lanes("m"), lanes("v")
            if table.use_h:
                st.h = (self.to_device(saved["h"]) if saved.get("h")
                        is not None else tree_map(
                            lambda g: torch.zeros((E, U) + tuple(g.shape),
                                                  dtype=g.dtype,
                                                  device=self.device),
                            globs[0]))
        return st

    def sweep_init(self, init_params, seeds: Sequence[int],
                   objectives=None) -> SweepState:
        """Fresh sweep state: every lane starts from ``init_params``
        (shared: nothing writes into a global) with its own client
        streams, ``client_rng(seeds[e], u)`` — the streams a backend
        seeded with that spec's seed would own, which is what makes the
        lanes batch-draw-identical to sequential runs. ``objectives[e]``
        is lane e's ObjectiveSpec (None = plain); an all-plain sweep
        carries no objective state."""
        glob = self.init_state(init_params)
        return self._new_sweep([glob] * len(seeds), seeds, objectives)

    def sweep_restore(self, glob, stream_states, seeds: Sequence[int],
                      objectives=None, objective_state=None) -> SweepState:
        """Rebuild a ``SweepState`` from a checkpoint payload: ``glob``
        the host (E, ...) stack of the lanes' globals, ``stream_states``
        the matching ``sweep_stream_states`` snapshot, ``seeds`` the lane
        seeds (stream identity only — the restored positions override the
        origin), ``objective_state`` the ``sweep_objective_state``
        snapshot. Every leaf comes back in the global's dtype."""
        E = len(seeds)
        globs = [self.to_device(tree_map(lambda a: a[e], glob))
                 for e in range(E)]
        return self._new_sweep(globs, seeds, objectives, stream_states,
                               objective_state)

    def sweep_batches(self, st: SweepState):
        """(E * U, ep*nb, bs, ...) round batches, lane-major: the data
        stays on the device (``_ensure_xstack``) and only the (E, U,
        ep*take) index tensor is uploaded. Under a cohort split, one such
        tensor a chunk (its lanes, or its users of every lane), gathered
        onto its device."""
        E, U = st.num_lanes, self.num_users
        with trace.span("draw.perms", host_only=True):
            big = self._draw_perms(st.rngs)
        out = []
        with trace.span("draw.gather"):
            for (lo, hi), dev in self._plan(U if st.split == 1 else E,
                                            st.split is not None):
                if st.split == 1:
                    rows, b = np.tile(np.arange(lo, hi), E), big[:, lo:hi]
                else:
                    rows, b = np.tile(np.arange(U), hi - lo), big[lo:hi]
                out.append(self._gather_rows(rows, b.reshape(len(rows), -1),
                                             dev))
        return out[0] if len(out) == 1 else out

    def sweep_train(self, st: SweepState, batched,
                    need_priority: bool) -> SweepTrainResult:
        """ONE training pass for all E lanes: the (E, U, ...) stack, seen
        as E * U rows, runs the fused round's loop in place (an objective
        sweep: the per-lane law of ``objective_epoch_scan``, each lane's
        rows anchored to its own global); then the lanes' Eq. 2
        priorities. Under a cohort split each chunk (whole lanes, or
        every lane's share of the users) does the same on its device
        (made current, ``_on``), and the (E, U) losses and priorities are
        put together on this device. Returns device tensors: no host
        sync here."""
        E, U = st.num_lanes, self.num_users
        stack, st.stack = st.stack, None
        split = chunks_of(stack, lanes=True)
        if len(split.parts) == 1:
            batched = [batched]
        losses, prios = [], []
        for (part, lo, hi, dev, lanes), b in zip(split.chunks(), batched):
            with _on(dev):
                hc = None if st.h is None else tree_map(
                    lambda x: (x[lo:hi] if split.dim == 0
                               else x[:, lo:hi]).to(dev), st.h)
                losses.append(self._train_lanes(st, part, b, hc, lanes)
                              .to(self.device))
                if need_priority:
                    prios.append(self._sweep_priorities(
                        part, [_to(g, dev) for g in st.glob[lanes]])
                        .to(self.device))
        prios = (_cat(prios, split.dim) if need_priority
                 else torch.ones((E, U), dtype=torch.float32,
                                 device=self.device))
        return SweepTrainResult(trained=stack,
                                losses=_cat(losses, split.dim),
                                priorities=prios)

    def _train_lanes(self, st: SweepState, stack, batched, h=None,
                     lanes=slice(None)):
        """The (E, R, ...) lane stack trained IN PLACE as E * R rows of
        the local-SGD loop (``batched``: (E * R, ep*nb, bs, ...),
        lane-major); an objective sweep runs each lane's law on its own
        rows, anchored to its own global, with ``h`` the rows' (E, R,
        ...) FedDyn state. ``lanes``: the slice of the sweep's lanes the
        stack holds (all of them by default; a split chunk's own).
        Returns the (E, R) losses."""
        E, R = tree_leaves(stack)[0].shape[:2]
        # a view, so the loop trains the stack itself (h is only read)
        flat = tree_map(lambda x: x.view((E * R,) + tuple(x.shape[2:])),
                        stack)
        if st.obj is not None:
            run = self._obj_run(st.obj.use_h)
            dev = tree_leaves(stack)[0].device
            anchors = tree_map(lambda *ls: torch.stack(ls).to(dev),
                               *st.glob[lanes])
            extra = ((tree_map(lambda x: x.reshape(
                (E * R,) + tuple(x.shape[2:])), h),)
                if st.obj.use_h else ())
            _, losses = run(flat, batched, anchors, st.obj.prox[lanes],
                            *extra)
        else:
            _, losses = self._epoch_run(flat, batched)
        return losses[:, -self._nb:].mean(dim=1).view(E, R)

    @staticmethod
    def _sweep_priorities(trained, globs):
        """(E, U) f32 Eq. 2 priorities: ONE ``delta_norm_leaves`` call
        over the E x L list (lane e's (U, ...) view of every leaf against
        ``globs[e]``), then each lane's ratio product in leaf order."""
        E = len(globs)
        leaves = tree_leaves(trained)
        L = len(leaves)
        with torch.no_grad():
            d2, g2 = kops.delta_norm_leaves(
                [l[e] for e in range(E) for l in leaves],
                [g for e in range(E) for g in tree_leaves(globs[e])])
            return priority_product(d2.view(E, L, -1), g2.view(E, L, 1))

    def _lane(self, trained, e):
        """Lane e's (U, ...) view of the (E, U, ...) trained stack."""
        return tree_map(lambda p: p[e], trained)

    @staticmethod
    def _end_sweep_merge(st, trained, new_glob):
        """Every lane's rows of the trained buffer take its new global (a
        lane that did not merge, its old one): one broadcast copy a leaf
        over the whole (E, U, ...) stack (under a cohort split, a
        chunk). The buffer becomes the resident stack."""
        with torch.no_grad():
            for part, _, _, dev, lanes in chunks_of(trained,
                                                    lanes=True).chunks():
                globs = [_to(g, dev) for g in new_glob[lanes]]
                for l, *gs in zip(tree_leaves(part),
                                  *map(tree_leaves, globs)):
                    src = gs[0][None] if len(gs) == 1 else torch.stack(gs)
                    l.copy_(src.unsqueeze(1).expand_as(l))
        st.glob, st.stack = new_glob, trained

    def sweep_merge(self, st: SweepState, tr: SweepTrainResult,
                    idx: np.ndarray, w: np.ndarray, merge_ctx=None,
                    uids=None, attempts=None) -> None:
        """Eq. 1 for every lane, lane by lane on its view of the trained
        stack, through the fused round's digital, AirComp or objective
        merge: ``idx`` / ``w`` (E, k_pad) row indices (user ids on the
        dense sweep, delivery positions on the sparse one) and compact
        weights, zero-padded; ``merge_ctx`` the sweep's AirComp inputs
        ((E, U) coefficients, (E,) sigmas, one ``(entropy, t)`` noise key
        a lane); ``uids`` the (E, k_pad) user ids behind the slots (for
        the coefficient gather); ``attempts`` the per-lane attempt
        winners ``(uids, rows)`` for the FedDyn h update. A
        lane merges where a sequential run would: a nonzero weight, or
        attempts under an h-carrying objective; any other lane keeps its
        global — the reference's all-zero-weight guard, decided on the
        host, so its kernels are not launched. The trained buffer
        becomes the resident stack."""
        trained, tr.trained = tr.trained, None
        dev = self.device
        idx_d = torch.from_numpy(np.ascontiguousarray(idx)).to(dev)
        w_d = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        new_glob = []
        for e in range(st.num_lanes):
            glob = st.glob[e]
            obj = st.obj.specs[e] if st.obj is not None else None
            att, att_rows = ((attempts[0][e], attempts[1][e])
                             if attempts is not None else ([], []))
            uses_h = merge_ctx is None and obj is not None and obj.uses_h
            go = bool(np.any(w[e] != 0.0)) or (uses_h and len(att) > 0)
            if go:
                lane, ie, att_rows = self._merge_rows(
                    trained, idx[e], idx_d[e], att_rows if uses_h else [],
                    lane=e)
            if not go:
                new_glob.append(glob)
            elif merge_ctx is not None:
                coeffs = np.asarray(merge_ctx.coeffs[e], np.float32)[
                    np.asarray(uids[e], np.int64)]
                new_glob.append(self._fused_merge_air(
                    lane, ie, w_d[e], torch.from_numpy(coeffs).to(dev),
                    float(merge_ctx.noise_sigma[e]), merge_ctx.key[e]))
            elif obj is not None and not obj.is_plain:
                h = (None if st.h is None
                     else tree_map(lambda x: x[e], st.h))
                m = st.m[e] if st.m is not None else None
                v = st.v[e] if st.v is not None else None
                g, m, v = self._objective_merge(
                    obj, glob, lane, ie, w_d[e], w[e],
                    (att, att_rows), m, v, h)
                if st.m is not None:
                    st.m[e], st.v[e] = m, v
                new_glob.append(g)
            else:
                new_glob.append(self._fused_merge(lane, ie, w_d[e], glob))
        self._end_sweep_merge(st, trained, new_glob)

    def sweep_merge_faults(self, st: SweepState, tr: SweepTrainResult,
                           idx: np.ndarray, merged_all, ctxs) -> np.ndarray:
        """The robust merge for every lane, lane by lane through the fused
        round's ``_merge_fused_faults``: ``idx`` (E, k_pad) row indices,
        ``merged_all[e]`` lane e's merge candidates (delivery order),
        ``ctxs[e]`` its ``FaultMergeContext`` (dense weights and
        corruption, its own stale group). A lane with no candidate and
        no stale entry keeps its global, as a sequential run's round
        without a merge does. Returns the (E,) quarantine counts."""
        trained, tr.trained = tr.trained, None
        new_glob = []
        nq = np.zeros(st.num_lanes, np.int64)
        for e, (cand, ctx) in enumerate(zip(merged_all, ctxs)):
            if not (cand or ctx.stale):
                new_glob.append(st.glob[e])
                continue
            rows, ie, _ = self._merge_rows(
                trained, idx[e], torch.from_numpy(
                    np.ascontiguousarray(idx[e])).to(self.device), lane=e)
            new_glob.append(self._merge_fused_faults(
                st.glob[e], rows, ie, cand, ctx))
            nq[e] = ctx.n_quarantined
        self._end_sweep_merge(st, trained, new_glob)
        return nq

    def sweep_extract(self, tr: SweepTrainResult, e: int, u: int):
        """Lane e / row u's trained params as freshly materialized
        tensors, safe to hold across the merge that overwrites the
        trained stack — the stale-upload capture. On a sparse sweep ``u``
        is a compact POSITION, not a user id."""
        return tree_map(lambda p: p[0], chunks_of(tr.trained, lanes=True)
                        .rows([u], self.device, lane=e))

    # ------------------------------------ sweep twin of the sparse path
    def sweep_sparse_capable(self) -> bool:
        """Sparse sweeps need what a sparse run needs."""
        return self.sparse_capable()

    def sweep_sparse_init(self, init_params, seeds: Sequence[int],
                          objectives=None) -> SweepState:
        """A sparse sweep's state: the lanes' globals (all
        ``init_params``), their client streams (the dense sweep's seeding
        rule) and objective state; no cohort stack — the (E, K_max, ...)
        winner stack exists from the first round on."""
        glob = self.init_state(init_params)
        return self._new_sweep([glob] * len(seeds), seeds, objectives,
                               sparse=True)

    def _gather_lane_rows(self, rows, big):
        """(E * R, ep*nb, bs, ...) batches, lane-major, of the (E, R)
        user ids ``rows`` under the (E, R, ep*take) draws ``big``."""
        E, R = rows.shape
        return self._gather_rows(rows.reshape(E * R),
                                 big.reshape(E * R, -1))

    def sweep_sparse_priorities(self, st: SweepState, need_priority: bool):
        """The sweep twin of ``sparse_priorities``: ``(priorities (E, U)
        f64, losses (E, U) f64 or None)``. ``"prepass"`` draws every
        lane's full round (kept in ``st.pending`` for the retrain), then
        trains each chunk of C users for every lane as E * C rows of one
        loop (each lane's objective law, anchored to its global), one
        ``delta_norm_leaves`` call and one host read a chunk;
        ``"stale"`` serves the sweep's (E, U) cache."""
        E, U = st.num_lanes, self.num_users
        if self._sparse_priority == "stale":
            if not need_priority:
                return np.ones((E, U)), None
            if st.prio_cache is None:
                st.prio_cache = np.ones((E, U), np.float64)
            return st.prio_cache.copy(), None
        with trace.span("draw.perms", host_only=True):
            st.pending = big = self._draw_perms(st.rngs)
        if not need_priority:
            return np.ones((E, U)), None
        C = max(1, min(self._sparse_chunk, U))
        prios, losses = np.empty((E, U)), np.empty((E, U))
        for lo in range(0, U, C):
            hi = min(lo + C, U)
            rows = np.broadcast_to(np.arange(lo, hi), (E, hi - lo))
            stack = self._lane_stack(st.glob, hi - lo)
            hc = (None if st.h is None
                  else tree_map(lambda x: x[:, lo:hi], st.h))
            loss_c = self._train_lanes(
                st, stack, self._gather_lane_rows(rows, big[:, lo:hi]), hc)
            p = self._sweep_priorities(stack, st.glob)
            both = torch.stack((p, loss_c.float())).cpu()
            trace.synced(p.device)
            prios[:, lo:hi], losses[:, lo:hi] = both.numpy().astype(
                np.float64)
        return prios, losses

    def sweep_sparse_train(self, st: SweepState,
                           winners_all) -> SweepTrainResult:
        """Compact winner training for every lane at once:
        ``winners_all[e]`` is lane e's delivery-ordered winner list. The
        (E, K_max, ...) stack — the resident one, else a fresh broadcast —
        trains as E * K_max rows (pads at index 0, zero weight), on the
        prepass draws or, under ``"stale"``, on winner-only draws from
        each lane's own streams; then every lane's priorities in one
        ``delta_norm_leaves`` call (``"stale"`` caches them: one host
        read). Every array of the result is POSITION-indexed (E, K_max)."""
        E, U, K = st.num_lanes, self.num_users, self._k_max
        big, st.pending = st.pending, None
        rows = np.zeros((E, K), np.int64)
        for e, ws in enumerate(winners_all):
            if len(ws) > K:
                raise ValueError(f"{len(ws)} winners exceed k_max={K}")
            rows[e, :len(ws)] = [int(u) for u in ws]
        if big is not None:
            big_rows = big[np.arange(E)[:, None], rows]
        else:
            big_rows = np.stack([
                self._draw_winner_perms([st.rngs[e][int(u)] for u in ws], K)
                for e, ws in enumerate(winners_all)])
        stack = (st.stack if st.stack is not None
                 else self._lane_stack(st.glob, K))
        st.stack = None
        h = None
        if st.h is not None:
            # pad rows gather user 0's h: zero weight, row discarded
            lanes = torch.arange(E, device=self.device)[:, None]
            r = torch.from_numpy(rows).to(self.device)
            h = tree_map(lambda x: x[lanes, r], st.h)
        loss_k = self._train_lanes(
            st, stack, self._gather_lane_rows(rows, big_rows), h)
        tr = SweepTrainResult(trained=stack, losses=loss_k,
                              priorities=self._sweep_priorities(stack,
                                                                st.glob))
        if self._sparse_priority == "stale":
            if st.prio_cache is None:
                st.prio_cache = np.ones((E, U), np.float64)
            pk, _ = tr.read()
            for e, ws in enumerate(winners_all):
                st.prio_cache[e, rows[e, :len(ws)]] = pk[e, :len(ws)]
        return tr

    def sweep_global(self, st: SweepState, e: int):
        """Lane e's current global params."""
        return st.glob[e]

    def sweep_globals(self, st: SweepState):
        """Every lane's global as one (E, ...) stacked pytree (fresh)."""
        return tree_map(lambda *ls: torch.stack(ls), *st.glob)

    def sweep_stream_states(self, st: SweepState):
        """Per-lane / per-user batch-stream snapshots. The engine takes
        this BEFORE drawing the next round's batches, so a resumed run
        replays the exact permutations the uninterrupted run drew."""
        return [[copy.deepcopy(g.bit_generator.state) for g in lane]
                for lane in st.rngs]

    def sweep_objective_state(self, st: SweepState):
        """Checkpoint form of a sweep's objective state: host numpy (E,
        ...) m / v and (E, U, ...) h (None for a piece the sweep does not
        carry), or None for an all-plain sweep."""
        if st.obj is None:
            return None

        def stacked(x):
            return None if x is None else params_to_numpy(
                tree_map(lambda *ls: torch.stack(ls), *x))
        return {"m": stacked(st.m), "v": stacked(st.v),
                "h": None if st.h is None else params_to_numpy(st.h)}

    def sweep_adopt_streams(self, st: SweepState, e: int) -> None:
        """Adopt lane e's batch rng streams as the clients' own: after an
        E = 1 delegated ``run`` the advanced generators go back, so
        continuing per round draws where a pure per-round run would."""
        for u, c in enumerate(self.clients):
            c._rng = st.rngs[e][u]


class SiloBackend(Backend):
    """Cross-silo path: one FL "user" per silo (``core/silo.py``).

    Training and Eq. 2 run once a round as a merge-free
    ``make_fl_round_step`` pass (``vmap`` over the silo axis on the
    device, the fused SGD step, ``delta_norm``; nothing crosses between
    silos); ``merge`` then applies ``make_silo_merge`` to the *already
    trained* local stack with the selection's alpha weights, so only the
    winners' deltas cross. Since the whole cohort trains in one step,
    ``trains_before_selection`` strategies still train every silo —
    selection gates only the merge traffic (the quantity the paper
    meters). A round's batch is silo s's rows ``t * B .. (t + 1) * B``
    (mod its length). No sweep, no round modes; AirComp and the fault
    layer's robust merge are refused. ``device``: where the silos live
    (``None`` is the CUDA device and raises without one; ``"cpu"`` runs
    on the CPU).
    """

    def __init__(self, model_cfg, token_data: Sequence[np.ndarray], *,
                 lr: float = 1e-2, batch_size: int = 4,
                 long_context: bool = False, merge_dtype: str = "float32",
                 device=None):
        from repro_torch.core.silo import (make_fl_round_step,
                                           make_silo_merge, stack_for_silos)
        self.num_users = len(token_data)
        self.heterogeneity = np.zeros(self.num_users)
        self.device = resolve_device(device)
        self._data = [np.asarray(d) for d in token_data]
        self._batch_size = batch_size
        self._stack = stack_for_silos
        self._train = make_fl_round_step(
            model_cfg, lr=lr, long_context=long_context, do_merge=False)
        self._merge_stacked = make_silo_merge(merge_dtype)

    def init_state(self, init_params):
        """The silo-stacked state: ``init_params`` on the device, expanded
        over the silo axis."""
        return self._stack(tree_map(
            lambda p: torch.as_tensor(p).detach().to(self.device),
            init_params), self.num_users)

    def num_examples(self, u):
        return len(self._data[u])

    def global_params(self, state):
        return tree_map(lambda p: p[0], state)

    def _round_batch(self, t):
        B = self._batch_size
        rows = []
        for d in self._data:
            idx = np.arange(t * B, (t + 1) * B) % len(d)
            rows.append(d[idx])
        return {"tokens": torch.from_numpy(np.stack(rows)).to(self.device)}

    def train_round(self, state, t, train_ids, need_priority):
        batch = self._round_batch(t)
        # merge-free pass: per-silo losses + trained locals + priorities,
        # no traffic between silos; the locals are kept for the merge
        loss_vec, local, prios = self._train(
            state, batch, torch.zeros((self.num_users,), device=self.device))
        priorities = np.ones(self.num_users)
        if need_priority:
            priorities = prios.double().cpu().numpy().copy()
        loss_np = loss_vec.detach().cpu().numpy()
        return TrainResult(losses={u: float(loss_np[u]) for u in train_ids},
                           priorities=priorities, local_handle=local)

    def merge(self, state, train_result, winners, merge_ctx=None,
              fault_ctx=None, attempts=None):
        if merge_ctx is not None:
            raise ValueError(
                "SiloBackend implements only the digital cross-silo "
                "merge; merge_backend='aircomp' needs HostBackend")
        if fault_ctx is not None:
            raise ValueError(
                "SiloBackend implements no robust merge guard; "
                "FaultSpec merge guards need HostBackend")
        alphas = winner_alphas(self.num_users, winners,
                               [self.num_examples(u) for u in winners])
        with torch.no_grad():
            return self._merge_stacked(
                train_result.local_handle, self.global_params(state),
                torch.from_numpy(alphas).to(self.device))
