"""The paper's FL round, computed plainly (Fig. 1, Steps 1-5).

Per round: every user trains a copy of the global with one SGD step a
batch over its epoch's batches (``batch`` examples drawn by its own
permutation stream); Eq. 2 gives each trained model's priority
``prod_l (1 + min(||w_l - g_l|| / ||g_l||, 1))`` over the leaves in
sorted-name order; Eq. 3 gives each user the window ``N / priority`` and
the backoff ``R * W`` from the engine stream; users whose upload share
reached the threshold refrain (Step 4); slotted CSMA/CA picks the first
``k`` deliveries; Eq. 1 merges the winners' models in delivery order
with weights ``|D_k| / sum |D|``; the counter counts the uploads.

``Reference.run`` returns one record a round (see ``RoundRecord``). It
selects by its own priorities, or by priorities it is handed: a window
is ``N / priority`` quantised to 20 us slots, so a priority that differs
from another in its last f32 bit can move a backoff across a slot
boundary and legitimately change the winners; handed the program's
priorities (which ``judge`` compares with the reference's own), the
reference's selection is the check of the program's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import csma, rngs
from .ops import Ops, set_tf32_off


@dataclass
class RoundRecord:
    """One round: the users' mean losses of their last epoch, their
    losses on the round's first batch (before its first step) and Eq. 2
    priorities, (U,) float64; the winners in delivery order; the norms
    ``||w_{u,l} - g_l||`` of each trained model's change from the round's
    global, (U, L) float64; the merged global, host float32 arrays by
    leaf name (sorted)."""
    loss: np.ndarray
    first_loss: np.ndarray
    prio: np.ndarray
    winners: List[int]
    local: np.ndarray
    glob: Dict[str, np.ndarray]


def change_norms(stack, glob, rows: int = 64) -> np.ndarray:
    """(U, L) float64 norms of ``stack[l][u] - glob[l]`` (leaves in
    sorted order), summed in float64 a block of ``rows`` users at a
    time."""
    names = sorted(glob)
    U = stack[names[0]].shape[0]
    out = np.zeros((U, len(names)))
    for j, k in enumerate(names):
        g = glob[k].double()
        for lo in range(0, U, rows):
            d = stack[k][lo:lo + rows].double() - g
            out[lo:lo + rows, j] = d.reshape(d.shape[0], -1).pow(2).sum(
                dim=1).sqrt().cpu().numpy()
    return out


def priorities(local: np.ndarray, glob) -> np.ndarray:
    """Eq. 2 from the change norms and the round's global (float64)."""
    gn = np.array([float(glob[k].double().pow(2).sum().sqrt())
                   for k in sorted(glob)])
    ratio = np.minimum(local / np.maximum(gn, 1e-12)[None], 1.0)
    return np.prod(1.0 + ratio, axis=1)


class Reference:
    """The checked rounds of one cell.

    ``model``: the configuration's plain reference module (``shapes``,
    ``losses_and_grads``); ``cell``: the workload's ``spec`` dict (the
    ``ExperimentSpec`` fields it sets, by their names); ``x`` / ``y``:
    the users' host data, (U, n, ...) float32 / (U, n) integer; ``init``:
    the initial global, leaf name -> tensor; ``ops``: its products
    (``Ops(tf32=True)`` is the control); ``batch_frac`` < 1 trains on the
    first part of each batch (a planted fault)."""

    def __init__(self, model, cell, x, y, init, seed: int, device,
                 ops: Optional[Ops] = None, batch_frac: float = 1.0):
        set_tf32_off()
        self.model, self.cell, self.seed = model, cell, int(seed)
        self.device = torch.device(device)
        self.ops = ops or Ops()
        self.batch_frac = batch_frac
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        self.glob = {k: torch.as_tensor(v).to(self.device, torch.float32)
                     .clone() for k, v in sorted(init.items())}
        U = self.x.shape[0]
        self.clients = [rngs.client_rng(seed, u) for u in range(U)]
        self.engine = rngs.engine_rng(seed)
        self.strategy = rngs.strategy_rng(seed)
        self.entropy = rngs.strategy_entropy(seed)
        self.uploads = np.zeros(U, np.int64)
        self.total = 0
        self.calls = 0

    # ---------------------------------------------------------- Step 2
    def _draws(self):
        c = self.cell
        n, bs = self.x.shape[1], c["batch_size"]
        take = (n // bs) * bs
        return np.stack([np.concatenate([g.permutation(n)[:take]
                                         for _ in range(c["local_epochs"])])
                         for g in self.clients])

    def _train(self):
        c = self.cell
        U, bs = self.x.shape[0], c["batch_size"]
        nb = self.x.shape[1] // bs
        perms = torch.from_numpy(self._draws()).to(self.device)
        rows = torch.arange(U, device=self.device)[:, None]
        lr = torch.tensor(c["lr"], dtype=torch.float32, device=self.device)
        stack = {k: v.unsqueeze(0).expand((U,) + tuple(v.shape)).clone()
                 for k, v in self.glob.items()}
        keep = max(1, int(bs * self.batch_frac))
        losses = []
        for i in range(perms.shape[1] // bs):
            idx = perms[:, i * bs:i * bs + keep]
            loss, grads = self.model.losses_and_grads(
                stack, self.x[rows, idx], self.y[rows, idx], self.ops)
            with torch.no_grad():
                stack = {k: stack[k] - lr * grads[k] for k in stack}
            losses.append(loss)
        last = torch.stack(losses[-nb:], dim=1).double().mean(dim=1)
        return stack, last.cpu().numpy(), losses[0].double().cpu().numpy()

    # ------------------------------------------------------ Steps 3-5
    def _select(self, prio: np.ndarray) -> List[int]:
        c = self.cell
        U = len(prio)
        shares = self.uploads / max(self.total, 1)
        part = (shares < c["counter_threshold"] if c["use_counter"]
                else np.ones(U, bool))
        if not part.any():
            part = np.ones(U, bool)
        p = np.where(np.isnan(prio), 0.0, prio)
        windows = c["cw_base"] / np.maximum(p, 1e-9)
        backoff = self.engine.uniform(0.0, 1.0, size=U) * windows
        b_s, w_s = backoff * csma.SLOT_S, windows * csma.SLOT_S
        if c["contention_backend"] == "device":
            winners = csma.contend_device(b_s, w_s, c["k_per_round"], part,
                                          self.entropy, self.calls)
        else:
            winners = csma.contend_numpy(b_s, w_s, c["k_per_round"], part,
                                         self.strategy)
        self.calls += 1
        return winners

    def _merge(self, stack, winners, n_examples: int):
        if not winners:
            return dict(self.glob)
        sizes = np.full(len(winners), float(n_examples))
        w = (sizes / sizes.sum()).astype(np.float32)
        out = {}
        for k, s in stack.items():
            acc = torch.zeros_like(self.glob[k])
            for j, u in enumerate(winners):
                acc = acc + s[u] * float(w[j])
            out[k] = acc
        return out

    def run(self, rounds: int, select_by: Optional[List[np.ndarray]] = None
            ) -> List[RoundRecord]:
        """``rounds`` rounds from the current global. ``select_by[r]``:
        the (U,) priorities that select round r's winners (None: the
        reference's own)."""
        out = []
        for r in range(rounds):
            stack, loss, first = self._train()
            local = change_norms(stack, self.glob)
            prio = priorities(local, self.glob)
            winners = self._select(prio if select_by is None
                                   else np.asarray(select_by[r], np.float64))
            for u in winners:
                self.uploads[u] += 1
            self.total += len(winners)
            self.glob = self._merge(stack, winners, self.x.shape[1])
            del stack
            out.append(RoundRecord(
                loss=loss, first_loss=first, prio=prio,
                winners=list(winners), local=local,
                glob={k: v.cpu().numpy() for k, v in self.glob.items()}))
        return out
