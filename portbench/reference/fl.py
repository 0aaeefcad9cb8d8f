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

The users train one after another: the device holds the global, one
user's model, its gradients and activations, and each trained model
waits on the host (pinned memory on the card) for the merge. The
parameters are held in the configuration's ``param_dtype``: a weight
kept in bf16 is rounded to it after every SGD step and after the merge
(the products and sums themselves run in f32).

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

#: elements of a leaf summed in f64 at a time (bounds the sums' memory)
BLOCK = 1 << 24


@dataclass
class RoundRecord:
    """One round: the users' mean losses of their last epoch, their
    losses on the round's first batch (before its first step) and Eq. 2
    priorities, (U,) float64; the winners in delivery order; the norms
    ``||w_{u,l} - g_l||`` of each trained model's change from the round's
    global, (U, L) float64; the norms ``||G_l - G0_l||`` of the merged
    global's change from the initial global, (L,) float64 (leaves in
    sorted name order)."""
    loss: np.ndarray
    first_loss: np.ndarray
    prio: np.ndarray
    winners: List[int]
    local: np.ndarray
    change: np.ndarray


def _sq_dist(a: torch.Tensor, b) -> torch.Tensor:
    """``sum((a - b)^2)`` in f64, a block of ``BLOCK`` elements at a
    time; ``b`` a tensor, or a host array copied to ``a``'s device a
    block at a time."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=a.device)
    for lo in range(0, a.numel(), BLOCK):
        blk = b[lo:lo + BLOCK]
        if isinstance(blk, np.ndarray):
            blk = torch.from_numpy(blk)
        d = a[lo:lo + BLOCK].double() - blk.to(a.device).double()
        acc += d.pow(2).sum()
    return acc


def leaf_norms(model: Dict[str, torch.Tensor], glob) -> np.ndarray:
    """(L,) float64 norms of ``model[l] - glob[l]`` (leaves in sorted
    order), summed on ``model``'s device; ``glob`` tensors, or host
    arrays (a global's change from the initial global's host copy)."""
    names = sorted(glob)
    return torch.stack([_sq_dist(model[k], glob[k]) for k in names]
                       ).sqrt().cpu().numpy()


def change_norms(stack, glob) -> np.ndarray:
    """(U, L) float64 norms of ``stack[l][u] - glob[l]``, a user at a
    time."""
    U = next(iter(stack.values())).shape[0]
    return np.stack([leaf_norms({k: v[u] for k, v in stack.items()}, glob)
                     for u in range(U)])


def priorities(local: np.ndarray, glob) -> np.ndarray:
    """Eq. 2 from the change norms and the round's global (float64)."""
    gn = np.array([float(glob[k].double().pow(2).sum().sqrt())
                   for k in sorted(glob)])
    ratio = np.minimum(local / np.maximum(gn, 1e-12)[None], 1.0)
    return np.prod(1.0 + ratio, axis=1)


def _park(model: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A host copy of one user's model (pinned when it is on the card)."""
    out = {}
    for k, v in model.items():
        h = torch.empty(v.shape, dtype=v.dtype,
                        pin_memory=v.device.type == "cuda")
        out[k] = h.copy_(v)
    return out


class Reference:
    """The checked rounds of one cell.

    ``cell``: the cell (its kind takes the batches to the configuration's
    reference module; its workload's ``spec`` sets the round);
    ``inputs``: the run's inputs (the users' host data, the initial global
    as host f32); ``ops``: its products (``ops.control(cfg)`` is the
    control); ``batch_frac`` < 1 trains on the first part of each batch
    (a planted fault)."""

    def __init__(self, cell, inputs, seed: int, device,
                 ops: Optional[Ops] = None, batch_frac: float = 1.0):
        set_tf32_off()
        self.cell, self.spec, self.seed = cell, cell.spec, int(seed)
        self.device = torch.device(device)
        self.ops = ops or Ops()
        self.batch_frac = batch_frac
        self.held = getattr(torch, cell.param_dtype)
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v))
                     .to(self.device) for k, v in inputs.users.items()}
        self.start = inputs.init_host
        self.glob = {k: torch.as_tensor(v).to(self.device, torch.float32)
                     .clone() for k, v in sorted(inputs.init_host.items())}
        U = inputs.num_users
        self.n = next(iter(self.data.values())).shape[1]
        self.clients = [rngs.client_rng(seed, u) for u in range(U)]
        self.engine = rngs.engine_rng(seed)
        self.strategy = rngs.strategy_rng(seed)
        self.entropy = rngs.strategy_entropy(seed)
        self.uploads = np.zeros(U, np.int64)
        self.total = 0
        self.calls = 0

    # ---------------------------------------------------------- Step 2
    def _draws(self):
        c = self.spec
        bs = c["batch_size"]
        take = (self.n // bs) * bs
        return np.stack([np.concatenate([g.permutation(self.n)[:take]
                                         for _ in range(c["local_epochs"])])
                         for g in self.clients])

    def _batches(self):
        """Each step's (U, keep) example indices."""
        bs = self.spec["batch_size"]
        perms = torch.from_numpy(self._draws()).to(self.device)
        keep = max(1, int(bs * self.batch_frac))
        return [perms[:, i * bs:i * bs + keep]
                for i in range(perms.shape[1] // bs)]

    def _hold(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (f32) rounded in place to the parameters' dtype."""
        if self.held != torch.float32:
            t.copy_(t.to(self.held))
        return t

    def _step(self, stack, batch, lr):
        """One SGD step of ``stack`` (1, ...) in place; the loss (1,)."""
        loss, grads = self.cell.kind.reference_step(self.cell, stack, batch,
                                                    self.ops)
        with torch.no_grad():
            for k in stack:
                self._hold(stack[k].sub_(grads[k].mul_(lr)))
        return loss

    def _train(self):
        """The round's local SGD, a user at a time: ``(losses (steps, U),
        local (U, L), row)``, ``row(u, k)`` user u's trained leaf k on the
        device."""
        lr = torch.tensor(self.spec["lr"], dtype=torch.float32,
                          device=self.device)
        steps = self._batches()
        U = len(self.clients)
        losses, local, parked = [], [], []
        for u in range(U):
            model = {k: v.clone().unsqueeze(0) for k, v in self.glob.items()}
            losses.append(torch.stack([
                self._step(model, {k: d[u][idx[u]][None]
                                   for k, d in self.data.items()}, lr)
                for idx in steps]))
            local.append(leaf_norms({k: v[0] for k, v in model.items()},
                                    self.glob))
            parked.append(_park({k: v[0] for k, v in model.items()}))
            del model
        return (torch.cat(losses, dim=1), np.stack(local),
                lambda u, k: parked[u][k].to(self.device))

    # ------------------------------------------------------ Steps 3-5
    def _select(self, prio: np.ndarray) -> List[int]:
        c = self.spec
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

    def _merge(self, row, winners):
        """Eq. 1 over the winners' trained leaves ``row(u, k)``."""
        if not winners:
            return dict(self.glob)
        sizes = np.full(len(winners), float(self.n))
        w = (sizes / sizes.sum()).astype(np.float32)
        out = {}
        for k in self.glob:
            acc = torch.zeros_like(self.glob[k])
            for j, u in enumerate(winners):
                acc = acc + row(u, k) * float(w[j])
            out[k] = self._hold(acc)
        return out

    def run(self, rounds: int, select_by: Optional[List[np.ndarray]] = None
            ) -> List[RoundRecord]:
        """``rounds`` rounds from the current global. ``select_by[r]``:
        the (U,) priorities that select round r's winners (None: the
        reference's own)."""
        out = []
        nb = self.n // self.spec["batch_size"]
        for r in range(rounds):
            losses, local, row = self._train()
            prio = priorities(local, self.glob)
            winners = self._select(prio if select_by is None
                                   else np.asarray(select_by[r], np.float64))
            for u in winners:
                self.uploads[u] += 1
            self.total += len(winners)
            self.glob = self._merge(row, winners)
            del row
            out.append(RoundRecord(
                loss=losses[-nb:].double().mean(dim=0).cpu().numpy(),
                first_loss=losses[0].double().cpu().numpy(), prio=prio,
                winners=list(winners), local=local,
                change=leaf_norms(self.glob, self.start)))
        return out
