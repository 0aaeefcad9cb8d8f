"""FLEngine — the single public orchestrator for FL rounds (Fig. 1).

One round, regardless of strategy or backend:

  1. counter refrain mask (Step 4) — upload shares are computed ONCE
     per round and passed through (mask + SelectionContext.counter_values);
  2. train everyone (Step 2) and compute Eq. 2 priorities (Step 3);
  3. strategy.select over the SelectionContext (Step 4/5 contention);
  4. backend.merge of the winners (Eq. 1);
  5. counter + history update — including the contention's collision
     and airtime stats.

There is deliberately no strategy-name branching here: behaviour
differences ride entirely on the Strategy capability flags and the
Backend contract.

This is the per-round loop of the reference engine. Its sweep path
(``run_sweep``, the E = 1 delegation of ``run``), checkpoint/resume,
the channel and fault layers and strategies that select before training
are not ported yet: each raises ``NotImplementedError`` naming what is
missing. The reference pins the sweep lane and the per-round loop to
the same winners and globals, so this loop is the sequential reference
of both.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.counter import FairnessCounter
from repro_torch.core.rngs import engine_rng, strategy_seed
from repro_torch.engine.backends import Backend
from repro_torch.engine.registry import create_strategy
from repro_torch.engine.spec import ExperimentSpec
from repro_torch.engine.types import FLHistory, SelectionContext
from repro_torch.tree import tree_leaves


def _reject_unported(spec: ExperimentSpec) -> None:
    """Raise for every spec option whose subsystem is not ported."""
    if spec.channel is not None:
        raise NotImplementedError(
            "spec.channel: the wireless channel layer is not ported yet")
    if spec.faults is not None:
        raise NotImplementedError(
            "spec.faults: the fault-tolerance layer is not ported yet")
    if spec.merge_backend != "fedavg":
        raise NotImplementedError(
            f"merge_backend={spec.merge_backend!r}: the AirComp merge is "
            "not ported yet")
    if spec.objective is not None and not spec.objective.is_plain:
        raise NotImplementedError(
            "spec.objective: non-plain objectives are not ported yet")


def _record_time(history, spec, elapsed_slots):
    """Append the round's wall-clock accounting: contention slots at
    ``slot_duration_s`` (no channel layer: no payload airtime, no
    transmit energy)."""
    secs = elapsed_slots * spec.slot_seconds()
    history.round_seconds.append(secs)
    history.cumulative_seconds.append(
        (history.cumulative_seconds[-1] if history.cumulative_seconds
         else 0.0) + secs)
    history.round_energy_j.append(0.0)


class FLEngine:
    """One FL run: spec x strategy (registry) x backend."""

    def __init__(self, spec: ExperimentSpec, backend: Backend, init_params,
                 eval_fn: Optional[Callable] = None):
        _reject_unported(spec)
        self.spec = spec
        self.backend = backend
        self.eval_fn = eval_fn
        self.num_users = backend.num_users
        self.counter = FairnessCounter(self.num_users,
                                       spec.counter_threshold)
        # engine rng and strategy/simulator rng are INDEPENDENT spawn
        # children of the spec seed (core.rngs)
        self.strategy = create_strategy(
            spec.strategy, csma_config=spec.csma,
            seed=strategy_seed(spec.seed),
            contention_backend=spec.contention_backend,
            **spec.strategy_options)
        sim = getattr(self.strategy, "_sim", None)
        if sim is not None:
            # device contention runs where the cohort lives
            sim.device = backend.device
        if self.strategy.trains_before_selection:
            raise NotImplementedError(
                f"strategy {spec.strategy!r} selects before training "
                "(partial-cohort rounds): it needs the stacked round "
                "path, which is not ported yet")
        self._rng = engine_rng(spec.seed)
        self.state = backend.init_state(init_params)

    # ------------------------------------------------------------------
    @property
    def global_params(self):
        return self.backend.global_params(self.state)

    def _context(self, priorities: np.ndarray, participating: np.ndarray,
                 t: int, shares: np.ndarray) -> SelectionContext:
        return SelectionContext(
            priorities=priorities, participating=participating,
            k_target=self.spec.k_per_round, rng=self._rng,
            cw_base=self.spec.cw_base,
            counter_values=shares,
            heterogeneity=self.backend.heterogeneity,
            snr_db=None,
            round_index=t)

    # ------------------------------------------------------------------
    def run_round(self, t: int, history: FLHistory) -> List[int]:
        """One round through the backend contract
        (train_round / merge)."""
        spec, strat = self.spec, self.strategy
        # upload shares: computed once, reused for the refrain mask AND
        # the SelectionContext
        shares = self.counter.values()
        participating = (self.counter.participating(shares)
                         if spec.use_counter
                         else np.ones(self.num_users, bool))
        if not participating.any():      # degenerate threshold: reset mask
            participating = np.ones(self.num_users, bool)

        train_ids = list(range(self.num_users))
        tr = self.backend.train_round(
            self.state, t, train_ids, need_priority=strat.uses_priority)
        sel = strat.select(self._context(
            tr.priorities, participating, t, shares))

        # contention winners are upload attempts; with no channel layer
        # every attempt is delivered
        winners = [int(u) for u in sel.winners]
        delivered = list(winners)
        if delivered:
            self.state = self.backend.merge(self.state, tr, delivered,
                                            attempts=winners)
        if winners:
            self.counter.update(winners, len(winners))
            history.uploads_total += len(winners)
            for u in winners:
                history.selections[u] += 1
        history.winners.append(winners)
        history.delivered.append(delivered)
        history.collisions += sel.collisions
        history.contention_slots += sel.elapsed_slots
        _record_time(history, spec, sel.elapsed_slots)
        if strat.uses_priority:
            # one vectorized conversion — per-element float() is O(U)
            history.priorities.append(
                np.asarray(tr.priorities, np.float64)[train_ids].tolist())
        if tr.losses is not None and len(tr.losses):
            # dict (partial-cohort rounds) or dense (U,) vector (fused)
            vals = (list(tr.losses.values())
                    if isinstance(tr.losses, dict) else tr.losses)
            history.train_loss.append(float(np.mean(vals)))
        return winners

    # ------------------------------------------------------------------
    def run(self, verbose: bool = False, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0) -> FLHistory:
        """Run the spec's rounds, one ``run_round`` each."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir: checkpoint / resume is not ported yet")
        del checkpoint_every
        spec = self.spec
        history = FLHistory(
            selections=np.zeros(self.num_users, np.int64))
        for t in range(spec.rounds):
            self.run_round(t, history)
            if self.eval_fn is not None and (
                    t % spec.eval_every == 0 or t == spec.rounds - 1):
                acc = float(self.eval_fn(self.global_params))
                history.accuracy.append(acc)
                history.eval_round.append(t)
                if verbose:
                    print(f"[{spec.strategy}] round {t:4d} "
                          f"acc {acc:.4f}"
                          + (f" loss {history.train_loss[-1]:.4f}"
                             if history.train_loss else ""))
        return history

    def run_sweep(self, sweep, **kwargs):
        raise NotImplementedError(
            "run_sweep: the sweep path is not ported yet; run the cells "
            "one by one through run()")


#: the reference auto-selects its winner-sparse round path when the
#: winner budget is at least this many times smaller than the cohort
SPARSE_AUTO_RATIO = 8


def build_host_engine(spec: ExperimentSpec, init_params, loss_fn,
                      user_data, eval_fn=None, *,
                      round_mode: str = None, mesh=None,
                      device=None) -> FLEngine:
    """Convenience: spec + host data -> engine over HostBackend.

    ``round_mode`` (argument, else ``spec.round_mode``) picks the
    backend round path; only ``"fused"`` is ported. When BOTH are None
    the reference auto-selects ``"sparse"`` for a rectangular cohort
    with ``k_per_round * SPARSE_AUTO_RATIO <= num_users``; the port
    raises there instead of quietly running another path — pass
    ``round_mode="fused"`` to run such a cohort dense. ``device=None``
    is the CUDA device (raises without one); ``"cpu"`` runs on the CPU.
    """
    from repro_torch.engine.backends import HostBackend
    _reject_unported(spec)
    mode = round_mode if round_mode is not None else spec.round_mode
    if mode is None:
        ns = {len(tree_leaves(d)[0]) for d in user_data}
        rect = len(ns) == 1 and spec.batch_size <= next(iter(ns))
        if (rect and spec.k_per_round * SPARSE_AUTO_RATIO
                <= len(user_data)):
            raise NotImplementedError(
                f"{len(user_data)} users with k_per_round="
                f"{spec.k_per_round} auto-selects round_mode='sparse' "
                f"(k_per_round * {SPARSE_AUTO_RATIO} <= users), which is "
                "not ported yet; pass round_mode='fused' explicitly to "
                "run the dense fused path (with the default "
                "k_per_round=2 that means any cohort above 15 users)")
    backend = HostBackend(
        loss_fn, user_data, lr=spec.lr, batch_size=spec.batch_size,
        local_epochs=spec.local_epochs, seed=spec.seed,
        round_mode=mode, mesh=mesh, k_max=spec.k_per_round,
        objective=spec.objective, device=device)
    return FLEngine(spec, backend, init_params, eval_fn)
