"""FLEngine — the single public orchestrator for FL rounds (Fig. 1).

One round, regardless of strategy or backend:

  1. counter refrain mask (Step 4) — upload shares are computed ONCE
     per round and passed through (mask + SelectionContext.counter_values);
     with a channel, block fading is redrawn first;
  2. train everyone (Step 2) and compute Eq. 2 priorities (Step 3);
  3. strategy.select over the SelectionContext (Step 4/5 contention) —
     a strategy that selects before training (``random-centralized``)
     selects first, with unit priorities, and only its winners train
     (a partial-cohort round);
  4. the channel's PER gate and the fault pipeline (crashes, outages,
     HARQ retries, stragglers, corruption) turn the contention winners
     (upload attempts) into the merge candidates;
  5. backend.merge of the candidates (Eq. 1: digital, AirComp or the
     robust guard; with a non-plain objective, the server step after it
     and the FedDyn h update — a round with attempts but no deliveries
     still merges when the objective carries h);
  6. counter + history update — including the contention's collision
     and airtime stats, the channel's airtime / energy and the fault
     counters.

There is deliberately no strategy-name branching here: behaviour
differences ride entirely on the Strategy capability flags and the
Backend contract.

This is the per-round loop of the reference engine, channel, fault and
objectives layers included; its stream draws come in the reference's
order, so every count of the history equals the reference's. Its sweep
path (``run_sweep``, the E = 1 delegation of ``run``) and
checkpoint/resume are not ported yet: each raises
``NotImplementedError`` naming what is missing. The reference
pins the sweep lane and the per-round loop to the same winners and
globals, so this loop is the sequential reference of both.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.channel.model import ChannelModel, MergeContext
from repro_torch.core.counter import FairnessCounter
from repro_torch.core.rngs import (channel_noise_entropy, engine_rng,
                                   strategy_seed)
from repro_torch.engine.backends import Backend
from repro_torch.engine.registry import create_strategy
from repro_torch.engine.spec import ExperimentSpec
from repro_torch.engine.types import FLHistory, SelectionContext
from repro_torch.faults.injectors import FaultInjector
from repro_torch.faults.robust import FaultMergeContext, fault_alphas
from repro_torch.tree import tree_leaves


def _gate_round(channel, attempted):
    """PER-gate the round's attempted uploads: (delivered, failures)."""
    if channel is None or not attempted:
        return list(attempted), 0
    delivered = channel.gate(attempted)
    return delivered, len(attempted) - len(delivered)


def _record_time(history, spec, channel, elapsed_slots, attempted,
                 retry_slots: int = 0, retry_uploads=()):
    """Append the round's wall-clock / energy accounting: contention
    slots at ``slot_duration_s`` plus, with a channel, the attempted
    uploads' payload airtime and transmit energy. HARQ retransmissions
    charge their backoff + tx slots (``retry_slots``) and, per retry
    attempt, another payload airtime / energy unit (``retry_uploads``,
    one uid per attempt) — a lost retry still spent the air."""
    secs = (elapsed_slots + retry_slots) * spec.slot_seconds()
    energy = 0.0
    if channel is not None:
        secs += channel.round_airtime_s(attempted)
        energy = channel.round_energy_j(attempted)
        if len(retry_uploads):
            secs += channel.round_airtime_s(retry_uploads)
            energy += channel.round_energy_j(retry_uploads)
    history.round_seconds.append(secs)
    history.cumulative_seconds.append(
        (history.cumulative_seconds[-1] if history.cumulative_seconds
         else 0.0) + secs)
    history.round_energy_j.append(energy)


class FLEngine:
    """One FL run: spec x strategy (registry) x backend."""

    def __init__(self, spec: ExperimentSpec, backend: Backend, init_params,
                 eval_fn: Optional[Callable] = None):
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
        obj = spec.objective
        if obj is not None and not obj.is_plain:
            if not backend.objective_active():
                raise ValueError(
                    "spec.objective is non-plain but the backend was "
                    "built without it; construct HostBackend with "
                    "objective=spec.objective (build_host_engine wires "
                    "this automatically)")
            if self.strategy.trains_before_selection:
                raise ValueError(
                    "non-plain objectives need the full-cohort fused "
                    "round; trains_before_selection strategy "
                    f"{spec.strategy!r} runs partial-cohort rounds")
        self._rng = engine_rng(spec.seed)
        # channel and fault streams are further spawn children of the
        # spec seed: building them never perturbs the streams above
        self.channel = (ChannelModel(spec.channel, self.num_users,
                                     spec.seed)
                        if spec.channel is not None else None)
        self.faults = (FaultInjector(spec.faults, spec.seed,
                                     cw_base=spec.cw_base,
                                     tx_slots=spec.csma.tx_slots)
                       if spec.faults is not None else None)
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
            snr_db=(self.channel.snr_db if self.channel is not None
                    else None),
            round_index=t)

    @staticmethod
    def _lane_merge_ctx(spec, channel, t: int, num_users: int):
        """AirComp merge inputs for the round-t merge, or None for the
        digital ("fedavg") Eq. 1. The noise key is the pair (noise
        entropy, t): the backend seeds each leaf's noise plane from it
        and the leaf index."""
        if spec.merge_backend != "aircomp":
            return None
        if channel is not None:
            coeffs, sigma = channel.aircomp_coeffs()
            entropy = channel.noise_entropy
        else:
            # channel-less aircomp: perfect superposition
            coeffs = np.ones(num_users, np.float32)
            sigma = 0.0
            entropy = channel_noise_entropy(spec.seed)
        return MergeContext(coeffs=coeffs, noise_sigma=sigma,
                            key=(entropy, t))

    def _lane_fault_ctx(self, spec, rf, stale_in, merged_now):
        """Robust-merge inputs for the round, or None when the merge
        stays the plain Eq. 1 (faults off, or failure-only fault modes
        that never alter the merge math)."""
        fs = spec.faults
        if fs is None or not fs.merge_guarded:
            return None
        weights, stale_w = fault_alphas(
            self.num_users, merged_now,
            [self.backend.num_examples(u) for u in merged_now],
            [n for _, _, n in stale_in], fs.staleness_discount)
        corrupt = np.ones(self.num_users, np.float32)
        for u, fac in rf.corrupt.items():
            corrupt[int(u)] = fac
        stale = [(p, float(w))
                 for (_, p, _), w in zip(stale_in, stale_w)]
        return FaultMergeContext(weights=weights, corrupt=corrupt,
                                 quarantine=fs.quarantine,
                                 clip_norm=fs.clip_norm, stale=stale)

    # ------------------------------------------------------------------
    def run_round(self, t: int, history: FLHistory) -> List[int]:
        """One round through the backend contract
        (train_round / merge)."""
        spec, strat = self.spec, self.strategy
        if self.channel is not None:
            self.channel.begin_round()     # block fading, pre-selection
        # upload shares: computed once, reused for the refrain mask AND
        # the SelectionContext
        shares = self.counter.values()
        participating = (self.counter.participating(shares)
                         if spec.use_counter
                         else np.ones(self.num_users, bool))
        if not participating.any():      # degenerate threshold: reset mask
            participating = np.ones(self.num_users, bool)

        if strat.trains_before_selection:
            sel = strat.select(self._context(
                np.ones(self.num_users), participating, t, shares))
            train_ids = list(sel.winners)
            tr = self.backend.train_round(
                self.state, t, train_ids,
                need_priority=strat.uses_priority)
        else:
            train_ids = list(range(self.num_users))
            tr = self.backend.train_round(
                self.state, t, train_ids,
                need_priority=strat.uses_priority)
            sel = strat.select(self._context(
                tr.priorities, participating, t, shares))

        # contention winners are upload ATTEMPTS; the channel (when
        # enabled) gates which of them reach the Eq. 1 merge. Counters /
        # selections / uploads_total see the attempt (the airtime was
        # spent either way); merge weights see deliveries. With faults
        # on, the injector post-processes the gate's output: ``delivered``
        # then records the post-fault / post-retry arrivals and
        # ``upload_failures`` the losses that survived every retry.
        winners = [int(u) for u in sel.winners]
        faults = self.faults
        if faults is not None:
            faults.begin_round()            # burst-outage process
        delivered, failures = _gate_round(self.channel, winners)
        rf, stale_in, merged_now = None, [], delivered
        if faults is not None:
            rf = faults.process_uploads(
                winners, delivered,
                self.channel.per if self.channel is not None else None)
            delivered, failures = rf.arrived, len(rf.failed)
            merged_now = rf.merged_now
            stale_in = faults.pop_stale()
            # capture this round's stragglers BEFORE the merge overwrites
            # the trained stack
            for u in rf.stragglers:
                faults.push_stale(u, self.backend.extract_local(tr, u),
                                  self.backend.num_examples(u))
        # FedDyn's h-state is keyed to the round's ATTEMPT winners (they
        # trained, so their local h advanced even if the channel dropped
        # the upload) — such rounds still dispatch the merge, whose
        # all-zero-weight guard keeps the global while h updates
        needs_h = self.backend.objective_needs_h()
        if merged_now or stale_in or (winners and needs_h):
            fault_ctx = self._lane_fault_ctx(spec, rf, stale_in,
                                             merged_now)
            self.state = self.backend.merge(
                self.state, tr, merged_now,
                merge_ctx=self._lane_merge_ctx(spec, self.channel, t,
                                               self.num_users),
                fault_ctx=fault_ctx, attempts=winners)
            if fault_ctx is not None:
                history.quarantined_updates += int(fault_ctx.n_quarantined)
        if winners:
            self.counter.update(winners, len(winners))
            history.uploads_total += len(winners)
            for u in winners:
                history.selections[u] += 1
        history.winners.append(winners)
        history.delivered.append(delivered)
        history.upload_failures += failures
        history.collisions += sel.collisions
        retry_slots = rf.retry_slots if rf is not None else 0
        history.contention_slots += sel.elapsed_slots + retry_slots
        if rf is not None:
            history.retries += rf.retries
            history.dropped_clients += len(rf.crashed)
            history.stale_merges += len(stale_in)
        _record_time(history, spec, self.channel, sel.elapsed_slots,
                     winners, retry_slots=retry_slots,
                     retry_uploads=(rf.retry_uploads if rf is not None
                                    else ()))
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
                      prefer_vmap: bool = True, round_mode: str = None,
                      mesh=None, device=None) -> FLEngine:
    """Convenience: spec + host data -> engine over HostBackend.

    ``round_mode`` (argument, else ``spec.round_mode``) picks the
    backend round path: ``"fused"``, ``"stacked"`` or ``"ragged"``
    (``"sparse"`` is not ported). When BOTH are None the backend runs
    the dense default (``"fused"``, or ``"ragged"`` without
    ``prefer_vmap``), except that the reference auto-selects
    ``"sparse"`` for a rectangular cohort with ``k_per_round *
    SPARSE_AUTO_RATIO <= num_users`` under ``prefer_vmap``; the port
    raises there instead of quietly running another path — pass
    ``round_mode="fused"`` to run such a cohort dense. ``device=None``
    is the CUDA device (raises without one); ``"cpu"`` runs on the CPU.
    """
    from repro_torch.engine.backends import HostBackend
    mode = round_mode if round_mode is not None else spec.round_mode
    if mode is None and prefer_vmap:
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
        prefer_vmap=prefer_vmap, round_mode=mode, mesh=mesh,
        k_max=spec.k_per_round,
        objective=spec.objective, device=device)
    return FLEngine(spec, backend, init_params, eval_fn)
