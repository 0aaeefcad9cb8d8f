"""FLEngine — the single public orchestrator for FL rounds (Fig. 1).

One round, regardless of strategy or backend:

  1. counter refrain mask (Step 4) — upload shares are computed ONCE
     per round and passed through (mask + SelectionContext.counter_values);
     with a channel, block fading is redrawn first;
  2. train everyone (Step 2) and compute Eq. 2 priorities (Step 3);
  3. strategy.select over the SelectionContext (Step 4/5 contention) —
     a strategy that selects before training (``random-centralized``)
     selects first, with unit priorities, and only its winners train
     (a partial-cohort round); on a winner-sparse backend
     (``sparse_capable``) the priorities come first (the backend's exact
     prepass or its stale cache), then selection, then only the winners
     train;
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

**Sweeps**: ``run_sweep`` runs E independent experiment cells through
one training pass a round — the (E, U, ...) stack trained as E * U rows —
with every lane's host selection in one grouped call
(``select_grouped``). The round loop is a small pipeline: CUDA launches
return at once, so while the card trains round t the host pre-draws round
t+1's batches; only the (E, U) priorities and losses are read back each
round, and the next train call is queued before the host settles round
t's bookkeeping. ``run`` on a sweep-capable backend is the E = 1 case of
the same loop. On a winner-sparse backend ``run_sweep`` takes the
contention-first loop instead (``_run_lanes_sparse``): every lane's
priorities, one grouped selection, one compact (E, K_max, ...) training
pass over the winners, the merge by delivery position; ``run`` there is
the per-round loop.

Sweep lanes are faithful to sequential runs: each lane owns its strategy
instance (its contention rng), its engine rng, its fairness counter row
and its per-user batch streams, all seeded from the lane's spec, so the
winner sequences equal E separate per-round runs winner for winner. One
documented exception: ``trains_before_selection`` lanes train the full
cohort inside the sweep (selection still gates the merge), so their loss
traces cover all users, not just the pre-selected winners.

With ``checkpoint_dir`` both loops persist their whole host and device
state (``checkpoint.fl_state``) and resume from it bit for bit.

There is deliberately no strategy-name branching here: behaviour
differences ride entirely on the Strategy capability flags and the
Backend contract.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch import trace
from repro_torch.channel.model import ChannelModel, MergeContext
from repro_torch.checkpoint.fl_state import (generator_state,
                                             load_fl_checkpoint,
                                             restore_generator,
                                             run_fingerprint,
                                             save_fl_checkpoint)
from repro_torch.convert import params_to_numpy
from repro_torch.core.counter import FairnessCounter, SweepFairnessCounter
from repro_torch.core.rngs import (channel_noise_entropy, engine_rng,
                                   strategy_seed)
from repro_torch.engine.backends import Backend, compact_weights
from repro_torch.engine.registry import create_strategy, select_grouped
from repro_torch.engine.spec import ExperimentSpec, SweepSpec
from repro_torch.engine.types import (FLHistory, SelectionContext,
                                      SweepResult, TrainResult)
from repro_torch.faults.injectors import FaultInjector
from repro_torch.faults.robust import FaultMergeContext, fault_alphas
from repro_torch.tree import tree_leaves


class _Lane:
    """Host-side state of ONE experiment cell inside a (possibly E = 1)
    sweep: spec, strategy instance, engine rng, channel model, fault
    injector, history. The fairness counter lives outside (one
    ``SweepFairnessCounter`` row per lane). A device-contention strategy
    runs its loop on ``device``, where the cohort lives. ``FLEngine``
    builds one for its own spec and takes its streams from it."""

    __slots__ = ("spec", "strategy", "rng", "channel", "faults", "history")

    def __init__(self, spec: ExperimentSpec, num_users: int, *,
                 device=None):
        self.spec = spec
        # engine rng and strategy/simulator rng are INDEPENDENT spawn
        # children of the spec seed (core.rngs)
        self.strategy = create_strategy(
            spec.strategy, csma_config=spec.csma,
            seed=strategy_seed(spec.seed),
            contention_backend=spec.contention_backend,
            **spec.strategy_options)
        sim = getattr(self.strategy, "_sim", None)
        if sim is not None:
            sim.device = device
        self.rng = engine_rng(spec.seed)
        # channel and fault streams are further spawn children of the
        # spec seed: building them never perturbs the streams above
        self.channel = (ChannelModel(spec.channel, num_users, spec.seed)
                        if spec.channel is not None else None)
        self.faults = (FaultInjector(spec.faults, spec.seed,
                                     cw_base=spec.cw_base,
                                     tx_slots=spec.csma.tx_slots)
                       if spec.faults is not None else None)
        self.history = FLHistory(
            selections=np.zeros(num_users, np.int64))

    def state(self):
        """The lane's host streams in checkpoint form (the keys both
        payloads use)."""
        return {
            "engine_rng": generator_state(self.rng),
            "strategy": (self.strategy._sim.state_dict()
                         if hasattr(self.strategy, "_sim") else None),
            "channel": (self.channel.state_dict()
                        if self.channel is not None else None),
            "faults": (self.faults.state_dict()
                       if self.faults is not None else None),
        }

    def load_state(self, d) -> None:
        """Restore what ``state`` saved."""
        restore_generator(self.rng, d["engine_rng"])
        if d["strategy"] is not None:
            self.strategy._sim.load_state_dict(d["strategy"])
        if self.channel is not None and d["channel"] is not None:
            self.channel.load_state_dict(d["channel"])
        if self.faults is not None and d["faults"] is not None:
            self.faults.load_state_dict(d["faults"])


def _gate_round(channel, attempted):
    """PER-gate the round's attempted uploads: (delivered, failures)."""
    if channel is None or not attempted:
        return list(attempted), 0
    delivered = channel.gate(attempted)
    return delivered, len(attempted) - len(delivered)


def _uploads(channel, faults, winners, extract, num_examples):
    """One lane's round of uploads: the channel's PER gate, then, with
    faults on, the fault pipeline (crashes, outages, HARQ retries,
    stragglers, corruption). Stragglers' trained params are captured
    (``extract(u)``) BEFORE the merge overwrites the trained stack.
    Returns ``(delivered, failures, rf, stale_in, merged_now)``: the
    arrivals, the losses that survived every retry, the fault round (or
    None), last round's stale uploads and this round's merge
    candidates."""
    if faults is not None:
        faults.begin_round()                 # burst-outage process
    delivered, failures = _gate_round(channel, winners)
    if faults is None:
        return delivered, failures, None, [], delivered
    rf = faults.process_uploads(
        winners, delivered, channel.per if channel is not None else None)
    stale_in = faults.pop_stale()
    for u in rf.stragglers:
        faults.push_stale(u, extract(u), num_examples(u))
    return rf.arrived, len(rf.failed), rf, stale_in, rf.merged_now


def _record_round(history, spec, channel, sel, winners, delivered,
                  failures, rf, stale_in):
    """Append one round's selection, delivery, contention, fault and
    time / energy accounting to ``history`` (the caller adds priorities
    and losses)."""
    if winners:
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
    _record_time(history, spec, channel, sel.elapsed_slots, winners,
                 retry_slots=retry_slots,
                 retry_uploads=rf.retry_uploads if rf is not None else ())


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
        # the engine's strategy, rng, channel and faults are those of
        # one lane of its spec: ``run``'s E = 1 sweep runs that lane
        self._lane = _Lane(spec, self.num_users, device=backend.device)
        self.strategy, self._rng = self._lane.strategy, self._lane.rng
        self.channel, self.faults = self._lane.channel, self._lane.faults
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
        self._init_params = init_params
        self.state = backend.init_state(init_params)
        # the state a run starts from: ``run`` delegates to the sweep loop
        # only while ``self.state`` is still this object
        self._pristine = self.state

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
        elif self.backend.sparse_capable():
            # winner-sparse round: Eq. 2 priorities BEFORE selection (the
            # exact chunked prepass, or the stale cache), then only the
            # contention winners train, as one compact stack. A prepass
            # round reports the whole cohort's prepass losses (the fused
            # path's numbers); a stale round its winners' losses.
            train_ids = list(range(self.num_users))
            prios, pre_losses = self.backend.sparse_priorities(
                self.state, strat.uses_priority)
            sel = strat.select(self._context(
                prios, participating, t, shares))
            tr = self.backend.sparse_train(
                self.state, [int(u) for u in sel.winners])
            tr = TrainResult(
                losses=pre_losses if pre_losses is not None else tr.losses,
                priorities=prios, local_handle=tr.local_handle)
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
        delivered, failures, rf, stale_in, merged_now = _uploads(
            self.channel, self.faults, winners,
            lambda u: self.backend.extract_local(tr, u),
            self.backend.num_examples)
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
        _record_round(history, spec, self.channel, sel, winners, delivered,
                      failures, rf, stale_in)
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
    def _delegates(self) -> bool:
        """True when ``run`` goes through the sweep loop as its E = 1
        case: a sweep-capable backend, a strategy that trains the whole
        cohort (not ``trains_before_selection``), a pristine state
        (untouched since init: after a merged round the per-round path
        would continue consumed client streams) and a backend seeded with
        the spec's seed (the lane re-derives the batch streams from
        ``spec.seed``)."""
        return (self.backend.sweep_capable()
                and not self.strategy.trains_before_selection
                and self.state is self._pristine
                and getattr(self.backend, "seed", None) == self.spec.seed)

    def run(self, verbose: bool = False, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0) -> FLHistory:
        """Run the spec's rounds. With ``checkpoint_dir`` set, the run
        persists its full host+device state every ``checkpoint_every``
        rounds (an atomic file) and — when the directory already holds a
        checkpoint for THIS spec — resumes from it, bit-identically to
        the uninterrupted run."""
        spec = self.spec
        if self._delegates():
            # E = 1 case of the sweep loop over this engine's own lane
            # (its strategy, rng, channel and faults)
            self._lane.history = FLHistory(
                selections=np.zeros(self.num_users, np.int64))
            result, st, counters = self._run_lanes(
                [self._lane], init_state=self.state, overlap=True,
                verbose=verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
            self.state = self.backend.sweep_global(st, 0)
            self.counter.uploads[:] = counters.uploads[0]
            self.counter.total_merged = int(counters.total_merged[0])
            # the lane consumed spec-seeded batch streams; hand them to
            # the clients so continued per-round training picks up the
            # stream where a pure per-round run would be
            self.backend.sweep_adopt_streams(st, 0)
            self.backend.adopt_sweep_objective(st)
            return result.histories[0]

        # per-round path: stacked / ragged backends and partial-cohort
        # (trains_before_selection) rounds
        history = FLHistory(
            selections=np.zeros(self.num_users, np.int64))
        start = 0
        fp = run_fingerprint([spec], self.num_users)
        if checkpoint_dir is not None:
            payload = load_fl_checkpoint(checkpoint_dir)
            if payload is not None:
                history, start = self._load_run_payload(payload, fp)
        for t in range(start, spec.rounds):
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
            if (checkpoint_dir is not None and checkpoint_every > 0
                    and (t + 1) % checkpoint_every == 0
                    and t + 1 < spec.rounds):
                save_fl_checkpoint(checkpoint_dir,
                                   self._run_payload(fp, t, history))
        return history

    # ------------------------------------------- checkpoint plumbing
    def _run_payload(self, fp, t, history):
        return {
            "kind": "run", "fingerprint": fp, "round": t,
            "state": params_to_numpy(self.state),
            "history": history,
            **self._lane.state(),
            "counter": self.counter.state_dict(),
            "client_streams": self.backend.client_stream_states(),
            # the sparse "stale" mode's last-trained Eq. 2 priorities;
            # None everywhere else
            "priority_cache": self.backend.priority_cache_state(),
            # server-opt moments + FedDyn h; None for plain objectives
            "objective": self.backend.objective_state(),
        }

    def _load_run_payload(self, payload, fp):
        if payload["fingerprint"] != fp:
            raise ValueError(
                "checkpoint was written by a different experiment "
                "configuration; refusing to resume (point checkpoint_dir "
                "at a fresh directory or match the original spec)")
        if payload["kind"] != "run":
            raise ValueError(
                "checkpoint was written by the sweep path; resume it "
                "through the same sweep-capable configuration")
        self.state = self.backend.to_device(payload["state"])
        self._lane.load_state(payload)
        self.counter.load_state_dict(payload["counter"])
        self.backend.restore_client_streams(payload["client_streams"])
        self.backend.restore_priority_cache(payload.get("priority_cache"))
        self.backend.restore_objective_state(payload.get("objective"))
        return payload["history"], payload["round"] + 1

    # ------------------------------------------------------- sweep path
    def run_sweep(self, sweep: Union[SweepSpec, Sequence[ExperimentSpec]],
                  *, overlap: Optional[bool] = None,
                  verbose: bool = False,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0) -> SweepResult:
        """Run E experiment cells through one training pass a round.

        ``sweep``: a ``SweepSpec`` or a plain sequence of
        ``ExperimentSpec`` cells (validated into one). Every cell starts
        from the engine's initial params and its own spec seed, exactly
        like E fresh sequential ``run`` calls. ``overlap`` overrides the
        sweep's pipeline flag (results are bit-identical either way).
        ``checkpoint_dir`` / ``checkpoint_every`` persist and resume the
        whole sweep (every lane's host state and device globals) exactly
        like ``run``'s flags.
        """
        if not isinstance(sweep, SweepSpec):
            sweep = SweepSpec(specs=list(sweep))
        if overlap is None:
            overlap = sweep.overlap
        lanes = [_Lane(spec, self.num_users, device=self.backend.device)
                 for spec in sweep.specs]
        if self.backend.sweep_sparse_capable():
            # winner-sparse sweeps run the contention-first lane loop:
            # every lane selects, then ONE compact (E, K_max, ...) train
            # covers all lanes' winners
            result, _, _ = self._run_lanes_sparse(
                lanes, init_state=self._init_params, verbose=verbose,
                labels=sweep.labels, checkpoint_dir=checkpoint_dir)
            return result
        if not self.backend.sweep_capable():
            raise ValueError(
                "run_sweep needs a sweep-capable backend (HostBackend "
                "round_mode='fused' or 'sparse' over a rectangular "
                "cohort); run the cells sequentially through "
                "FLEngine.run instead")
        result, _, _ = self._run_lanes(
            lanes, init_state=self._init_params, overlap=overlap,
            verbose=verbose, labels=sweep.labels,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
        return result

    # ------------------------------------------------------------------
    def _select_lanes(self, lanes, counters, prios64, t):
        """Host selection for all lanes: ONE shares / mask computation,
        one grouped (batched) select dispatch."""
        U = self.num_users
        shares = counters.values()                 # (E, U), once a round
        masks = counters.participating(shares)
        het = self.backend.heterogeneity
        ones = np.ones(U)
        strategies, ctxs = [], []
        for e, lane in enumerate(lanes):
            spec, strat = lane.spec, lane.strategy
            if lane.channel is not None:
                lane.channel.begin_round()         # block fading
            mask = (masks[e] if spec.use_counter
                    else np.ones(U, bool))
            if not mask.any():                     # degenerate threshold
                mask = np.ones(U, bool)
            prios = (prios64[e]
                     if strat.uses_priority
                     and not strat.trains_before_selection else ones)
            strategies.append(strat)
            ctxs.append(SelectionContext(
                priorities=prios, participating=mask,
                k_target=spec.k_per_round, rng=lane.rng,
                cw_base=spec.cw_base, counter_values=shares[e],
                heterogeneity=het,
                snr_db=(lane.channel.snr_db if lane.channel is not None
                        else None),
                round_index=t))
        sels = select_grouped(strategies, ctxs)
        winners_all = [[int(u) for u in sel.winners] for sel in sels]
        return winners_all, sels

    def _sweep_merge_ctx(self, lanes, t: int):
        """The sweep's AirComp merge inputs — (E, U) coefficients, (E,)
        sigmas, one ``(noise entropy, t)`` key a lane — or None for the
        digital merge (``merge_backend`` is sweep-shared, so the lead
        lane decides for all)."""
        if lanes[0].spec.merge_backend != "aircomp":
            return None
        coeffs = np.ones((len(lanes), self.num_users), np.float32)
        sigmas = np.zeros(len(lanes), np.float32)
        keys = []
        for e, lane in enumerate(lanes):
            if lane.channel is not None:
                coeffs[e], sigmas[e] = lane.channel.aircomp_coeffs()
                entropy = lane.channel.noise_entropy
            else:
                entropy = channel_noise_entropy(lane.spec.seed)
            keys.append((entropy, t))
        return MergeContext(coeffs=coeffs, noise_sigma=sigmas, key=keys)

    def _sweep_merge_faults(self, lanes, st, tr, rfs, stales, merged_all,
                            idx):
        """Each lane's robust-merge context (``_lane_fault_ctx``: its
        ``fault_alphas`` weights, corruption factors and stale group),
        then the robust sweep merge. Returns the (E,) quarantine
        counts."""
        ctxs = [self._lane_fault_ctx(lane.spec, rf, stale_in, merged)
                for lane, rf, stale_in, merged
                in zip(lanes, rfs, stales, merged_all)]
        return self.backend.sweep_merge_faults(st, tr, idx, merged_all,
                                               ctxs)

    def _dispatch_sweep_merge(self, lanes, st, tr, merged_all, rfs, stales,
                              lead_faults, k_pad, t, attempts=None,
                              pos_all=None):
        """One (E, k_pad) merge dispatch. ``merged_all[e]`` are lane e's
        merge candidates (user ids, delivery order); ``pos_all[e]`` their
        rows in the trained stack (None: the user ids themselves, as on
        the dense sweep; compact positions on the sparse one);
        ``attempts`` the per-lane attempt-winner (uids, rows) pair for
        the FedDyn h update. Routes through the robust, AirComp or
        digital / objective sweep merge; returns the (E,) quarantine
        counts, or None off the fault path."""
        backend, E = self.backend, len(lanes)
        if pos_all is None:
            pos_all = merged_all
        idx = np.zeros((E, k_pad), np.int32)
        w = np.zeros((E, k_pad), np.float32)
        uids = np.zeros((E, k_pad), np.int64)
        for e in range(E):
            idx[e], w[e] = compact_weights(
                k_pad, pos_all[e],
                [backend.num_examples(u) for u in merged_all[e]])
            uids[e, :len(merged_all[e])] = merged_all[e]
        if lead_faults is not None and lead_faults.merge_guarded:
            return self._sweep_merge_faults(lanes, st, tr, rfs, stales,
                                            merged_all, idx)
        backend.sweep_merge(st, tr, idx, w,
                            merge_ctx=self._sweep_merge_ctx(lanes, t),
                            uids=uids, attempts=attempts)
        return None

    def _sweep_payload(self, fp, t, st, stream_snap, counters, lanes):
        return {
            "kind": "sweep", "fingerprint": fp, "round": t,
            "glob": params_to_numpy(self.backend.sweep_globals(st)),
            "client_streams": stream_snap,
            "counters": counters.state_dict(),
            # the lanes' m / v / h; None for all-plain sweeps
            "objective": self.backend.sweep_objective_state(st),
            "lanes": [{"history": lane.history, **lane.state()}
                      for lane in lanes],
        }

    @staticmethod
    def _load_sweep_payload(payload, fp, lanes, counters):
        if payload["fingerprint"] != fp:
            raise ValueError(
                "checkpoint was written by a different sweep "
                "configuration; refusing to resume (point checkpoint_dir "
                "at a fresh directory or match the original specs)")
        if payload["kind"] != "sweep":
            raise ValueError(
                "checkpoint was written by the per-round path; resume "
                "it through the same non-sweep configuration")
        counters.load_state_dict(payload["counters"])
        for lane, lst in zip(lanes, payload["lanes"]):
            lane.history = lst["history"]
            lane.load_state(lst)
        return payload["round"] + 1

    @trace.recorded
    def _run_lanes(self, lanes, *, init_state, overlap, verbose,
                   labels=None, checkpoint_dir=None, checkpoint_every=0):
        """The sweep round loop: one training pass for all lanes, one
        batched host selection, host work ordered around the card's.

        Per round t (card work in brackets; CUDA launches return at
        once, so the bracketed work runs while the host goes on):

            [train t queued]  host pre-draws round t+1's batches
            read the (E, U) priorities and losses        <- the sync
            host: refrain masks + grouped CSMA contention
            queue [merge t] then [train t+1]
            host: counters, history, eval

        With ``overlap`` off the pre-draw moves after the contention;
        every per-lane rng stream is consumed in the same order either
        way, so the two schedules give the same bits.

        Iteration t is round t of the recorder (``repro_torch.trace``):
        its spans ``draw``, ``read``, ``select``, ``uploads``, ``merge``,
        ``train``, ``book``, ``eval`` (and ``checkpoint``) hold every
        statement of the iteration; the set-up and round 0's draw and
        train are the prologue.
        """
        backend, U, E = self.backend, self.num_users, len(lanes)
        rounds = lanes[0].spec.rounds
        need_prio = any(l.strategy.uses_priority for l in lanes)
        lead_faults = lanes[0].spec.faults       # sweep-shared field
        counters = SweepFairnessCounter(
            E, U, np.array([l.spec.counter_threshold for l in lanes]))
        fp = run_fingerprint([l.spec for l in lanes], U)
        seeds = [l.spec.seed for l in lanes]
        objs = [l.spec.objective for l in lanes]
        host_select = all(l.spec.contention_backend == "numpy"
                          for l in lanes)
        t0 = time.perf_counter()
        start, st = 0, None
        with trace.span("setup.init"):
            if checkpoint_dir is not None:
                payload = load_fl_checkpoint(checkpoint_dir)
                if payload is not None:
                    start = self._load_sweep_payload(payload, fp, lanes,
                                                     counters)
                    st = backend.sweep_restore(
                        payload["glob"], payload["client_streams"], seeds,
                        objectives=objs,
                        objective_state=payload.get("objective"))
            if st is None:
                st = backend.sweep_init(init_state, seeds, objectives=objs)
        with trace.span("draw"):
            batched = backend.sweep_batches(st)
        with trace.span("train"):
            tr = backend.sweep_train(st, batched, need_prio)
            del batched                # held no longer than the call
        for t in range(start, rounds):
            trace.begin_round(t)
            with trace.span("draw"):
                last = t + 1 >= rounds
                want_ckpt = (checkpoint_dir is not None
                             and checkpoint_every > 0
                             and (t + 1) % checkpoint_every == 0
                             and not last)
                # the client-stream snapshot must precede ANY round-t+1
                # batch draw (overlapped or not): a resumed run re-draws
                # round t+1 from exactly this position
                stream_snap = (backend.sweep_stream_states(st)
                               if want_ckpt else None)
                next_batched = None
                if overlap and not last:
                    # host: round t+1's epoch permutations, drawn while
                    # the queued round-t train call runs on the card
                    next_batched = backend.sweep_batches(st)
            with trace.span("read"):
                prios64, losses64 = tr.read()              # the sync
            with trace.span("select", host_only=host_select):
                winners_all, sels = self._select_lanes(
                    lanes, counters, prios64, t)
            with trace.span("uploads", host_only=lead_faults is None):
                # channel gate + fault pipeline: merge weights are
                # computed over the post-fault merge candidates; counters
                # and histories keep seeing the attempts
                ups = [_uploads(lane.channel, lane.faults, winners_all[e],
                                lambda u, e=e: backend.sweep_extract(
                                    tr, e, u),
                                backend.num_examples)
                       for e, lane in enumerate(lanes)]
                rfs = [up[2] for up in ups]
                stales = [up[3] for up in ups]
                merged_all = [[int(u) for u in up[4]] for up in ups]
                # user ids ARE the row indices into the (E, U, ...) stack
                # (for attempts too)
                k_pad = backend._k_pad(max(len(m) for m in merged_all))
            with trace.span("merge"):
                nq = self._dispatch_sweep_merge(
                    lanes, st, tr, merged_all, rfs, stales, lead_faults,
                    k_pad, t, attempts=(winners_all, winners_all))
            if not last:
                if next_batched is None:
                    with trace.span("draw"):
                        next_batched = backend.sweep_batches(st)
                with trace.span("train"):
                    tr = backend.sweep_train(st, next_batched, need_prio)
            # deferred bookkeeping: overlaps the queued train call
            with trace.span("book", host_only=True):
                counters.update(winners_all)
                for e, (lane, (delivered, failures, rf, stale_in, _)) in \
                        enumerate(zip(lanes, ups)):
                    h = lane.history
                    if nq is not None:
                        h.quarantined_updates += int(nq[e])
                    _record_round(h, lane.spec, lane.channel, sels[e],
                                  winners_all[e], delivered, failures, rf,
                                  stale_in)
                    if (lane.strategy.uses_priority
                            and not lane.strategy.trains_before_selection):
                        h.priorities.append(prios64[e].tolist())
                    h.train_loss.append(float(np.mean(losses64[e])))
            with trace.span("eval"):
                self._eval_lanes(lanes, st, t, labels, verbose)
            if want_ckpt:
                with trace.span("checkpoint"):
                    save_fl_checkpoint(
                        checkpoint_dir,
                        self._sweep_payload(fp, t, st, stream_snap,
                                            counters, lanes))
        result = SweepResult(
            histories=[l.history for l in lanes],
            specs=[l.spec for l in lanes], labels=labels,
            overlap=overlap, wall_s=time.perf_counter() - t0,
            final_globals=backend.sweep_globals(st))
        return result, st, counters

    def _eval_lanes(self, lanes, st, t, labels, verbose):
        """Each lane's evaluation of round t, where its spec asks for
        one."""
        if self.eval_fn is None:
            return
        for e, lane in enumerate(lanes):
            spec, h = lane.spec, lane.history
            if t % spec.eval_every == 0 or t == spec.rounds - 1:
                acc = float(self.eval_fn(self.backend.sweep_global(st, e)))
                h.accuracy.append(acc)
                h.eval_round.append(t)
                if verbose:
                    tag = labels[e] if labels else f"{spec.strategy}/{e}"
                    print(f"[{tag}] round {t:4d} acc {acc:.4f}"
                          + (f" loss {h.train_loss[-1]:.4f}"
                             if h.train_loss else ""))

    @trace.recorded
    def _run_lanes_sparse(self, lanes, *, init_state, verbose, labels=None,
                          checkpoint_dir=None):
        """The winner-sparse sweep loop: per round, every lane's Eq. 2
        priorities (the exact prepass or the stale cache), ONE grouped
        host contention, ONE compact (E, K_max, ...) training pass over
        the winners, then the merge by delivery position. Synchronous —
        no overlap: a round's winner draws depend on its contention. A
        prepass round records the whole cohort's losses, a stale round
        its winners' (none without winners). The recorder's spans are
        the dense loop's, with ``prepass`` for the priorities."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "sparse sweeps don't checkpoint; use round_mode='fused' "
                "for checkpointed sweeps")
        backend, U, E = self.backend, self.num_users, len(lanes)
        rounds = lanes[0].spec.rounds
        need_prio = any(l.strategy.uses_priority for l in lanes)
        lead_faults = lanes[0].spec.faults       # sweep-shared field
        counters = SweepFairnessCounter(
            E, U, np.array([l.spec.counter_threshold for l in lanes]))
        host_select = all(l.spec.contention_backend == "numpy"
                          for l in lanes)
        t0 = time.perf_counter()
        with trace.span("setup.init"):
            st = backend.sweep_sparse_init(
                init_state, [l.spec.seed for l in lanes],
                objectives=[l.spec.objective for l in lanes])
        for t in range(rounds):
            trace.begin_round(t)
            with trace.span("prepass"):
                prios64, pre_losses = backend.sweep_sparse_priorities(
                    st, need_prio)
            with trace.span("select", host_only=host_select):
                winners_all, sels = self._select_lanes(
                    lanes, counters, prios64, t)
            with trace.span("train"):
                tr = backend.sweep_sparse_train(st, winners_all)
            with trace.span("uploads", host_only=lead_faults is None):
                # a straggler's row is its delivery position
                ups = [_uploads(lane.channel, lane.faults, winners_all[e],
                                lambda u, e=e: backend.sweep_extract(
                                    tr, e, winners_all[e].index(u)),
                                backend.num_examples)
                       for e, lane in enumerate(lanes)]
                merged_all = [[int(u) for u in up[4]] for up in ups]
                # rows are compact positions in the (E, K_max, ...) stack;
                # a lane's attempts ARE its trained rows, in order
                pos_all = [[winners_all[e].index(u) for u in merged_all[e]]
                           for e in range(E)]
                att_rows = [list(range(len(ws))) for ws in winners_all]
                losses64 = pre_losses
            if losses64 is None:
                with trace.span("read"):
                    losses64 = tr.read()[1]
            with trace.span("merge"):
                nq = self._dispatch_sweep_merge(
                    lanes, st, tr, merged_all, [up[2] for up in ups],
                    [up[3] for up in ups], lead_faults,
                    tr.priorities.shape[1], t,
                    attempts=(winners_all, att_rows), pos_all=pos_all)
            with trace.span("book", host_only=True):
                counters.update(winners_all)
                for e, (lane, (delivered, failures, rf, stale_in, _)) in \
                        enumerate(zip(lanes, ups)):
                    h = lane.history
                    if nq is not None:
                        h.quarantined_updates += int(nq[e])
                    _record_round(h, lane.spec, lane.channel, sels[e],
                                  winners_all[e], delivered, failures, rf,
                                  stale_in)
                    if (lane.strategy.uses_priority
                            and not lane.strategy.trains_before_selection):
                        h.priorities.append(prios64[e].tolist())
                    loss_row = (losses64[e] if pre_losses is not None
                                else losses64[e, :len(winners_all[e])])
                    if np.size(loss_row):
                        h.train_loss.append(float(np.mean(loss_row)))
            with trace.span("eval"):
                self._eval_lanes(lanes, st, t, labels, verbose)
        result = SweepResult(
            histories=[l.history for l in lanes],
            specs=[l.spec for l in lanes], labels=labels,
            overlap=False, wall_s=time.perf_counter() - t0,
            final_globals=backend.sweep_globals(st))
        return result, st, counters


#: auto-select the winner-sparse path when the winner budget is at least
#: this many times smaller than the cohort (K ≪ U)
SPARSE_AUTO_RATIO = 8


def build_host_engine(spec: ExperimentSpec, init_params, loss_fn,
                      user_data, eval_fn=None, *,
                      prefer_vmap: bool = True, round_mode: str = None,
                      mesh=None, device=None) -> FLEngine:
    """Convenience: spec + host data -> engine over HostBackend.

    ``round_mode`` (argument, else ``spec.round_mode``) picks the
    backend round path: ``"fused"``, ``"stacked"``, ``"ragged"`` or
    ``"sparse"``. When BOTH are None the factory auto-selects
    ``"sparse"`` (winner-sparse rounds, ``spec.sparse_priority``
    ordering) for a rectangular cohort with ``k_per_round *
    SPARSE_AUTO_RATIO <= num_users``, else the dense default
    (``"fused"``, or ``"ragged"`` without ``prefer_vmap``).
    ``device=None`` is the CUDA device (raises without one); ``"cpu"``
    runs on the CPU.
    """
    from repro_torch.engine.backends import HostBackend
    mode = round_mode if round_mode is not None else spec.round_mode
    if mode is None and prefer_vmap:
        ns = {len(tree_leaves(d)[0]) for d in user_data}
        rect = len(ns) == 1 and spec.batch_size <= next(iter(ns))
        if (rect and spec.k_per_round * SPARSE_AUTO_RATIO
                <= len(user_data)):
            mode = "sparse"
    backend = HostBackend(
        loss_fn, user_data, lr=spec.lr, batch_size=spec.batch_size,
        local_epochs=spec.local_epochs, seed=spec.seed,
        prefer_vmap=prefer_vmap, round_mode=mode, mesh=mesh,
        k_max=spec.k_per_round, sparse_priority=spec.sparse_priority,
        objective=spec.objective, device=device)
    return FLEngine(spec, backend, init_params, eval_fn)
