"""Fault injection for one experiment cell (DESIGN.md §8).

``FaultInjector`` owns a lane's fault rng streams — five independent
stream-4 ``SeedSequence`` spawn children of the experiment seed
(``core.rngs``), so enabling faults never perturbs the engine /
strategy / client / channel draws — plus the lane's burst-outage state
and the one-round stale-upload buffer.

Draw-count contract (reproducibility / checkpointability): per round,
the outage stream consumes exactly ONE uniform (``begin_round``); the
crash stream exactly ``len(winners)``; the retry stream exactly two per
retransmission (backoff + outcome); the straggle stream one per
arrival; the corrupt stream one per fresh merge candidate. Every count
is a pure function of the round's trajectory, so a resumed run replays
the identical stream positions.

Round pipeline (``process_uploads``) — the engine calls it AFTER the
channel's PER gate (whose draws are consumed unchanged underneath):

    winners ──channel gate──▶ delivered
       │ crash draws (airtime spent, lost, no retry)
       ▼
    live ─ outage blanks deliveries ─▶ arrived₀
       │ failed = live − arrived₀ → HARQ: up to max_retries attempts,
       │   CW = cw · 2^attempt backoff + tx airtime per attempt
       ▼
    arrived ─ straggle draws ─▶ merged_now (+ stragglers buffered,
       │                         merged NEXT round at λ·|D_k| mass)
       ▼
    corruption draws → per-update delta factors (NaN / Inf / scale)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rngs import (fault_corrupt_rng, fault_crash_rng,
                             fault_outage_rng, fault_retry_rng,
                             fault_straggle_rng)
from repro_torch.faults.spec import FaultSpec


@dataclass
class RoundFaults:
    """One round's fault outcomes, as the engine consumes them."""
    merged_now: List[int]                  # fresh deliveries merging now
    arrived: List[int]                     # all deliveries (incl. stragglers)
    crashed: List[int]                     # winners lost to crashes
    stragglers: List[int]                  # arrived, merge next round
    corrupt: Dict[int, float] = field(default_factory=dict)  # uid -> factor
    failed: List[int] = field(default_factory=list)  # lost after retries
    retries: int = 0                       # retransmission attempts
    retry_slots: int = 0                   # backoff + tx slots of retries
    retry_uploads: List[int] = field(default_factory=list)  # uid per retry


class FaultInjector:
    """One lane's fault streams + outage state + stale-upload buffer."""

    def __init__(self, spec: FaultSpec, seed, *, cw_base: float,
                 tx_slots: int):
        self.spec = spec
        self._crash = fault_crash_rng(seed)
        self._straggle = fault_straggle_rng(seed)
        self._corrupt = fault_corrupt_rng(seed)
        self._outage = fault_outage_rng(seed)
        self._retry = fault_retry_rng(seed)
        self._retry_cw = float(spec.retry_cw_base
                               if spec.retry_cw_base is not None
                               else cw_base)
        self._tx_slots = int(tx_slots)
        self._outage_left = 0
        self._round_outage = False
        #: stale buffer: [(uid, params pytree, num_examples)] captured
        #: last round, merged (λ-discounted) into the NEXT round's Eq. 1
        self._stale: List[Tuple[int, Any, float]] = []

    # ---- per-round state ---------------------------------------------
    def begin_round(self) -> None:
        """Advance the burst-outage process — exactly one uniform per
        round regardless of outcome (stream-position contract)."""
        u = float(self._outage.uniform())
        if self._outage_left == 0 and self.spec.outage_prob > 0 \
                and u < self.spec.outage_prob:
            self._outage_left = self.spec.outage_rounds
        self._round_outage = self._outage_left > 0
        if self._outage_left > 0:
            self._outage_left -= 1

    @property
    def in_outage(self) -> bool:
        """True while the current round sits inside a burst outage."""
        return self._round_outage

    # ---- the round pipeline ------------------------------------------
    def process_uploads(self, winners: List[int], delivered: List[int],
                        per: Optional[np.ndarray]) -> RoundFaults:
        """Run one round's fault pipeline (see module docstring).

        ``winners``: contention winners in delivery order (upload
        attempts); ``delivered``: the channel gate's survivors (equal to
        ``winners`` without a channel); ``per``: the channel's (U,)
        current-round packet-error rates for retry outcome draws (None
        = no channel, retries always succeed outside outages).
        """
        sp = self.spec
        crashed: List[int] = []
        if winners and sp.crash_prob > 0:
            draws = self._crash.uniform(size=len(winners))
            crashed = [u for u, r in zip(winners, draws)
                       if r < sp.crash_prob]
        live = [u for u in winners if u not in crashed]
        if self.in_outage:
            arrived: List[int] = []
        else:
            arrived = [u for u in delivered if u not in crashed]
        failed = [u for u in live if u not in arrived]

        # HARQ: each still-failed upload re-contends with CW doubled per
        # attempt (Eq. 3's law applied to retransmission), charged its
        # backoff + tx airtime whether or not the retry lands
        retries = 0
        retry_slots = 0
        retry_uploads: List[int] = []
        for attempt in range(1, sp.max_retries + 1):
            if not failed:
                break
            window = self._retry_cw * (2.0 ** attempt)
            still: List[int] = []
            for u in failed:
                r_back = float(self._retry.uniform())
                r_out = float(self._retry.uniform())
                retry_slots += max(1, int(round(r_back * window))) \
                    + self._tx_slots
                retry_uploads.append(u)
                retries += 1
                p = 0.0 if per is None else float(per[int(u)])
                if not self.in_outage and r_out >= p:
                    arrived.append(u)
                else:
                    still.append(u)
            failed = still

        # each fault mode owns its own spawn-child stream, so a mode
        # that is off simply never draws — it cannot shift another
        # mode's stream positions
        stragglers: List[int] = []
        if arrived and sp.straggle_prob > 0:
            draws = self._straggle.uniform(size=len(arrived))
            stragglers = [u for u, r in zip(arrived, draws)
                          if r < sp.straggle_prob]
        merged_now = [u for u in arrived if u not in stragglers]

        corrupt: Dict[int, float] = {}
        if merged_now and sp.corrupt_prob > 0:
            draws = self._corrupt.uniform(size=len(merged_now))
            factor = {"nan": float("nan"), "inf": float("inf"),
                      "scale": float(sp.corrupt_scale)}[sp.corrupt_mode]
            corrupt = {u: factor for u, r in zip(merged_now, draws)
                       if r < sp.corrupt_prob}

        return RoundFaults(merged_now=merged_now, arrived=arrived,
                           crashed=crashed, stragglers=stragglers,
                           corrupt=corrupt, failed=failed,
                           retries=retries, retry_slots=retry_slots,
                           retry_uploads=retry_uploads)

    # ---- stale-upload buffer -----------------------------------------
    def push_stale(self, uid: int, params, num_examples: float) -> None:
        """Buffer a straggler's trained params for next round's merge."""
        self._stale.append((int(uid), params, float(num_examples)))

    def pop_stale(self) -> List[Tuple[int, Any, float]]:
        """Drain the buffer (last round's stragglers, in arrival order)."""
        out, self._stale = self._stale, []
        return out

    # ---- checkpoint state --------------------------------------------
    def state_dict(self) -> dict:
        from repro_torch.convert import params_to_numpy
        return {
            "crash": self._crash.bit_generator.state,
            "straggle": self._straggle.bit_generator.state,
            "corrupt": self._corrupt.bit_generator.state,
            "outage": self._outage.bit_generator.state,
            "retry": self._retry.bit_generator.state,
            "outage_left": self._outage_left,
            "round_outage": self._round_outage,
            "stale": [(u, params_to_numpy(p), n)
                      for u, p, n in self._stale],
        }

    def load_state_dict(self, state: dict) -> None:
        self._crash.bit_generator.state = state["crash"]
        self._straggle.bit_generator.state = state["straggle"]
        self._corrupt.bit_generator.state = state["corrupt"]
        self._outage.bit_generator.state = state["outage"]
        self._retry.bit_generator.state = state["retry"]
        self._outage_left = int(state["outage_left"])
        self._round_outage = bool(state["round_outage"])
        self._stale = [(int(u), p, float(n))
                       for u, p, n in state["stale"]]
