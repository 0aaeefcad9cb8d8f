"""FaultSpec — the one config object of the fault-tolerance layer.

The paper's premise is an unreliable shared medium, yet at first
the only failure mode was the channel's PER gate. This spec re-attaches
the rest of the deployment reality (DESIGN.md §8): client crashes,
delayed (stale) uploads, corrupted local deltas, channel burst outages
layered on the PER gate, HARQ-style retransmission through the same
CW-doubling law as Eq. 3 contention, and a robust-merge guard
(NaN/Inf quarantine + per-update delta-norm clipping).

Everything is opt-in: ``ExperimentSpec.faults`` defaults to ``None``
(no fault rng stream is ever consumed; the merge program is the
untouched pre-fault one), and an inert ``FaultSpec()`` — all
probabilities zero — is pinned bit-identical to the no-fault reference
(``tools/check_winner_pins.py`` faults-off twin lanes), even though it
routes the merge through the robust program (quarantine defaults ON,
and a clean round's quarantine pass is an exact identity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: supported delta-corruption modes (see ``FaultInjector``)
CORRUPT_MODES = ("nan", "inf", "scale")


@dataclass(frozen=True)
class FaultSpec:
    """Failure model of one experiment cell.

    Client failures
      ``crash_prob``: per-winner probability the client dies mid-upload
      (airtime already spent, update lost, NOT retried — the server
      never sees a frame to NAK). ``straggle_prob``: per-delivery
      probability the upload arrives too late for this round's merge;
      it is buffered and merged next round with its Eq. 1 mass
      discounted to ``staleness_discount · |D_k|`` (λ = 0 drops stale
      updates entirely). ``corrupt_prob``: per-merged-update
      probability the local delta is corrupted — ``corrupt_mode``
      "nan"/"inf" poison the update's delta, "scale" blows it up by
      ``corrupt_scale``.

    Burst outages
      a two-state (Gilbert-style) round process layered ON TOP of the
      PER gate: each round not already in an outage starts one with
      probability ``outage_prob``; an outage blanks ALL deliveries
      (and retries) for ``outage_rounds`` rounds. The PER gate's draws
      are consumed unchanged underneath (stream-position invariance).

    HARQ retransmission
      a failed upload (PER loss or outage, not a crash) re-enters
      contention up to ``max_retries`` times in the same round, drawing
      a fresh backoff from an exponentially doubled window
      ``W_retry = cw · 2^attempt`` (``retry_cw_base``; None = the
      experiment's ``cw_base``) — the same CW law the paper uses for
      prioritization, Eq. 3. Every retry is charged its backoff + tx
      slots and, with a channel, its payload airtime/energy.

    Robust merge guard
      ``quarantine`` (default ON) masks non-finite updates out of the
      Eq. 1 merge and renormalizes the surviving mass — extending the
      zero-alpha-row guard to the all-quarantined case (the
      global is kept unchanged). ``clip_norm`` > 0 shrinks any update
      whose delta norm ``||w_k − g||`` exceeds it back onto the clip
      sphere (0 = off). Both reuse ``kernels/ops.delta_norm``.
    """
    # client failures
    crash_prob: float = 0.0
    straggle_prob: float = 0.0
    staleness_discount: float = 0.5
    corrupt_prob: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 1e3
    # channel burst outages
    outage_prob: float = 0.0
    outage_rounds: int = 3
    # HARQ retransmission
    max_retries: int = 0
    retry_cw_base: Optional[float] = None
    # robust merge guard
    quarantine: bool = True
    clip_norm: float = 0.0

    def __post_init__(self):
        for name in ("crash_prob", "straggle_prob", "corrupt_prob",
                     "outage_prob"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} is a probability, got {v}")
        if not (0.0 <= self.staleness_discount <= 1.0):
            raise ValueError("staleness_discount must be in [0, 1], "
                             f"got {self.staleness_discount}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}; "
                             f"known: {CORRUPT_MODES}")
        if self.outage_rounds < 1:
            raise ValueError(f"outage_rounds must be >= 1, "
                             f"got {self.outage_rounds}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.retry_cw_base is not None and self.retry_cw_base <= 0:
            raise ValueError(f"retry_cw_base must be > 0, "
                             f"got {self.retry_cw_base}")
        if self.clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0 (0 = off), "
                             f"got {self.clip_norm}")

    @property
    def merge_guarded(self) -> bool:
        """True when the Eq. 1 merge must route through the robust
        program (``robust_combine``): quarantine / clipping active, or
        a fault mode exists that can feed it corrupted or stale rows.
        Crash / outage / retry-only specs keep the untouched plain
        merge — they only change WHICH updates are delivered."""
        return (self.quarantine or self.clip_norm > 0
                or self.corrupt_prob > 0 or self.straggle_prob > 0)
