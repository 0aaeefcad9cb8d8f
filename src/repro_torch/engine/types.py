"""Shared value types of the engine API (DESIGN.md §2).

``SelectionContext`` is everything a strategy may look at when picking
the round's uploaders; ``SelectionResult`` is what it hands back —
winners *plus* the contention cost (collisions / airtime) so the
orchestrator can account for the medium, not just the outcome.

``SelectionResult`` is deliberately sequence-like (iteration, len,
indexing, equality against lists): pre-engine code treated a strategy's
return value as a plain winner list, and every such call site keeps
working unchanged against the richer type.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np


@dataclass
class SelectionContext:
    """Per-round inputs to ``Strategy.select``.

    The first five fields are the classic (paper) surface; the optional
    tail exists for registry strategies that exploit side information —
    ``counter_values`` for adaptive bias, ``heterogeneity`` for
    data-aware scoring. Strategies must treat every optional field as
    possibly-None (legacy callers construct contexts without them).
    """
    priorities: np.ndarray           # (K,) Eq. 2 values (1.0 if unused)
    participating: np.ndarray        # (K,) counter mask (Step 4)
    k_target: int
    rng: np.random.Generator
    cw_base: float = 2048.0          # N in Eq. 3
    counter_values: Optional[np.ndarray] = None   # (K,) upload shares
    heterogeneity: Optional[np.ndarray] = None    # (K,) data-divergence in [0,1]
    snr_db: Optional[np.ndarray] = None           # (K,) current-round SNR
    #                                               (None = no channel layer)
    round_index: int = 0


@dataclass
class SelectionResult:
    """Winners in delivery order + contention statistics."""
    winners: List[int]
    collisions: int = 0
    elapsed_slots: int = 0
    finish_slots: List[int] = field(default_factory=list)

    # -- sequence protocol: behaves like the old bare winner list ------
    def __iter__(self):
        return iter(self.winners)

    def __len__(self):
        return len(self.winners)

    def __getitem__(self, i):
        return self.winners[i]

    def __contains__(self, u):
        return u in self.winners

    def __bool__(self):
        return bool(self.winners)

    def __eq__(self, other):
        if isinstance(other, SelectionResult):
            return (self.winners == other.winners
                    and self.collisions == other.collisions
                    and self.elapsed_slots == other.elapsed_slots)
        if isinstance(other, (list, tuple)):
            return self.winners == list(other)
        return NotImplemented

    def __hash__(self):
        # a hand-written __eq__ on a dataclass implicitly sets
        # __hash__ = None; results must stay usable in sets / dict keys
        # (hash on the same fields __eq__ compares against peers)
        return hash((tuple(self.winners), self.collisions,
                     self.elapsed_slots))


@dataclass
class TrainResult:
    """One backend training pass.

    ``losses`` is either a dict mapping trained user id -> mean local
    loss (partial-cohort rounds) or a dense (num_users,) float vector
    (full-cohort rounds — the fused path returns the vector to avoid
    an O(U) per-element Python conversion at 1e4+ users).
    ``priorities`` is dense over all users (1.0 where untrained / not
    computed). ``local_handle`` is backend-opaque — hand it back to the
    same backend's ``merge``.
    """
    losses: Union[Dict[int, float], np.ndarray]
    priorities: np.ndarray
    local_handle: Any = None


@dataclass
class FLHistory:
    """Round-by-round record of one engine run.

    ``winners`` are the selection layer's outcomes (contention winners
    = upload ATTEMPTS — what the fairness counters and ``selections``
    histogram see); ``delivered`` the subset whose upload survived the
    channel and entered the Eq. 1 merge. Without a channel layer the
    two are identical and ``upload_failures`` stays 0.

    Wall-clock accounting (the convergence-*time* figures):
    ``round_seconds[t]`` = contention slots · ``slot_duration_s`` plus,
    with a channel, the attempted uploads' payload airtime at each
    user's Shannon rate; ``cumulative_seconds`` is its running sum and
    ``round_energy_j`` the attempted uploads' transmit energy.
    """
    accuracy: List[float] = field(default_factory=list)
    eval_round: List[int] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)
    selections: Optional[np.ndarray] = None    # (num_users,) counts
    priorities: List[List[float]] = field(default_factory=list)
    collisions: int = 0
    uploads_total: int = 0
    contention_slots: int = 0                  # total airtime+backoff slots
    winners: List[List[int]] = field(default_factory=list)  # per round
    # channel layer: delivery + wall-clock/energy accounting
    delivered: List[List[int]] = field(default_factory=list)  # per round
    upload_failures: int = 0                   # attempts lost to the channel
    round_seconds: List[float] = field(default_factory=list)
    cumulative_seconds: List[float] = field(default_factory=list)
    round_energy_j: List[float] = field(default_factory=list)
    # fault layer (DESIGN.md §8): with faults enabled,
    # ``delivered`` records the post-fault arrivals (crash/outage losses
    # removed, HARQ recoveries added) and ``upload_failures`` the
    # attempts still lost AFTER the retry budget
    retries: int = 0                           # HARQ retransmission attempts
    dropped_clients: int = 0                   # winners lost to crashes
    quarantined_updates: int = 0               # masked by the robust merge
    stale_merges: int = 0                      # λ-discounted late merges

    def elapsed_seconds(self) -> float:
        """Total simulated wall-clock of the run so far."""
        return self.cumulative_seconds[-1] if self.cumulative_seconds \
            else 0.0

    def time_to_accuracy(self, target: float) -> Optional[float]:
        """Simulated seconds until ``accuracy >= target`` was first
        evaluated, or None if never reached — the convergence-time-vs-
        bandwidth figure's y-axis.

        An eval recorded past the last accounted round (e.g. a post-run
        final eval at ``t == rounds``) clamps to the run's elapsed
        time instead of silently dropping a reached target."""
        for acc, t in zip(self.accuracy, self.eval_round):
            if acc >= target:
                if t < len(self.cumulative_seconds):
                    return self.cumulative_seconds[t]
                return self.elapsed_seconds()
        return None


@dataclass
class SweepResult:
    """E per-cell histories out of one ``FLEngine.run_sweep`` call.

    Sequence-like over the histories (iteration / len / indexing), with
    the cells' specs and labels riding along so reporting code can
    group results without re-deriving which lane was which.
    ``final_globals`` is the (E, ...) stacked pytree of every lane's
    final global model (device-resident); ``lane_params(e)`` slices one
    lane out for eval / checkpointing.
    """
    histories: List[FLHistory]
    specs: List[Any]                           # the cells' ExperimentSpecs
    labels: Optional[List[str]] = None
    overlap: bool = True
    wall_s: float = 0.0
    final_globals: Any = None                  # (E, ...) stacked params

    def __len__(self):
        return len(self.histories)

    def __iter__(self):
        return iter(self.histories)

    def __getitem__(self, i):
        return self.histories[i]

    def by_label(self, label: str) -> FLHistory:
        if self.labels is None:
            raise KeyError("sweep has no labels")
        return self.histories[self.labels.index(label)]

    def lane_params(self, e: int):
        """Lane e's final global params pytree."""
        if self.final_globals is None:
            raise ValueError("sweep carried no final params")
        from repro_torch.tree import tree_map
        return tree_map(lambda p: p[e], self.final_globals)
