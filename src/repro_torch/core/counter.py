"""Fairness counter (paper Sec. III, Steps 4-5).

Each user maintains ``counter_k = uploads_k / total_merged`` where
``total_merged = sum_t |K^t|``. Before uploading, a user whose counter
exceeds the threshold refrains (Step 4). After the round's broadcast
(Step 5) every user updates: winners increment the numerator by one;
everyone increments the denominator by |K^t|.

The state is intentionally per-user-maintainable (a user only needs its
own upload count and the running total announced implicitly by the
broadcasts) — that is what keeps the scheme distributed.

Part of the numpy bit-reproducible reference path — reprolint:
reference-path (no jax imports; the refrain mask feeds the pinned
winner sequences).
"""
from __future__ import annotations

import numpy as np


class FairnessCounter:
    def __init__(self, num_users: int, threshold: float = 0.16):
        self.num_users = num_users
        self.threshold = threshold
        self.uploads = np.zeros(num_users, np.int64)
        self.total_merged = 0

    def values(self) -> np.ndarray:
        if self.total_merged == 0:
            return np.zeros(self.num_users)
        return self.uploads / self.total_merged

    def participating(self, values: np.ndarray = None) -> np.ndarray:
        """Step 4 mask: True = may upload this round.

        ``values`` optionally supplies the upload shares already computed
        this round (the engine computes them ONCE per round and passes
        them both here and into the SelectionContext, instead of
        re-deriving them per strategy call).
        """
        if values is None:
            values = self.values()
        return values < self.threshold

    def update(self, winners, k_t: int) -> None:
        """Step 5: winners bump numerator; everyone bumps denominator."""
        for u in winners:
            self.uploads[u] += 1
        self.total_merged += int(k_t)

    def state_dict(self):
        return {"uploads": self.uploads.copy(),
                "total_merged": self.total_merged}

    def load_state_dict(self, state) -> None:
        self.uploads[:] = np.asarray(state["uploads"], np.int64)
        self.total_merged = int(state["total_merged"])


class SweepFairnessCounter:
    """E independent fairness counters advanced with vectorized updates.

    One per-lane ``FairnessCounter`` per sweep experiment would be
    correct but costs E Python loops per round; this class keeps the
    identical integer state — ``uploads[e, u]`` and ``total_merged[e]``
    — as (E, U) arrays and applies one ``np.add.at`` per round across
    every lane. Lane e's values/mask/update math is bit-identical to a
    scalar counter fed the same winner sequence (pinned in
    tests/test_sweep.py).

    ``thresholds`` may be a scalar or an (E,) vector — sweep cells are
    allowed to vary the refrain threshold.
    """

    def __init__(self, num_lanes: int, num_users: int, thresholds=0.16):
        self.num_lanes = num_lanes
        self.num_users = num_users
        self.thresholds = np.broadcast_to(
            np.asarray(thresholds, np.float64), (num_lanes,)).copy()
        self.uploads = np.zeros((num_lanes, num_users), np.int64)
        self.total_merged = np.zeros(num_lanes, np.int64)

    def values(self) -> np.ndarray:
        """(E, U) upload shares; exact zeros for lanes with no merges."""
        denom = np.maximum(self.total_merged, 1)[:, None]
        return self.uploads / denom

    def participating(self, values: np.ndarray = None) -> np.ndarray:
        """(E, U) Step 4 masks; pass precomputed ``values`` to avoid a
        second shares computation in the same round."""
        if values is None:
            values = self.values()
        return values < self.thresholds[:, None]

    def update(self, winners_per_lane) -> None:
        """Step 5 across all lanes at once.

        ``winners_per_lane``: sequence of per-lane winner id lists (empty
        list = winnerless lane: numerator AND denominator untouched,
        matching the scalar engine which skips ``update`` entirely).
        """
        nonempty = [(e, w) for e, w in enumerate(winners_per_lane)
                    if len(w)]
        if nonempty:
            lanes = np.concatenate([np.full(len(w), e, np.int64)
                                    for e, w in nonempty])
            users = np.concatenate([np.asarray(w, np.int64)
                                    for _, w in nonempty])
            np.add.at(self.uploads, (lanes, users), 1)
        self.total_merged += np.array(
            [len(w) for w in winners_per_lane], np.int64)

    def lane_state(self, e: int):
        return {"uploads": self.uploads[e].copy(),
                "total_merged": int(self.total_merged[e])}

    def state_dict(self):
        return {"uploads": self.uploads.copy(),
                "total_merged": self.total_merged.copy()}

    def load_state_dict(self, state) -> None:
        self.uploads[:] = np.asarray(state["uploads"], np.int64)
        self.total_merged[:] = np.asarray(state["total_merged"], np.int64)
