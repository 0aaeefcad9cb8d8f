"""Slotted CSMA/CA contention simulator (paper Sec. II-B / III).

Models the 802.11-style medium the paper rides on:

  * each contender draws a backoff of ``T_backoff = R * W`` seconds
    (Eq. 3), quantized to 20 us slots;
  * contenders count down while the medium is idle (countdown freezes
    during a transmission — standard CSMA/CA);
  * if two or more counters expire in the same slot the transmissions
    collide; colliders redraw from a doubled window (binary exponential
    backoff, capped), everyone else resumes;
  * a successful transmission occupies the channel for ``tx_slots`` and
    delivers one local model to the server;
  * the server closes the round after ``k_target`` deliveries (Step 5:
    the global-model broadcast doubles as the stop signal).

The numpy paths (``contend`` / ``contend_batch``) are the seeded,
bit-reproducible reference — see DESIGN.md §3.  For dense-contention
sweeps (1e5+ contenders) ``CSMASimulator(backend="device")`` routes
``contend_batch`` through the JAX/Pallas event-loop port in
``repro_torch.kernels.contention`` instead: same protocol, counter-based
threefry collision redraws, validated *distributionally* against this
reference (device threefry cannot replay numpy ``Generator`` streams —
DESIGN.md §6).

Horizon rule (both paths, both backends): an event — delivery or
collision — only happens if its airtime completes by
``max_sim_slots``; otherwise the round freezes at exactly the cap, so
``elapsed_slots <= max_sim_slots`` always and no delivery can finish
past the horizon.

Part of the numpy bit-reproducible reference path — reprolint:
reference-path (no jax imports: the winner sequences pinned by
tools/check_winner_pins.py are produced by this event loop).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

SLOT_US = 20.0  # 802.11 slot time


@dataclass
class CSMAConfig:
    slot_us: float = SLOT_US
    tx_slots: int = 50          # airtime of one model upload, in slots
    max_backoff_doublings: int = 5
    max_sim_slots: int = 2_000_000


@dataclass
class CSMAResult:
    winners: List[int]          # user ids in delivery order
    finish_slots: List[int]     # slot at which each delivery completed
    collisions: int
    elapsed_slots: int


@dataclass
class BatchCSMAResult:
    """Results of B independent contention rounds (``contend_batch``).

    Fixed-width arrays: per-round winner/finish columns beyond that
    round's delivery count are padded with -1.
    """
    winners: np.ndarray         # (B, k_target) int64, -1 padded
    finish_slots: np.ndarray    # (B, k_target) int64, -1 padded
    collisions: np.ndarray      # (B,) int64
    elapsed_slots: np.ndarray   # (B,) int64
    n_delivered: np.ndarray     # (B,) int64

    def round_result(self, b: int) -> CSMAResult:
        """View round ``b`` as a scalar CSMAResult."""
        k = int(self.n_delivered[b])
        return CSMAResult(
            winners=[int(u) for u in self.winners[b, :k]],
            finish_slots=[int(s) for s in self.finish_slots[b, :k]],
            collisions=int(self.collisions[b]),
            elapsed_slots=int(self.elapsed_slots[b]))


class CSMASimulator:
    """Deterministic slotted CSMA/CA over one contention round.

    ``backend="numpy"`` (default) is the bit-reproducible host
    reference; ``backend="device"`` runs ``contend_batch`` as a jitted
    JAX event loop (Pallas inner kernels on TPU) with counter-based
    threefry redraws — deterministic for a given simulator seed and
    call order, but a *different* stream family than numpy, so device
    results are pinned distributionally, never draw-for-draw
    (``seeds=``/``rngs=`` replay is a numpy-only contract).

    ``seed`` may be an int or a ``np.random.SeedSequence`` (the engine
    hands strategies a spawned child sequence — see ``core.rngs``).
    """

    BACKENDS = ("numpy", "device")

    def __init__(self, config: Optional[CSMAConfig] = None,
                 seed: int = 0, backend: str = "numpy", device=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown contention backend {backend!r}; "
                             f"known: {self.BACKENDS}")
        self.config = config or CSMAConfig()
        self.backend = backend
        self.device = device    # device backend: where the loop runs
        self._rng = np.random.default_rng(seed)  # reprolint: disable=RL101 # copy of a whitelisted site
        if backend == "device":
            from repro_torch.core.rngs import entropy_u64
            self._device_entropy = entropy_u64(seed)
            self._device_calls = 0

    # ---- checkpoint state (fault layer, DESIGN.md §8) ----------------
    def state_dict(self) -> dict:
        """Stream position of the collision-redraw rng (+ the device
        backend's threefry call counter) — everything a resumed run
        needs to replay the remaining contention draws bit-identically."""
        import copy
        state = {"rng": copy.deepcopy(self._rng.bit_generator.state)}
        if self.backend == "device":
            state["device_calls"] = self._device_calls
        return state

    def load_state_dict(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        if self.backend == "device" and "device_calls" in state:
            self._device_calls = int(state["device_calls"])

    def contend(self, backoff_seconds: Sequence[float],
                windows_seconds: Sequence[float],
                k_target: int,
                participating: Optional[Sequence[bool]] = None) -> CSMAResult:
        """Run one round of contention.

        backoff_seconds: initial T_backoff per user (Eq. 3 draws).
        windows_seconds: each user's CW size W (for collision redraws).
        k_target: server closes the round after this many deliveries.
        participating: counter-refrain mask (Step 4); False = silent.
        """
        if self.backend == "device":
            batch = self.contend_batch(
                np.asarray(backoff_seconds, np.float64)[None, :],
                np.asarray(windows_seconds, np.float64), k_target,
                participating=(None if participating is None else
                               np.asarray(participating, bool)[None, :]))
            return batch.round_result(0)
        cfg = self.config
        n = len(backoff_seconds)
        slot_s = cfg.slot_us * 1e-6
        counters = np.array(
            [max(0, int(round(b / slot_s))) for b in backoff_seconds],
            dtype=np.int64)
        windows = np.asarray(windows_seconds, dtype=np.float64)
        active = (np.ones(n, bool) if participating is None
                  else np.asarray(participating, bool).copy())
        doublings = np.zeros(n, np.int64)

        winners: List[int] = []
        finish_slots: List[int] = []
        collisions = 0
        t = 0
        while (len(winners) < k_target and active.any()
               and t < cfg.max_sim_slots):
            live = np.where(active)[0]
            step = int(counters[live].min())
            if t + step + cfg.tx_slots > cfg.max_sim_slots:
                # the event's airtime can't complete inside the horizon:
                # freeze at exactly the cap (no delivery past it)
                t = cfg.max_sim_slots
                break
            t += step
            counters[live] -= step
            expiring = live[counters[live] == 0]
            if len(expiring) == 1:
                u = int(expiring[0])
                t += cfg.tx_slots
                winners.append(u)
                finish_slots.append(t)
                active[u] = False
            else:
                # collision: all colliders redraw from doubled windows
                collisions += 1
                t += cfg.tx_slots  # collided airtime is still burned
                for u in expiring:
                    doublings[u] = min(doublings[u] + 1,
                                       cfg.max_backoff_doublings)
                    w = windows[u] * (2.0 ** doublings[u])
                    counters[u] = max(
                        1, int(round(self._rng.uniform(0.0, w) / slot_s)))
        return CSMAResult(winners=winners, finish_slots=finish_slots,
                          collisions=collisions, elapsed_slots=t)

    # ------------------------------------------------------------------
    def contend_batch(self, backoff_seconds, windows_seconds, k_target,
                      participating=None,
                      seeds: Optional[Sequence[int]] = None,
                      rngs: Optional[Sequence[np.random.Generator]] = None
                      ) -> BatchCSMAResult:
        """Vectorized ``contend`` over B independent contention rounds.

        Runs the same event-driven slotted CSMA/CA as :meth:`contend`,
        but advances all B rounds together with batched array ops — one
        numpy pass per *event* (delivery or collision) instead of one
        Python iteration per event per round. For sweep workloads
        (fig2-fig6 style: many rounds x many contenders) this is orders
        of magnitude faster than calling ``contend`` in a loop, and it
        scales to 1e4-1e5 contenders per round.

        backoff_seconds: (B, N) initial T_backoff draws, one row per round.
        windows_seconds: (B, N) or (N,) CW sizes for collision redraws.
        k_target: deliveries after which each round closes — an int, or a
            (B,) vector for per-row targets (sweep lanes with different
            |K^t|). Result columns are sized to the largest target.
        participating: (B, N) or (N,) bool refrain mask; None = all live.
        seeds: optional per-round RNG seeds. With ``seeds[b] = s``, row b
            reproduces ``CSMASimulator(cfg, seed=s).contend(...)`` exactly,
            winner-for-winner (the parity contract tested in
            tests/test_csma_batch.py). Default: independent per-row seeds
            drawn from this simulator's own generator.
        rngs: optional per-row ``np.random.Generator`` objects, mutually
            exclusive with ``seeds``. Unlike ``seeds`` (fresh stream per
            call), the generators are consumed in place — row b draws its
            collision redraws exactly as a scalar simulator owning
            ``rngs[b]`` would, so a *persistent* per-lane stream stays
            winner-for-winner reproducible across successive batched
            rounds. This is how the sweep engine keeps each experiment
            lane's contention stream identical to a sequential run.
            ``seeds``/``rngs`` are numpy-backend contracts: the device
            backend raises on both (threefry cannot replay them).
        """
        cfg = self.config
        slot_s = cfg.slot_us * 1e-6
        backoffs = np.atleast_2d(np.asarray(backoff_seconds, np.float64))
        B, n = backoffs.shape
        k_arr = np.broadcast_to(
            np.asarray(k_target, np.int64), (B,)).copy()
        k_target = int(k_arr.max(initial=0))
        windows = np.broadcast_to(
            np.asarray(windows_seconds, np.float64), (B, n)).copy()
        if participating is None:
            active = np.ones((B, n), bool)
        else:
            active = np.broadcast_to(
                np.asarray(participating, bool), (B, n)).copy()
        if self.backend == "device":
            if seeds is not None or rngs is not None:
                raise ValueError(
                    "seeds=/rngs= replay numpy Generator streams; the "
                    "device backend draws counter-based threefry redraws "
                    "instead (distributional parity only — DESIGN.md §6)")
            from repro_torch.kernels.contention import device_contend_batch
            self._device_calls += 1
            return device_contend_batch(
                backoffs / slot_s, windows / slot_s, k_arr, active,
                entropy=self._device_entropy,
                call_index=self._device_calls - 1,
                tx_slots=cfg.tx_slots,
                max_backoff_doublings=cfg.max_backoff_doublings,
                max_sim_slots=cfg.max_sim_slots, device=self.device)
        if rngs is not None:
            if seeds is not None:
                raise ValueError("pass seeds or rngs, not both")
            if len(rngs) != B:
                raise ValueError(f"need {B} rngs, got {len(rngs)}")
        else:
            if seeds is None:
                seeds = self._rng.integers(0, 2 ** 63 - 1, size=B)
            rngs = [np.random.default_rng(int(s)) for s in seeds]  # reprolint: disable=RL101 # copy of a whitelisted site

        # round() is half-to-even for both python floats and np.round,
        # so this matches the scalar path's per-element quantization.
        counters = np.maximum(
            0, np.round(backoffs / slot_s)).astype(np.int64)
        doublings = np.zeros((B, n), np.int64)
        t = np.zeros(B, np.int64)
        wins = np.zeros(B, np.int64)
        collisions = np.zeros(B, np.int64)
        winners = np.full((B, k_target), -1, np.int64)
        finish = np.full((B, k_target), -1, np.int64)

        def still_running():
            return ((wins < k_arr) & active.any(axis=1)
                    & (t < cfg.max_sim_slots))

        running = still_running()
        while running.any():
            live = active & running[:, None]
            # per-round idle countdown to the next expiry
            masked = np.where(live, counters, np.iinfo(np.int64).max)
            step = masked.min(axis=1)
            step = np.where(running, step, 0)
            # horizon clamp (scalar-path parity): rows whose event can't
            # complete its airtime by the cap freeze at exactly the cap
            overrun = running & (t + step + cfg.tx_slots
                                 > cfg.max_sim_slots)
            t = np.where(overrun, cfg.max_sim_slots, t)
            running = running & ~overrun
            live = live & running[:, None]
            step = np.where(running, step, 0)
            t += step
            counters = np.where(live, counters - step[:, None], counters)
            expiring = live & (counters == 0)
            nexp = expiring.sum(axis=1)

            # single expiry -> clean delivery
            single = np.where(running & (nexp == 1))[0]
            if len(single):
                u = np.argmax(expiring[single], axis=1)
                t[single] += cfg.tx_slots
                winners[single, wins[single]] = u
                finish[single, wins[single]] = t[single]
                wins[single] += 1
                active[single, u] = False

            # >=2 expiries -> collision; colliders redraw from doubled CWs
            collided = np.where(running & (nexp >= 2))[0]
            if len(collided):
                collisions[collided] += 1
                t[collided] += cfg.tx_slots
                for b in collided:
                    cols = np.where(expiring[b])[0]
                    doublings[b, cols] = np.minimum(
                        doublings[b, cols] + 1, cfg.max_backoff_doublings)
                    for u in cols:   # index order matches the scalar path
                        w = windows[b, u] * (2.0 ** doublings[b, u])
                        counters[b, u] = max(
                            1, int(round(rngs[b].uniform(0.0, w) / slot_s)))
            running = still_running()

        return BatchCSMAResult(winners=winners, finish_slots=finish,
                               collisions=collisions, elapsed_slots=t,
                               n_delivered=wins)
