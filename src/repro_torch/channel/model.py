"""Channel model layer: positions → path loss → SNR → PER / airtime /
energy, plus the AirComp power-control coefficients (DESIGN.md §7).

The pure laws (``path_loss_db`` / ``snr_db`` / ``packet_error_rate`` /
``shannon_rate_bps``) are numpy-vectorized over any leading shape — the
sweep layer stacks E lanes' per-user vectors into (E, U) matrices with
plain broadcasting (``stack_snr``). ``ChannelModel`` owns ONE
experiment cell's radio state and rng streams:

  * geometry (positions + static shadowing) rides the
    ``layout_seed``-keyed stream, shared across experiment seeds;
  * per-upload packet-error outcomes and per-round fading draws ride
    independent spawn children of the EXPERIMENT seed (``core.rngs``),
    so enabling the channel never perturbs the engine / strategy /
    client streams — the subsystem is provably opt-in.

Gating semantics (the engine's contract): ``gate(attempted)`` draws one
uniform per attempted upload, in delivery order, and returns the
delivered subset. The fairness counters and selection histograms see
the ATTEMPT (the user spent its airtime either way); only the Eq. 1
merge weights see the delivered subset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.channel.spec import ChannelSpec
from repro_torch.core.rngs import (channel_fading_rng, channel_layout_rng,
                             channel_noise_entropy, channel_outcome_rng)

# ---------------------------------------------------------------- laws


def path_loss_db(distance_m, spec: ChannelSpec):
    """Log-distance path loss (no shadowing): ``pl_ref_db`` at 1 m plus
    ``10 · pl_exponent · log10(d)`` — strictly monotone in distance."""
    d = np.maximum(np.asarray(distance_m, np.float64), 1.0)
    return spec.pl_ref_db + 10.0 * spec.pl_exponent * np.log10(d)


def snr_db(path_loss_total_db, spec: ChannelSpec):
    """Link budget: tx power − path loss − thermal noise over the band."""
    return (spec.tx_power_dbm - np.asarray(path_loss_total_db, np.float64)
            - spec.noise_power_dbm)


def packet_error_rate(snr_db_vals, spec: ChannelSpec):
    """Per-upload PER in [0, 1], monotone non-increasing in SNR.

    ``waterfall``: the sigmoid 1 / (1 + exp((snr − thr) / width)) — 50%
    at ``per_snr_threshold_db``, steeper for smaller
    ``per_waterfall_db``. ``off``: exact zeros (the bit-identical
    opt-out the winner-pin guard covers).
    """
    s = np.asarray(snr_db_vals, np.float64)
    if spec.per_model == "off":
        return np.zeros_like(s)
    z = (s - spec.per_snr_threshold_db) / max(spec.per_waterfall_db, 1e-9)
    # clip the exponent: exp(±1000) overflow warnings, not better PERs
    return 1.0 / (1.0 + np.exp(np.clip(z, -60.0, 60.0)))


def shannon_rate_bps(snr_db_vals, spec: ChannelSpec):
    """Achievable uplink rate ``B · log2(1 + snr)`` in bits/s."""
    lin = 10.0 ** (np.asarray(snr_db_vals, np.float64) / 10.0)
    return spec.bandwidth_hz * np.log2(1.0 + lin)


def upload_seconds(snr_db_vals, spec: ChannelSpec):
    """Seconds to push one ``payload_bits`` model at the Shannon rate."""
    return spec.payload_bits / np.maximum(
        shannon_rate_bps(snr_db_vals, spec), 1e-9)


# --------------------------------------------------------------- model


class ChannelModel:
    """One experiment cell's radio: static geometry + per-round state.

    ``begin_round`` must be called once per round BEFORE selection (it
    redraws block fading, which the SNR the strategies see must
    reflect); ``gate`` once per round with the contention winners.
    """

    def __init__(self, spec: ChannelSpec, num_users: int, seed: int = 0):
        self.spec = spec
        self.num_users = num_users
        layout = channel_layout_rng(spec.layout_seed)
        # uniform-by-area drop in the [min_distance, cell_radius] annulus
        r2 = layout.uniform(spec.min_distance_m ** 2,
                            spec.cell_radius_m ** 2, num_users)
        self.distances_m = np.sqrt(r2)
        self.angles_rad = layout.uniform(0.0, 2 * np.pi, num_users)
        self.shadowing_db = (
            layout.normal(0.0, spec.shadowing_sigma_db, num_users)
            if spec.shadowing_sigma_db > 0 else np.zeros(num_users))
        self.path_loss_db = (path_loss_db(self.distances_m, spec)
                             + self.shadowing_db)
        self._outcome_rng = channel_outcome_rng(seed)
        self._fading_rng = (channel_fading_rng(seed)
                            if spec.fading == "rayleigh" else None)
        self._fading_gain_db = np.zeros(num_users)
        self.noise_entropy = channel_noise_entropy(seed)

    # ---- checkpoint state (fault layer, DESIGN.md §8) ----------------
    def state_dict(self) -> dict:
        """Per-round mutable state: the outcome/fading stream positions
        and the current fading gains. Geometry is spec-derived
        (rebuilt identically on resume) and not stored."""
        import copy
        return {
            "outcome": copy.deepcopy(self._outcome_rng.bit_generator.state),
            "fading": (copy.deepcopy(self._fading_rng.bit_generator.state)
                       if self._fading_rng is not None else None),
            "fading_gain_db": self._fading_gain_db.copy(),
        }

    def load_state_dict(self, state: dict) -> None:
        self._outcome_rng.bit_generator.state = state["outcome"]
        if self._fading_rng is not None and state["fading"] is not None:
            self._fading_rng.bit_generator.state = state["fading"]
        self._fading_gain_db = np.asarray(state["fading_gain_db"],
                                          np.float64).copy()

    # ---- per-round state ---------------------------------------------
    def begin_round(self) -> None:
        """Advance per-round channel state (block fading)."""
        if self._fading_rng is not None:
            g = self._fading_rng.exponential(1.0, self.num_users)
            self._fading_gain_db = 10.0 * np.log10(np.maximum(g, 1e-12))

    @property
    def snr_db(self) -> np.ndarray:
        """(U,) current-round SNR (includes this round's fading)."""
        return snr_db(self.path_loss_db - self._fading_gain_db, self.spec)

    @property
    def per(self) -> np.ndarray:
        """(U,) current-round per-upload packet-error rates."""
        return packet_error_rate(self.snr_db, self.spec)

    @property
    def upload_seconds(self) -> np.ndarray:
        """(U,) current-round payload airtime per user."""
        return upload_seconds(self.snr_db, self.spec)

    # ---- upload gating ------------------------------------------------
    def gate(self, attempted: Sequence[int]) -> List[int]:
        """Delivered subset of ``attempted`` (order preserved).

        Exactly ``len(attempted)`` uniforms are consumed from the
        outcome stream, in delivery order, so the draw count is a
        function of the winner sequence alone (reproducibility
        contract). ``per_model="off"`` delivers everything while still
        consuming the same draws (stream-position invariance).
        """
        if not len(attempted):
            return []
        per = self.per
        draws = self._outcome_rng.uniform(0.0, 1.0, len(attempted))
        return [int(u) for u, r in zip(attempted, draws)
                if r >= per[int(u)]]

    # ---- airtime / energy accounting ---------------------------------
    def round_airtime_s(self, attempted: Sequence[int]) -> float:
        """Payload seconds spent by this round's attempted uploads."""
        if not len(attempted):
            return 0.0
        return float(self.upload_seconds[list(map(int, attempted))].sum())

    def round_energy_j(self, attempted: Sequence[int]) -> float:
        """Transmit energy of this round's attempted uploads."""
        return self.spec.tx_power_w * self.round_airtime_s(attempted)

    # ---- AirComp power control ---------------------------------------
    def aircomp_coeffs(self):
        """(coeffs (U,) f32, effective receiver-noise std) for the
        over-the-air merge.

        Truncated channel inversion against the normalized channel
        gains g_k / g_max: with ``eta = P · max(g_min, floor)``, user k
        transmits at ``min(√P, √(eta / g_k))`` and arrives with the
        misalignment coefficient ``c_k = min(1, √(g_k / (eta/P)))`` —
        exactly 1 (coherent) above the truncation floor, attenuated
        below it. The receiver noise std after the 1/√eta post-scaling
        is ``aircomp_sigma / √eta``; both are exact identities
        (coeffs ≡ 1, noise ≡ 0) when ``floor = 0`` and ``sigma = 0``.
        """
        sp = self.spec
        gain = 10.0 ** (-(self.path_loss_db - self._fading_gain_db) / 10.0)
        gnorm = gain / gain.max()
        floor = max(float(gnorm.min()), sp.aircomp_gain_floor)
        coeffs = np.minimum(1.0, np.sqrt(gnorm / floor)).astype(np.float32)
        noise_sigma = float(sp.aircomp_sigma) / np.sqrt(floor)
        return coeffs, float(noise_sigma)


# ------------------------------------------------------- sweep helpers


@dataclass
class MergeContext:
    """Per-merge AirComp inputs the engine hands the backend.

    Single-lane form: ``coeffs`` (U,), scalar ``noise_sigma``, one PRNG
    ``key``. Sweep form (``sweep_merge``): ``coeffs`` (E, U),
    ``noise_sigma`` (E,), ``key`` a stacked (E, ...) key array — lanes
    without a channel ride along with coeffs ≡ 1, sigma = 0.
    """
    coeffs: np.ndarray
    noise_sigma: Any
    key: Any


def stack_snr(channels: Sequence[Optional[ChannelModel]],
              num_users: int) -> Optional[np.ndarray]:
    """(E, U) SNR matrix over sweep lanes, or None when no lane has a
    channel. Lanes without a channel read +inf (a perfect wire)."""
    if not any(c is not None for c in channels):
        return None
    out = np.full((len(channels), num_users), np.inf)
    for e, c in enumerate(channels):
        if c is not None:
            out[e] = c.snr_db
    return out
