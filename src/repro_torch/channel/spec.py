"""ChannelSpec — the one config object of the wireless channel layer.

The paper abstracts the radio into CW sizes; this spec re-attaches the
physical layer the premise implies (DESIGN.md §7): per-user positions
in a cell, log-distance path loss + lognormal shadowing, SNR, a
packet-error rate per upload, Shannon-rate airtime and transmit energy,
and the knobs of the AirComp analog over-the-air merge
(``ExperimentSpec.merge_backend = "aircomp"``).

Everything is opt-in: ``ExperimentSpec.channel`` defaults to ``None``
(no channel object is ever built, no channel rng stream is consumed),
and a spec with ``per_model="off"`` + ``merge_backend="fedavg"`` is
pinned bit-identical to the no-channel reference
(``tools/check_winner_pins.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

#: supported packet-error models (see ``channel.model.packet_error_rate``)
PER_MODELS = ("off", "waterfall")
#: supported per-round small-scale fading models
FADING_MODELS = ("none", "rayleigh")


@dataclass(frozen=True)
class ChannelSpec:
    """Wireless channel of one experiment cell.

    Geometry / large-scale propagation
      ``layout_seed`` keys the position + shadowing stream (shared
      across experiment seeds so a sweep compares policies over ONE
      radio environment); users are dropped uniformly by area in the
      annulus [``min_distance_m``, ``cell_radius_m``] around the
      server; ``pl_ref_db`` + 10·``pl_exponent``·log10(d) is the
      log-distance path loss, plus N(0, ``shadowing_sigma_db``²)
      lognormal shadowing per user.

    Link budget
      ``snr_db = tx_power_dbm − path_loss_db − (noise_dbm_per_hz +
      10·log10(bandwidth_hz))`` (+ the per-round fading gain when
      ``fading="rayleigh"``).

    Packet errors
      ``per_model="waterfall"``: PER = 1 / (1 + exp((snr_db −
      per_snr_threshold_db) / per_waterfall_db)) — the classic sigmoid
      waterfall, monotone decreasing in SNR, 50% at the threshold.
      ``"off"``: PER ≡ 0 (the provably-bit-identical opt-out).

    Airtime / energy
      an upload of ``payload_bits`` at the Shannon rate
      ``bandwidth_hz · log2(1 + snr)`` takes
      ``payload_bits / rate`` seconds and costs
      ``tx_power_w · seconds`` joules — the quantities behind the
      convergence-*time* (not rounds) figures.

    AirComp (``merge_backend="aircomp"``)
      truncated channel inversion: users pre-scale so their signals
      superpose coherently; ``aircomp_gain_floor`` (relative to the
      best user's channel gain) truncates the inversion — users below
      the floor arrive attenuated (misalignment coefficient < 1);
      ``aircomp_sigma`` is the receiver-noise std before the 1/√η
      post-scaling. ``aircomp_sigma=0`` + ``aircomp_gain_floor=0``
      recovers ``fedavg_combine`` exactly (tests/test_channel.py).
    """
    # geometry / large-scale propagation
    cell_radius_m: float = 250.0
    min_distance_m: float = 5.0
    pl_exponent: float = 3.5
    pl_ref_db: float = 40.0            # loss at the 1 m reference distance
    shadowing_sigma_db: float = 6.0
    layout_seed: int = 0
    # link budget
    tx_power_dbm: float = 20.0
    noise_dbm_per_hz: float = -174.0
    bandwidth_hz: float = 1e6
    # packet errors
    per_model: str = "waterfall"
    per_snr_threshold_db: float = 5.0
    per_waterfall_db: float = 2.0
    fading: str = "none"
    # airtime / energy
    payload_bits: float = 1e5
    # AirComp over-the-air merge
    aircomp_sigma: float = 0.0
    aircomp_gain_floor: float = 0.0

    def __post_init__(self):
        if self.per_model not in PER_MODELS:
            raise ValueError(f"unknown per_model {self.per_model!r}; "
                             f"known: {PER_MODELS}")
        if self.fading not in FADING_MODELS:
            raise ValueError(f"unknown fading {self.fading!r}; "
                             f"known: {FADING_MODELS}")
        if not (0.0 <= self.aircomp_gain_floor <= 1.0):
            raise ValueError("aircomp_gain_floor is a RELATIVE gain "
                             f"in [0, 1], got {self.aircomp_gain_floor}")
        if self.min_distance_m <= 0 or \
                self.cell_radius_m < self.min_distance_m:
            raise ValueError(
                f"need 0 < min_distance_m <= cell_radius_m, got "
                f"{self.min_distance_m} / {self.cell_radius_m}")

    @property
    def tx_power_w(self) -> float:
        return 10.0 ** (self.tx_power_dbm / 10.0) * 1e-3

    @property
    def noise_power_dbm(self) -> float:
        import math
        return self.noise_dbm_per_hz + 10.0 * math.log10(self.bandwidth_hz)
