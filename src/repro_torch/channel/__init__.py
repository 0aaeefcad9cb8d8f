"""Wireless channel subsystem.

Opt-in physical layer under the paper's MAC-layer contention: SNR /
path-loss models per user, packet-error-gated uploads, airtime / energy
accounting in seconds, and the AirComp over-the-air merge inputs. The
model is numpy (a copy of the reference's); the AirComp merge itself is
the ``aircomp_combine`` kernel of ``repro_torch.kernels``.

    from repro_torch.channel import ChannelSpec, ChannelModel

    spec = ExperimentSpec(channel=ChannelSpec(tx_power_dbm=10.0),
                          merge_backend="aircomp")

With ``ExperimentSpec.channel`` unset no channel rng stream exists and
the round is the no-channel one.
"""
from repro_torch.channel.model import (ChannelModel, MergeContext,
                                       packet_error_rate, path_loss_db,
                                       shannon_rate_bps, snr_db, stack_snr,
                                       upload_seconds)
from repro_torch.channel.spec import FADING_MODELS, PER_MODELS, ChannelSpec

__all__ = [
    "ChannelSpec", "ChannelModel", "MergeContext", "PER_MODELS",
    "FADING_MODELS", "path_loss_db", "snr_db", "packet_error_rate",
    "shannon_rate_bps", "upload_seconds", "stack_snr",
]
