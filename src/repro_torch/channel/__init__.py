"""Wireless channel subsystem — only the frozen ``ChannelSpec`` is
ported so far (``ExperimentSpec`` carries it); the channel model and
the AirComp merge are not, and a non-``None`` ``spec.channel`` raises
``NotImplementedError`` in the engine."""
from repro_torch.channel.spec import FADING_MODELS, PER_MODELS, ChannelSpec

__all__ = ["ChannelSpec", "PER_MODELS", "FADING_MODELS"]
