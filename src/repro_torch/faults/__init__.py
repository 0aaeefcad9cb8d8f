"""Fault-tolerance layer — only the frozen ``FaultSpec`` is ported so
far (``ExperimentSpec`` carries it); injectors and the robust merge are
not, and a non-``None`` ``spec.faults`` raises ``NotImplementedError``
in the engine."""
from repro_torch.faults.spec import CORRUPT_MODES, FaultSpec

__all__ = ["CORRUPT_MODES", "FaultSpec"]
