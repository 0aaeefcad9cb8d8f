"""Fault-tolerance layer: failure injection, HARQ retransmission,
robust merge guards. ``ExperimentSpec.faults = None`` keeps the whole
subsystem off and bit-transparent."""
from repro_torch.faults.injectors import FaultInjector, RoundFaults
from repro_torch.faults.robust import fault_alphas, robust_merge
from repro_torch.faults.spec import CORRUPT_MODES, FaultSpec

__all__ = ["CORRUPT_MODES", "FaultInjector", "FaultSpec", "RoundFaults",
           "fault_alphas", "robust_merge"]
