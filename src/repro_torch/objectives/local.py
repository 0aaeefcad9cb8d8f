"""Local-objective registrations.

Only the descriptors are ported so far — ``ObjectiveSpec`` validates
names against them. The generalized gradient law
(``objective_epoch_scan``) is not, and a non-plain objective raises
``NotImplementedError`` in the backend.
"""
from __future__ import annotations

from repro_torch.objectives.spec import LocalObjective, register_local

register_local(LocalObjective("fedavg", uses_h=False, coeff=lambda s: 0.0))
register_local(LocalObjective("fedprox", uses_h=False, coeff=lambda s: s.mu))
register_local(LocalObjective("feddyn", uses_h=True, coeff=lambda s: s.alpha))
