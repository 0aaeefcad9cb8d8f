"""Objectives subsystem — the frozen ``ObjectiveSpec`` and the registry
descriptors are ported; the training law and the server-opt kernel are
not (a non-plain objective raises ``NotImplementedError``)."""
from repro_torch.objectives.server import (ObjectiveTable,
                                           build_objective_table)
from repro_torch.objectives.spec import (LOCAL_OBJECTIVES,
                                         SERVER_AGGREGATORS, LocalObjective,
                                         ObjectiveSpec, ServerAggregator,
                                         register_local, register_server)

__all__ = [
    "ObjectiveSpec", "ObjectiveTable", "build_objective_table",
    "LocalObjective", "ServerAggregator", "register_local",
    "register_server", "LOCAL_OBJECTIVES", "SERVER_AGGREGATORS",
]
