"""Objectives subsystem: registered local objectives (FedAvg / FedProx /
FedDyn) + server aggregators (FedAvg / FedAvgM / FedAdam), run on
HostBackend's fused and winner-sparse round paths: the local law in the
training loop (``objective_epoch_scan``; on the sparse path over the
prepass chunks and the winner stack, with the rows' FedDyn h), the
server step after Eq. 1 (``kernels.ops.server_opt_leaves``), the FedDyn
h update at merge time; a sweep's lanes each run their own (the
objective is a sweep axis)."""
from repro_torch.objectives.local import objective_epoch_scan
from repro_torch.objectives.server import (ObjectiveTable,
                                           build_objective_table)
from repro_torch.objectives.spec import (LOCAL_OBJECTIVES,
                                         SERVER_AGGREGATORS, LocalObjective,
                                         ObjectiveSpec, ServerAggregator,
                                         register_local, register_server)

__all__ = [
    "ObjectiveSpec", "ObjectiveTable", "build_objective_table",
    "objective_epoch_scan", "LocalObjective", "ServerAggregator",
    "register_local", "register_server",
    "LOCAL_OBJECTIVES", "SERVER_AGGREGATORS",
]
