"""The paper's primary contribution: network-intrinsic distributed user
selection for federated learning via random-access (CSMA) contention.

Public API:
    priority.model_priority       Eq. 2 layer-wise distance -> priority
    csma.CSMASimulator            slotted CSMA/CA contention (+ contend_batch)
    counter.FairnessCounter       Step 4/5 refrain rule (+ the vectorized
                                  SweepFairnessCounter)

Round orchestration and the strategy registry live in
``repro_torch.engine``.
"""
from repro_torch.core.priority import model_priority, layer_distance_ratios
from repro_torch.core.csma import CSMASimulator, CSMAConfig
from repro_torch.core.counter import FairnessCounter, SweepFairnessCounter

__all__ = ["model_priority", "layer_distance_ratios", "CSMASimulator",
           "CSMAConfig", "FairnessCounter", "SweepFairnessCounter"]
