"""Registered local objectives and server aggregators (DESIGN.md §10).

``ObjectiveSpec`` is the frozen, hashable config carried on
``ExperimentSpec.objective``.  It selects

* a **local objective** — the per-step gradient law run inside the
  fused/sparse/sweep training scans (``fedavg`` plain SGD, ``fedprox``
  proximal term, ``feddyn`` dynamic regularizer with per-user h-state),
* a **server aggregator** — the post-Eq.-1 update applied to the merged
  global (``fedavg`` identity, ``fedavgm`` server momentum, ``fedadam``).

It is deliberately NOT in ``SWEEP_SHARED_FIELDS``: the objective is a
sweep axis, so one ``run_sweep`` compares selection strategies across
optimizers (the paper's fig3 question under heterogeneity-aware
optimization).

Bit-transparency contract (pinned by tools/check_winner_pins.py twins):
``fedprox(mu=0)``, ``feddyn(alpha=0)`` and ``fedavgm(beta=0,
server_lr=1)`` produce bit-equal winners AND merged globals vs the plain
``fedavg`` path in fused, sparse, and sweep modes.  ``fedadam`` has no
inert setting (the eps-damped step never reduces to the average).

RNG contract: objectives draw NOTHING — all optimizer state (server
m/v, FedDyn h) is zero-initialized, so enabling an objective never
perturbs engine/strategy/client/channel/fault streams (core/rngs.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LocalObjective:
    """Descriptor for a registered local objective.

    ``coeff(spec)`` is the proximal coefficient folded into the per-step
    gradient as ``g + coeff * (w - w_global)``; ``uses_h`` marks
    objectives that carry per-user FedDyn-style h-state (subtracted from
    the gradient each step, updated at merge time).
    """

    name: str
    uses_h: bool
    coeff: Callable[["ObjectiveSpec"], float]


@dataclasses.dataclass(frozen=True)
class ServerAggregator:
    """Descriptor for a registered server aggregator.

    ``kind`` is consts[0] of the ``server_opt_combine`` kernel law:
    0 = identity (plain Eq. 1 average), 1 = momentum (FedAvgM),
    2 = adam (FedAdam).  ``uses_state`` marks aggregators that carry
    device-resident m/v state next to the global.
    """

    name: str
    kind: int
    uses_state: bool


LOCAL_OBJECTIVES: Dict[str, LocalObjective] = {}
SERVER_AGGREGATORS: Dict[str, ServerAggregator] = {}


def register_local(desc: LocalObjective) -> LocalObjective:
    if desc.name in LOCAL_OBJECTIVES:
        raise ValueError(f"local objective {desc.name!r} already registered")
    LOCAL_OBJECTIVES[desc.name] = desc
    return desc


def register_server(desc: ServerAggregator) -> ServerAggregator:
    if desc.name in SERVER_AGGREGATORS:
        raise ValueError(f"server aggregator {desc.name!r} already registered")
    SERVER_AGGREGATORS[desc.name] = desc
    return desc


def _ensure_registered() -> None:
    # Importing the default implementations registers them; done lazily
    # so `from repro_torch.objectives.spec import ObjectiveSpec` alone works.
    import repro_torch.objectives.local   # noqa: F401
    import repro_torch.objectives.server  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """Frozen (local objective, server aggregator) selection.

    Hashable so SweepSpec's shared-field set check and dict program
    caches work.  Defaults are the plain pre-registry path.
    """

    local: str = "fedavg"          # registered local objective name
    aggregator: str = "fedavg"     # registered server aggregator name
    mu: float = 0.0                # fedprox proximal coefficient
    alpha: float = 0.0             # feddyn dynamic-regularizer coefficient
    server_lr: float = 1.0         # server-side lr (fedavgm / fedadam)
    beta: float = 0.9              # server momentum / adam beta1
    beta2: float = 0.99            # adam second-moment decay
    eps: float = 1e-3              # adam denominator damping

    def __post_init__(self) -> None:
        _ensure_registered()
        if self.local not in LOCAL_OBJECTIVES:
            raise ValueError(
                f"unknown local objective {self.local!r}; "
                f"registered: {sorted(LOCAL_OBJECTIVES)}")
        if self.aggregator not in SERVER_AGGREGATORS:
            raise ValueError(
                f"unknown server aggregator {self.aggregator!r}; "
                f"registered: {sorted(SERVER_AGGREGATORS)}")
        if self.mu < 0.0:
            raise ValueError("fedprox mu must be >= 0")
        if self.alpha < 0.0:
            raise ValueError("feddyn alpha must be >= 0")
        if self.server_lr <= 0.0:
            raise ValueError("server_lr must be > 0")
        if not (0.0 <= self.beta < 1.0) or not (0.0 <= self.beta2 < 1.0):
            raise ValueError("beta/beta2 must be in [0, 1)")
        if self.eps <= 0.0:
            raise ValueError("eps must be > 0")

    # -- structural flags (decide which compiled program variant runs) --

    @property
    def uses_local(self) -> bool:
        """True when the training scan needs the generalized grad law."""
        return self.local != "fedavg"

    @property
    def uses_h(self) -> bool:
        """True when per-user h-state rides along (feddyn)."""
        return LOCAL_OBJECTIVES[self.local].uses_h

    @property
    def uses_server(self) -> bool:
        """True when the merge needs server-opt m/v state."""
        return SERVER_AGGREGATORS[self.aggregator].kind != 0

    @property
    def is_plain(self) -> bool:
        """Plain FedAvg both sides: dispatch to the untouched pre-PR
        programs (zero overhead, trivially bit-identical)."""
        return self.local == "fedavg" and self.aggregator == "fedavg"

    # -- compiled-program coefficients --

    @property
    def prox_coeff(self) -> float:
        """Coefficient of the (w - w_global) gradient term."""
        return float(LOCAL_OBJECTIVES[self.local].coeff(self))

    @property
    def alpha_coeff(self) -> float:
        """Coefficient of the merge-time h update (0 unless feddyn)."""
        return float(self.alpha) if self.uses_h else 0.0

    def server_consts(self) -> np.ndarray:
        """(5,) f32 [kind, beta1, beta2, server_lr, eps] for
        kernels/ops.server_opt_combine."""
        kind = SERVER_AGGREGATORS[self.aggregator].kind
        return np.asarray(
            [kind, self.beta, self.beta2, self.server_lr, self.eps],
            dtype=np.float32)
