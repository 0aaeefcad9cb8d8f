"""Experiment specification — the single config object driving FLEngine.

Backend-agnostic: the same spec runs the paper's host simulation
(``HostBackend``) and the cross-silo TPU path (``SiloBackend``); only
the backend construction differs. ``strategy_options`` forwards keyword
arguments to the registered strategy class (e.g. ``{"gamma": 2.0}`` for
``hetero-topk``), so new strategies need no spec changes.

``SweepSpec`` is the sweep-native unit (DESIGN.md §5): E independent
experiment cells — (strategy, seed, CW, bias, counter, ...) variations
over ONE dataset/model — that ``FLEngine.run_sweep`` stacks into a
single device program. Cells may vary every selection-layer field; the
training-side fields consumed by the shared backend (``lr``,
``batch_size``, ``local_epochs``) and the round horizon must agree
across cells, which ``SweepSpec`` validates at construction.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.channel.spec import ChannelSpec
from repro_torch.core.csma import CSMAConfig
from repro_torch.faults.spec import FaultSpec
from repro_torch.objectives.spec import ObjectiveSpec

#: Eq. 1 merge implementations the backends know how to build
MERGE_BACKENDS = ("fedavg", "aircomp")

#: HostBackend round paths (DESIGN.md §3/§9); None = auto-select
#: ("sparse" when K ≪ U over a rectangular cohort, else "fused")
ROUND_MODES = ("fused", "stacked", "ragged", "sparse")

#: Eq. 2 orderings for the winner-sparse round path (DESIGN.md §9):
#: "prepass" trains-and-discards the full cohort in bounded chunks for
#: exact (bit-identical) priorities; "stale" reuses each user's
#: last-trained priority (O(K) FLOPs, distributional parity only)
SPARSE_PRIORITY_MODES = ("prepass", "stale")


@dataclass(frozen=True)
class ExperimentSpec:
    # round structure
    k_per_round: int = 2          # |K^t|
    rounds: int = 100
    eval_every: int = 1
    # selection layer (the paper's contribution)
    strategy: str = "priority-distributed"
    strategy_options: Dict[str, Any] = field(default_factory=dict)
    cw_base: float = 2048.0       # N in Eq. 3
    use_counter: bool = True
    counter_threshold: float = 0.16
    csma: CSMAConfig = field(default_factory=CSMAConfig)
    #: contention engine: "numpy" (bit-reproducible host reference) or
    #: "device" (JAX/Pallas event loop; distributional parity —
    #: DESIGN.md §6). Selection-layer field: sweep cells may mix them
    #: (mixed groups fall back to per-lane contention).
    contention_backend: str = "numpy"
    # wireless channel layer (DESIGN.md §7) — None disables the whole
    # subsystem (no channel rng streams exist; bit-identical to the
    # pre-channel reference, winner-pin guarded)
    channel: Optional[ChannelSpec] = None
    #: Eq. 1 implementation: "fedavg" (digital, the reference) or
    #: "aircomp" (analog over-the-air superposition; the channel spec
    #: supplies power control + receiver noise). Sweep-shared: the E
    #: lanes run through ONE jitted merge program.
    merge_backend: str = "fedavg"
    #: wall-clock seconds per contention slot for the history's
    #: elapsed-time accounting; None = the CSMA config's slot time.
    slot_duration_s: Optional[float] = None
    # fault-tolerance layer (DESIGN.md §8) — None disables the whole
    # subsystem (no fault rng streams exist; bit-identical to the
    # pre-fault reference, winner-pin guarded). Sweep-shared: the E
    # lanes route through ONE jitted (plain or robust) merge program.
    faults: Optional[FaultSpec] = None
    #: HostBackend round path (DESIGN.md §3/§9); None lets the engine
    #: factory auto-select — "sparse" (contention-first gather-K rounds)
    #: when K ≪ U over a rectangular cohort, else "fused". Sweep-shared:
    #: the path picks the ONE device program every lane runs through.
    round_mode: Optional[str] = None
    #: Eq. 2 ordering for the sparse path ("prepass" = exact /
    #: bit-identical to fused; "stale" = cached, O(K) per round).
    #: Ignored outside round_mode="sparse".
    sparse_priority: str = "prepass"
    # objectives subsystem (DESIGN.md §10) — None (or a plain spec)
    # keeps the untouched pre-registry FedAvg programs. Deliberately
    # NOT sweep-shared: the objective is a sweep AXIS, so one run_sweep
    # compares selection strategies across optimizers; lanes with
    # different objectives share one superset program, inert lanes
    # passing through bitwise.
    objective: Optional[ObjectiveSpec] = None
    # local training (consumed by backend factories)
    lr: float = 1e-2
    batch_size: int = 32
    local_epochs: int = 1
    seed: int = 0

    def __post_init__(self):
        if (self.round_mode is not None
                and self.round_mode not in ROUND_MODES):
            raise ValueError(
                f"unknown round_mode {self.round_mode!r}; "
                f"known: {ROUND_MODES} (or None = auto)")
        if self.sparse_priority not in SPARSE_PRIORITY_MODES:
            raise ValueError(
                f"unknown sparse_priority {self.sparse_priority!r}; "
                f"known: {SPARSE_PRIORITY_MODES}")
        if self.merge_backend not in MERGE_BACKENDS:
            raise ValueError(
                f"unknown merge_backend {self.merge_backend!r}; "
                f"known: {MERGE_BACKENDS}")
        if (self.faults is not None and self.faults.merge_guarded
                and self.merge_backend == "aircomp"):
            raise ValueError(
                "the robust merge guard (quarantine / clip_norm / "
                "corrupt_prob / straggle_prob) is digital-only: the "
                "analog AirComp superposition cannot inspect or mask "
                "individual updates mid-air; use merge_backend='fedavg' "
                "or restrict faults to crash/outage/retry modes")
        if self.objective is not None and not self.objective.is_plain:
            if self.merge_backend == "aircomp":
                raise ValueError(
                    "server aggregators / FedDyn h-state are digital-only: "
                    "the analog AirComp superposition delivers a noisy "
                    "average the server-opt step cannot be folded into; "
                    "use merge_backend='fedavg' with a non-plain objective")
            if self.faults is not None and self.faults.merge_guarded:
                raise ValueError(
                    "the robust merge guard and non-plain objectives are "
                    "mutually exclusive for now (the guarded stale-merge "
                    "path bypasses the server-opt/h update); restrict "
                    "faults to crash/outage/retry modes (quarantine=False, "
                    "clip_norm=0, corrupt_prob=0, straggle_prob=0) or use "
                    "a plain objective")
            if self.round_mode in ("stacked", "ragged"):
                raise ValueError(
                    "non-plain objectives compile into the fused / sparse "
                    "/ sweep device programs only; round_mode="
                    f"{self.round_mode!r} is the uncompiled fallback path")

    def slot_seconds(self) -> float:
        """Wall-clock length of one contention slot."""
        if self.slot_duration_s is not None:
            return float(self.slot_duration_s)
        return self.csma.slot_us * 1e-6


#: ExperimentSpec fields that must agree across the cells of one sweep —
#: ``rounds`` because the lanes advance in lockstep, the rest because
#: they configure the ONE backend / merge program every lane shares.
#: ``objective`` is deliberately absent: lanes may mix objectives (it
#: is a sweep axis); the backend compiles one superset program from the
#: union of their structural flags (DESIGN.md §10).
SWEEP_SHARED_FIELDS = ("rounds", "lr", "batch_size", "local_epochs",
                       "merge_backend", "faults", "round_mode",
                       "sparse_priority")

#: The complementary classification: fields each sweep cell may set
#: independently (selection-layer knobs, per-cell randomness, opt-in
#: subsystems handled per lane). Every ExperimentSpec field MUST
#: appear in exactly one of SWEEP_SHARED_FIELDS / PER_LANE_FIELDS —
#: reprolint RL302 machine-enforces the partition, so a new knob
#: cannot land without a decision on how the sweep path treats it
#: (and, via the repr-based run_fingerprint, without being covered by
#: resume validation — RL303/RL304).
PER_LANE_FIELDS = ("k_per_round", "eval_every", "strategy",
                   "strategy_options", "cw_base", "use_counter",
                   "counter_threshold", "csma", "contention_backend",
                   "channel", "slot_duration_s", "objective", "seed")


@dataclass(frozen=True)
class SweepSpec:
    """E experiment cells destined for one ``FLEngine.run_sweep`` call.

    ``overlap`` toggles the async host/device pipeline (bit-identical
    results either way — it only reorders host work relative to device
    dispatch; tests/test_sweep.py pins the parity). ``labels`` names the
    cells for reporting; ``grid`` fills them automatically.
    """
    specs: List[ExperimentSpec]
    overlap: bool = True
    labels: Optional[List[str]] = None

    def __post_init__(self):
        if not self.specs:
            raise ValueError("SweepSpec needs at least one cell")
        lead = self.specs[0]
        for f in SWEEP_SHARED_FIELDS:
            vals = {getattr(s, f) for s in self.specs}
            if len(vals) > 1:
                raise ValueError(
                    f"sweep cells disagree on shared field {f!r}: "
                    f"{sorted(vals, key=repr)} — the lanes run in "
                    f"lockstep over one backend, so "
                    f"{SWEEP_SHARED_FIELDS} must match")
        if self.labels is not None and len(self.labels) != len(self.specs):
            raise ValueError(
                f"{len(self.labels)} labels for {len(self.specs)} cells")
        object.__setattr__(self, "rounds", lead.rounds)

    def __len__(self):
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    @classmethod
    def grid(cls, base: ExperimentSpec, *, overlap: bool = True,
             **axes: Sequence) -> "SweepSpec":
        """Cartesian product of spec-field variations over ``base``.

            SweepSpec.grid(base, strategy=PAPER_STRATEGIES, seed=range(3))

        Axes are swept in keyword order with the LAST axis fastest
        (``itertools.product``), and each cell gets a ``field=value``
        label. Unknown field names raise immediately.
        """
        known = {f.name for f in fields(ExperimentSpec)}
        bad = set(axes) - known
        if bad:
            raise ValueError(f"unknown ExperimentSpec fields: {sorted(bad)}")
        names = list(axes)
        specs, labels = [], []
        for combo in itertools.product(*(list(axes[n]) for n in names)):
            specs.append(replace(base, **dict(zip(names, combo))))
            labels.append(",".join(f"{n}={v}" for n, v
                                   in zip(names, combo)))
        return cls(specs=specs, overlap=overlap, labels=labels)
