"""Public engine API of the port: one way to run FL rounds — and round
sweeps.

    from repro_torch.engine import (ExperimentSpec, SweepSpec, FLEngine,
                                    HostBackend, SiloBackend,
                                    build_host_engine, register_strategy,
                                    create_strategy)

    engine = build_host_engine(spec, params, loss_fn, user_data, eval_fn)
    history = engine.run()                       # one experiment
    result = engine.run_sweep(                   # E experiments at once
        SweepSpec.grid(spec, strategy=PAPER_STRATEGIES, seed=range(3)))

Strategies plug in through the decorator registry (see
``repro_torch.engine.strategies`` for the paper's four plus the
literature-derived extensions); backends implement the three-method
contract in ``repro_torch.engine.backends`` (``HostBackend``, the
paper's simulation, and ``SiloBackend``, the cross-silo path), and
``HostBackend`` the sweep contract (``SweepState``,
``SweepTrainResult``). ``__all__`` is the reference's.
"""
from repro_torch.channel import ChannelModel, ChannelSpec, MergeContext
from repro_torch.engine.registry import (available_strategies,
                                         create_strategy,
                                         get_strategy_class,
                                         register_strategy, select_grouped,
                                         supports_batched_select)
from repro_torch.engine.spec import ExperimentSpec, SweepSpec
from repro_torch.engine.types import (FLHistory, SelectionContext,
                                      SelectionResult, SweepResult,
                                      TrainResult)
from repro_torch.engine.strategies import PAPER_STRATEGIES, Strategy
from repro_torch.engine.backends import (Backend, HostBackend, SiloBackend,
                                         SweepState, SweepTrainResult,
                                         label_heterogeneity)
from repro_torch.engine.engine import FLEngine, build_host_engine
from repro_torch.engine.evals import make_accuracy_eval
from repro_torch.objectives import ObjectiveSpec

__all__ = [
    "ChannelModel", "ChannelSpec", "MergeContext",
    "available_strategies", "create_strategy", "get_strategy_class",
    "register_strategy", "select_grouped", "supports_batched_select",
    "ExperimentSpec", "SweepSpec", "ObjectiveSpec", "FLHistory",
    "SelectionContext",
    "SelectionResult", "SweepResult", "TrainResult",
    "PAPER_STRATEGIES", "Strategy", "Backend", "HostBackend",
    "SiloBackend", "SweepState", "SweepTrainResult",
    "label_heterogeneity", "FLEngine", "build_host_engine",
    "make_accuracy_eval",
]
