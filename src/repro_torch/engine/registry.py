"""Decorator-based strategy registry (DESIGN.md §2).

Selection strategies self-register under a public name:

    @register_strategy("priority-distributed")
    class PriorityDistributed(Strategy):
        uses_priority = True
        distributed = True
        ...

and the engine resolves them by name — ``run_round`` carries zero
strategy-name branching; behavioural differences live entirely in the
strategy's capability flags (``uses_priority``,
``trains_before_selection``, ``distributed``) and its ``select``.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

_REGISTRY: Dict[str, Type] = {}


def register_strategy(name: str, *, overwrite: bool = False):
    """Class decorator: publish a Strategy under ``name``.

    Re-registering an existing name raises unless ``overwrite=True``
    (explicit opt-in for experiment forks that shadow a builtin).
    """
    if not isinstance(name, str) or not name:
        raise ValueError("strategy name must be a non-empty string")

    def deco(cls):
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"strategy {name!r} already registered "
                f"(by {_REGISTRY[name].__qualname__}); "
                f"pass overwrite=True to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_strategies() -> Tuple[str, ...]:
    """All registered names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_strategy_class(name: str) -> Type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; "
            f"known: {available_strategies()}") from None


def create_strategy(name: str, csma_config=None, seed: int = 0,
                    contention_backend: str = "numpy", **options):
    """Instantiate a registered strategy.

    ``csma_config``/``seed``/``contention_backend`` configure the
    contention simulator of distributed strategies (centralized ones
    ignore them); ``seed`` may be an int or a ``np.random.SeedSequence``
    (the engine spawns one per ``core.rngs``); ``options`` are
    strategy-specific keyword arguments.
    """
    cls = get_strategy_class(name)
    return cls(csma_config=csma_config, seed=seed,
               contention_backend=contention_backend, **options)


def supports_batched_select(cls: Type) -> bool:
    """True when ``cls`` overrides the base ``Strategy.select_batch``
    loop with a vectorized implementation (capability introspection for
    the sweep engine and for reporting)."""
    from repro_torch.engine.strategies import Strategy
    impl = getattr(cls, "select_batch", None)
    base = Strategy.select_batch
    return (impl is not None
            and getattr(impl, "__func__", impl)
            is not getattr(base, "__func__", base))


def select_grouped(strategies, ctxs):
    """Dispatch E lanes' selections, batching per strategy class.

    Lanes are grouped by ``type(strategy)`` (a sweep may mix schemes —
    fig2/fig3 run all four paper strategies in one call) and each group
    goes through its class's ``select_batch`` in one shot; result order
    follows the input lanes. Every lane still consumes ITS OWN rng /
    simulator streams inside the batch, so grouping never changes a
    lane's outcome (the per-lane loop is the semantic reference).
    """
    out = [None] * len(ctxs)
    groups = {}
    for i, s in enumerate(strategies):
        groups.setdefault(type(s), []).append(i)
    for cls, idx in groups.items():
        results = cls.select_batch([strategies[i] for i in idx],
                                   [ctxs[i] for i in idx])
        for i, r in zip(idx, results):
            out[i] = r
    return out
