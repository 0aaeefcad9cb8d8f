"""Server aggregators + the per-sweep ObjectiveTable.

The aggregator law itself lives in ``kernels/ops.server_opt_combine``
(Pallas kernel + ``ref.py`` oracle) operating on the pseudo-gradient
``d = old_global - eq1_average``:

* ``fedavg``  (kind 0): identity — out is bitwise the Eq. 1 average.
* ``fedavgm`` (kind 1): ``m' = beta*m + d; out = old - server_lr*m'`` —
  exactly ``optim.sgd.sgd_momentum_update``'s law (pinned by
  tests/test_optim.py).  ``beta=0, server_lr=1`` takes an explicit
  inert branch so the output is bitwise the average.
* ``fedadam`` (kind 2): ``m' = beta*m + (1-beta)*d;
  v' = beta2*v + (1-beta2)*d²; out = old - server_lr*m'/(sqrt(v')+eps)``
  (Reddi et al. 2021, no bias correction; eps damps the cold start).

``ObjectiveTable`` is the sweep-side compilation plan: per-lane
coefficient vectors plus the UNION of structural flags, so lanes with
different objectives share ONE jitted program (inert lanes pass through
bitwise via the runtime guards).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.objectives.spec import (ObjectiveSpec, ServerAggregator,
                                   register_server)

register_server(ServerAggregator("fedavg", kind=0, uses_state=False))
register_server(ServerAggregator("fedavgm", kind=1, uses_state=True))
register_server(ServerAggregator("fedadam", kind=2, uses_state=True))

_PLAIN = None  # lazily-built ObjectiveSpec() default


def _plain() -> ObjectiveSpec:
    global _PLAIN
    if _PLAIN is None:
        _PLAIN = ObjectiveSpec()
    return _PLAIN


@dataclasses.dataclass
class ObjectiveTable:
    """Per-lane objective plan for one sweep (E lanes).

    ``use_h``/``use_srv`` are the union over lanes — they pick the
    compiled program variant; the per-lane vectors make individual
    lanes active or bitwise-inert inside it.  m AND v are both carried
    whenever any lane needs server state (v is dead weight for pure
    fedavgm sweeps; keeping one program shape beats a third variant).
    """

    specs: Tuple[ObjectiveSpec, ...]
    use_local: bool        # any lane with a non-fedavg local objective
    use_h: bool            # any feddyn lane (per-user h-state rides along)
    use_srv: bool          # any lane with server m/v state
    prox: np.ndarray       # (E,)  f32 proximal coefficients
    alpha: np.ndarray      # (E,)  f32 merge-time h-update coefficients
    consts: np.ndarray     # (E,5) f32 [kind, beta1, beta2, server_lr, eps]

    @property
    def okey(self) -> Tuple[bool, bool]:
        """Program-cache key: the structural (use_h, use_srv) flags."""
        return (self.use_h, self.use_srv)


def build_objective_table(
        objectives: Sequence[Optional[ObjectiveSpec]],
) -> Optional[ObjectiveTable]:
    """None (all lanes plain → untouched pre-registry programs) or the
    superset table for this sweep."""
    specs = tuple(o if o is not None else _plain() for o in objectives)
    if all(s.is_plain for s in specs):
        return None
    return ObjectiveTable(
        specs=specs,
        use_local=any(s.uses_local for s in specs),
        use_h=any(s.uses_h for s in specs),
        use_srv=any(s.uses_server for s in specs),
        prox=np.asarray([s.prox_coeff for s in specs], dtype=np.float32),
        alpha=np.asarray([s.alpha_coeff for s in specs], dtype=np.float32),
        consts=np.stack([s.server_consts() for s in specs]),
    )
