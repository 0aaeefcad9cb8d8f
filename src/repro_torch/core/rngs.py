"""Independent RNG stream derivation for one experiment seed.

One ``ExperimentSpec.seed`` has to drive several *statistically
independent* random streams:

  * the engine rng (Eq. 3 ``R ~ U(0,1)`` backoff draws, the
    random-centralized pre-selection picks);
  * the strategy / CSMA-simulator rng (collision redraws);
  * each client's epoch-permutation stream (batch draws).

The pre-fix code seeded the first two with the SAME value
(``default_rng(spec.seed)`` twice), so the backoff draws and the
collision redraws were the identical stream — every "independent"
random quantity in a round was perfectly correlated.  Clients used the
ad-hoc ``seed + 1000 * uid`` rule, which collides across experiments
whose seeds differ by 1000.

This module fixes both with numpy's ``SeedSequence`` spawn tree: every
consumer derives its stream as a child of ``SeedSequence(seed)`` at a
fixed, documented spawn path, which is the mechanism numpy provides for
provably independent child streams.  The paths are part of the repo's
reproducibility contract (winner-parity pins in tests/test_engine.py /
tests/test_sweep.py are derived under these rules):

    (STREAM_ENGINE,)        engine rng
    (STREAM_STRATEGY,)      strategy / CSMASimulator rng
    (STREAM_CLIENT, uid)    client ``uid``'s batch stream
    (STREAM_CHANNEL, 0)     channel layout (positions / shadowing)
    (STREAM_CHANNEL, 1)     per-upload packet-error outcomes
    (STREAM_CHANNEL, 2)     per-round block-fading draws
    (STREAM_CHANNEL, 3)     AirComp receiver-noise key material
    (STREAM_FAULTS, 0)      client crash outcomes
    (STREAM_FAULTS, 1)      straggler (stale-upload) outcomes
    (STREAM_FAULTS, 2)      update-corruption outcomes
    (STREAM_FAULTS, 3)      channel burst-outage process
    (STREAM_FAULTS, 4)      HARQ retransmission backoff + outcome draws
    (STREAM_DATA, 1)        synthetic dataset test-split stream

The channel streams are spawn children like every other stream,
so enabling a ``ChannelSpec`` consumes NO draw from the engine /
strategy / client streams — that is what makes the channel subsystem
provably opt-in (winners are bit-identical with the channel disabled).
The fault streams extend the same contract to the
fault-injection layer: enabling a ``FaultSpec`` never perturbs the
engine / strategy / client / channel draws.

The objectives subsystem (DESIGN.md §10) has NO stream here by
design: registered local objectives and server aggregators draw
nothing — every piece of optimizer state (server-opt m/v, FedDyn
per-user h) is zero-initialized — so an ``ObjectiveSpec`` can never
move any stream above, which is what makes the inert-objective
winner-pin twins bit-exact.

The data stream lives in the DATASET seed domain, not the
experiment seed domain: ``data/synthetic.py`` keys its generation on a
dataset seed shared across sweep cells. Its test split used to be
``default_rng(seed + 1)`` — the arithmetic-derived form of the
bug class (dataset seeds s and s+1 would share the s test / s+1 train
stream); ``data_stream_rng`` replaces it with a spawn child. The
train-side stream stays ``default_rng(seed)`` on purpose: it is the
raw-entropy root, provably disjoint from every spawn child, and the
winner-pin reference sequences are derived from the data it produces.

This module is part of the numpy bit-reproducible reference path —
reprolint: reference-path (RL501 forbids jax imports here), and the
only module allowed to construct SeedSequence spawn material (RL101).
"""
from __future__ import annotations

import numpy as np

#: spawn-path domains under one experiment seed (order is part of the
#: reproducibility contract — never renumber).
STREAM_ENGINE = 0
STREAM_STRATEGY = 1
STREAM_CLIENT = 2
STREAM_CHANNEL = 3
STREAM_FAULTS = 4
STREAM_DATA = 5


def child_seq(seed, *path: int) -> np.random.SeedSequence:
    """The ``SeedSequence`` child of ``seed`` at spawn path ``path``.

    ``seed`` may be an int or an existing ``SeedSequence`` (whose own
    entropy/spawn_key are extended — deriving from a child composes).
    """
    if isinstance(seed, np.random.SeedSequence):
        return np.random.SeedSequence(  # reprolint: disable=RL101 # copy of a whitelisted site
            entropy=seed.entropy,
            spawn_key=tuple(seed.spawn_key) + tuple(path))
    return np.random.SeedSequence(entropy=int(seed),  # reprolint: disable=RL101 # copy of a whitelisted site
                                  spawn_key=tuple(path))


def engine_rng(seed) -> np.random.Generator:
    """The engine's round rng (Eq. 3 backoff / centralized picks)."""
    return np.random.default_rng(child_seq(seed, STREAM_ENGINE))  # reprolint: disable=RL101 # copy of a whitelisted site


def strategy_seed(seed) -> np.random.SeedSequence:
    """Seed material for the strategy's CSMA simulator — independent of
    the engine stream (``default_rng`` accepts it directly)."""
    return child_seq(seed, STREAM_STRATEGY)


def client_rng(seed, uid: int) -> np.random.Generator:
    """Client ``uid``'s epoch-permutation stream.  Replaces the old
    ``seed + 1000 * uid`` rule (which collided across nearby seeds);
    used identically by ``Client`` and the sweep lanes so batched and
    sequential runs stay draw-for-draw equal."""
    return np.random.default_rng(child_seq(seed, STREAM_CLIENT, int(uid)))  # reprolint: disable=RL101 # copy of a whitelisted site


def channel_layout_rng(layout_seed) -> np.random.Generator:
    """Geometry stream (user positions + static shadowing).  Keyed by
    ``ChannelSpec.layout_seed``, NOT the experiment seed, so sweep cells
    with different experiment seeds share one cell geometry (the figures
    compare selection policies over the same radio environment)."""
    return np.random.default_rng(child_seq(layout_seed, STREAM_CHANNEL, 0))  # reprolint: disable=RL101 # copy of a whitelisted site


def channel_outcome_rng(seed) -> np.random.Generator:
    """Per-upload packet-error outcome stream of one experiment seed."""
    return np.random.default_rng(child_seq(seed, STREAM_CHANNEL, 1))  # reprolint: disable=RL101 # copy of a whitelisted site


def channel_fading_rng(seed) -> np.random.Generator:
    """Per-round block-fading stream of one experiment seed."""
    return np.random.default_rng(child_seq(seed, STREAM_CHANNEL, 2))  # reprolint: disable=RL101 # copy of a whitelisted site


def channel_noise_entropy(seed) -> int:
    """63-bit key material for the AirComp receiver-noise PRNG key
    (masked so ``jax.random.PRNGKey`` accepts it as a plain int)."""
    return entropy_u64(child_seq(seed, STREAM_CHANNEL, 3)) & (2**63 - 1)


def fault_crash_rng(seed) -> np.random.Generator:
    """Client crash/dropout outcome stream of one experiment seed."""
    return np.random.default_rng(child_seq(seed, STREAM_FAULTS, 0))  # reprolint: disable=RL101 # copy of a whitelisted site


def fault_straggle_rng(seed) -> np.random.Generator:
    """Straggler (delayed / stale upload) outcome stream."""
    return np.random.default_rng(child_seq(seed, STREAM_FAULTS, 1))  # reprolint: disable=RL101 # copy of a whitelisted site


def fault_corrupt_rng(seed) -> np.random.Generator:
    """Local-delta corruption (NaN / Inf / scale blow-up) stream."""
    return np.random.default_rng(child_seq(seed, STREAM_FAULTS, 2))  # reprolint: disable=RL101 # copy of a whitelisted site


def fault_outage_rng(seed) -> np.random.Generator:
    """Channel burst-outage process stream (one uniform per round)."""
    return np.random.default_rng(child_seq(seed, STREAM_FAULTS, 3))  # reprolint: disable=RL101 # copy of a whitelisted site


def fault_retry_rng(seed) -> np.random.Generator:
    """HARQ retransmission stream (backoff + outcome draws)."""
    return np.random.default_rng(child_seq(seed, STREAM_FAULTS, 4))  # reprolint: disable=RL101 # copy of a whitelisted site


def data_stream_rng(seed, substream: int) -> np.random.Generator:
    """Dataset-domain stream ``substream`` of one DATASET seed (keyed
    on the dataset seed, not the experiment seed — sweep cells share
    one dataset). Substream 0 is reserved for the train/template
    stream, which currently stays on the raw-entropy root
    ``default_rng(seed)`` for winner-pin stability; substream 1 is the
    test split (replaces the arithmetic-derived ``seed + 1``)."""
    return np.random.default_rng(child_seq(seed, STREAM_DATA,  # reprolint: disable=RL101 # copy of a whitelisted site
                                           int(substream)))


def entropy_u64(seed) -> int:
    """A stable 64-bit integer distilled from ``seed`` (int or
    SeedSequence) — for consumers that need a plain word, e.g. the
    device contention engine's threefry base key."""
    ss = seed if isinstance(seed, np.random.SeedSequence) else \
        np.random.SeedSequence(entropy=int(seed))  # reprolint: disable=RL101 # copy of a whitelisted site
    lo, hi = ss.generate_state(2, np.uint32)
    return int(hi) << 32 | int(lo)
