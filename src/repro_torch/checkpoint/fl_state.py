"""Checkpoint/resume for FL engine runs (fault layer, DESIGN.md §8).

One atomic pickle file per run directory holds EVERYTHING the round
loop consumes: the global params (host numpy), every host rng stream's
bit-generator state (engine / strategy / channel / fault streams, plus
the per-lane per-user client batch streams), fairness-counter state,
per-lane histories, outage + stale-buffer state, and the round index —
so a resumed run replays the remaining rounds bit-identically to the
uninterrupted one (pinned in tests/test_faults.py and CI's
kill-and-resume smoke, tools/kill_resume_smoke.py).

Write protocol: serialize to a ``.tmp`` sibling then ``os.replace`` —
a SIGTERM mid-write leaves the previous checkpoint intact (rename is
atomic on POSIX). The payload carries a spec fingerprint; loading
under a different spec raises instead of silently resuming the wrong
experiment.

Pickle (not the .npz pytree writer in ``checkpoint.py``) because the
payload is dominated by numpy ``bit_generator.state`` dicts and ragged
per-lane structures, not arrays; the globals are small at
simulation scale. The .npz path remains the tool for shipping bare
param pytrees.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

CKPT_NAME = "fl_ckpt.pkl"


def checkpoint_path(directory: str) -> str:
    return os.path.join(directory, CKPT_NAME)


def save_fl_checkpoint(directory: str, payload: Dict[str, Any]) -> str:
    """Atomically persist ``payload`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_fl_checkpoint(directory: str) -> Optional[Dict[str, Any]]:
    """The directory's checkpoint payload, or None when absent."""
    path = checkpoint_path(directory)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def run_fingerprint(specs, num_users: int) -> str:
    """Deterministic identity of a run: the cells' full spec reprs plus
    the cohort size. dataclass reprs cover every field recursively, so
    any config drift (strategy, seeds, channel, faults, ...) changes
    the fingerprint and blocks a silent cross-spec resume."""
    return repr((num_users, [repr(s) for s in specs]))


def generator_state(gen) -> dict:
    """A deep-copied snapshot of a numpy Generator's stream position."""
    import copy
    return copy.deepcopy(gen.bit_generator.state)


def restore_generator(gen, state: dict) -> None:
    gen.bit_generator.state = state
