#!/usr/bin/env python
"""Kill-and-resume bit-identity of the PyTorch port's checkpointed runs.

For each scenario, spawns a child process that runs a checkpointed sweep
or run (``checkpoint_every=1``; the scenarios' children start together),
SIGTERMs it as soon as the first checkpoint hits disk (a genuine
mid-run kill — the child never finishes), then resumes from the
orphaned checkpoint in-process and compares against an uninterrupted run
of the same cells: winner sequences, fault counters and merged globals
must match bit for bit.

Scenarios (those of ``tools/kill_resume_smoke.py``, on the port, and one
of the winner-sparse path):

  faults        fault+channel sweep (crash/straggle/corrupt/outage + HARQ
                retries + robust merge guard);
  objectives    FedDyn + FedAvgM lanes under failure-only faults (crash /
                outage / HARQ, quarantine off) + channel: the resumed run
                must restore the server-opt m / v and per-user h stacks,
                not just the globals;
  stale-sparse  one winner-sparse run (``round_mode="sparse"``) under
                stale priorities + channel (a sparse sweep does not
                checkpoint): the resumed run must restore the
                stale-priority cache (the payload's ``priority_cache``)
                with the client streams, not just the global.

    python tools/kill_resume_smoke_torch.py                  # all, CUDA
    python tools/kill_resume_smoke_torch.py --device cpu --scenario faults

``--device`` is where the port runs (default ``cuda``, which fails without
a GPU). Exit 0 on bit-identity, 1 on divergence.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))

ROUNDS = 8
SCENARIOS = ("faults", "objectives", "stale-sparse")


def _scenario(name: str, device: str):
    """One deterministic checkpointed sweep — child and parent must
    build the identical program."""
    import numpy as np
    import torch
    from repro_torch.channel import ChannelSpec
    from repro_torch.engine import (ExperimentSpec, SweepSpec,
                                    build_host_engine)
    from repro_torch.faults import FaultSpec

    rng = np.random.default_rng(11)
    data = [{"x": rng.normal(size=(32, 8)).astype(np.float32),
             "y": rng.integers(0, 2, size=(32,)).astype(np.int32)}
            for _ in range(8)]

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        return ((logits - batch["y"]) ** 2).mean()

    params = {"w": torch.zeros(8, device=device),
              "b": torch.zeros((), device=device)}
    ch = ChannelSpec(per_model="waterfall")
    if name == "faults":
        faults = FaultSpec(crash_prob=0.2, straggle_prob=0.3,
                           corrupt_prob=0.2, outage_prob=0.2,
                           max_retries=1, clip_norm=2.0)
        sw = SweepSpec(specs=[
            ExperimentSpec(rounds=ROUNDS, k_per_round=3, seed=5,
                           faults=faults, channel=ch),
            ExperimentSpec(rounds=ROUNDS, k_per_round=3, seed=6,
                           strategy="random-distributed", faults=faults,
                           channel=ch),
        ])
    elif name == "objectives":
        from repro_torch.objectives import ObjectiveSpec
        # failure-only modes: the robust merge guard (quarantine / clip /
        # corrupt / straggle) excludes non-plain objectives
        faults = FaultSpec(quarantine=False, crash_prob=0.2,
                           outage_prob=0.2, max_retries=1)
        obj = ObjectiveSpec(local="feddyn", alpha=0.1,
                            aggregator="fedavgm", beta=0.5,
                            server_lr=0.8)
        sw = SweepSpec(specs=[
            ExperimentSpec(rounds=ROUNDS, k_per_round=3, seed=5,
                           local_epochs=2, faults=faults, channel=ch,
                           objective=obj),
            ExperimentSpec(rounds=ROUNDS, k_per_round=3, seed=6,
                           local_epochs=2,
                           strategy="random-distributed", faults=faults,
                           channel=ch, objective=obj),
        ])
    elif name == "stale-sparse":
        sw = SweepSpec(specs=[
            ExperimentSpec(rounds=ROUNDS, k_per_round=2, seed=5,
                           round_mode="sparse", sparse_priority="stale",
                           channel=ch)])
    else:
        raise SystemExit(f"unknown scenario {name!r}; known: {SCENARIOS}")
    engine = build_host_engine(sw.specs[0], params, loss_fn, data,
                               device=device)
    return engine, sw


def _run(engine, sw, **kw):
    """The scenario's cells, ``(history, final global)`` a cell: one
    ``FLEngine.run`` for a sparse cell (a sparse sweep does not
    checkpoint), else one ``run_sweep``."""
    if sw.specs[0].round_mode == "sparse":
        hist = engine.run(**kw)
        return [(hist, engine.global_params)]
    res = engine.run_sweep(sw, **kw)
    return [(h, res.lane_params(e)) for e, h in enumerate(res.histories)]


def _child(name: str, device: str, ckpt_dir: str) -> None:
    engine, sw = _scenario(name, device)
    _run(engine, sw, checkpoint_dir=ckpt_dir, checkpoint_every=1)


def _kill_children(names, device, dirs) -> int:
    """Start one checkpointing child a scenario, all at once (their start-
    up overlaps), and SIGTERM each as soon as its first checkpoint is on
    disk. Returns 0, or 1 when a child never wrote one."""
    from repro_torch.checkpoint import checkpoint_path

    children = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", dirs[name],
         "--scenario", name, "--device", device],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        for name in names}
    try:
        pending = list(names)
        deadline = time.perf_counter() + 300
        while pending:
            for name in list(pending):
                child = children[name]
                if os.path.exists(checkpoint_path(dirs[name])):
                    child.send_signal(signal.SIGTERM)
                    rc = child.wait(timeout=60)
                    print(f"[{name}] killed child mid-run (rc={rc}), "
                          "checkpoint on disk")
                    pending.remove(name)
                elif child.poll() is not None:
                    print(f"FAIL[{name}]: child exited before writing a "
                          f"checkpoint (rc={child.returncode})")
                    return 1
            if pending and time.perf_counter() > deadline:
                print(f"FAIL{pending}: no checkpoint after 300s")
                return 1
            time.sleep(0.05)
        return 0
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()


def _resume_matches(name: str, device: str, ckpt_dir: str) -> int:
    """An uninterrupted run of the scenario against a FRESH engine resumed
    from the orphaned checkpoint: 0 when they agree bit for bit."""
    import torch
    from repro_torch.checkpoint import load_fl_checkpoint
    from repro_torch.tree import tree_leaves

    if name == "stale-sparse" and load_fl_checkpoint(ckpt_dir).get(
            "priority_cache") is None:
        print(f"FAIL[{name}]: the checkpoint holds no priority cache")
        return 1
    engine_ref, sw = _scenario(name, device)
    ref = _run(engine_ref, sw)
    engine_res, sw2 = _scenario(name, device)
    res = _run(engine_res, sw2, checkpoint_dir=ckpt_dir)

    for e, ((ha, ga), (hb, gb)) in enumerate(zip(ref, res)):
        if (ha.winners != hb.winners
                or ha.delivered != hb.delivered
                or ha.round_seconds != hb.round_seconds
                or (ha.retries, ha.dropped_clients,
                    ha.quarantined_updates, ha.stale_merges)
                != (hb.retries, hb.dropped_clients,
                    hb.quarantined_updates, hb.stale_merges)):
            print(f"FAIL[{name}]: lane {e} history diverged after resume")
            return 1
        for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
            if not torch.equal(a, b):
                print(f"FAIL[{name}]: lane {e} resumed globals are not "
                      "bit-equal to the uninterrupted run")
                return 1
    print(f"OK[{name}]: resumed run bit-identical to uninterrupted run "
          f"({len(sw)} lanes x {ROUNDS} rounds, {device})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=SCENARIOS, default=None,
                    help="one scenario (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(args.scenario or "faults", args.device, args.child)
        return 0
    names = (args.scenario,) if args.scenario else SCENARIOS
    with tempfile.TemporaryDirectory() as root:
        dirs = {name: os.path.join(root, name) for name in names}
        rc = _kill_children(names, args.device, dirs)
        for name in names:
            rc = rc or _resume_matches(name, args.device, dirs[name])
    return rc


if __name__ == "__main__":
    sys.exit(main())
