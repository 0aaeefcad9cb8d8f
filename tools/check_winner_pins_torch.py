#!/usr/bin/env python
"""The winner-parity pins of ``tests/winner_pins.json``, on the PyTorch
port.

Runs the scenario of ``tools/check_winner_pins.py`` (8 users, a 16 -> 4
linear model, 4 rounds, numpy contention, the four paper strategies x
seeds 0 and 1 as one sweep) through the port's engine, with the same
twin lanes:

  channel-off             ``ChannelSpec(per_model="off")``;
  faults-off              an inert ``FaultSpec()``;
  sparse                  ``round_mode="sparse"`` (priorities from the
                          prepass, then only the winners train);
  objective-inert         FedProx mu 0 + FedAvgM beta 0 / server_lr 1;
  feddyn-inert            FedDyn alpha 0;
  objective-inert-sparse  FedDyn alpha 0 + FedAvgM beta 0 / server_lr 1
                          over the sparse sweep

(the objective lanes leave ``random-centralized`` out: it trains only
the selected users, which a non-plain objective refuses). Every lane's
winners must equal the pins, and every twin's merged globals must be
bit-equal to its plain lane's (the sparse sweep's, for the last). The
pins are the reference's: this tool has no ``--update``.

    PYTHONPATH=src python tools/check_winner_pins_torch.py --device cpu
    python tools/check_winner_pins_torch.py                 # on CUDA

Exit 0 when every pin and twin holds, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.channel import ChannelSpec               # noqa: E402
from repro_torch.engine import (ExperimentSpec,  # noqa: E402
                                PAPER_STRATEGIES, build_host_engine)
from repro_torch.faults import FaultSpec                  # noqa: E402
from repro_torch.objectives import ObjectiveSpec          # noqa: E402
from repro_torch.tree import tree_leaves                  # noqa: E402

PINS_PATH = os.path.join(REPO, "tests", "winner_pins.json")
ROUNDS = 4
SEEDS = (0, 1)
NUM_USERS = 8
#: the twin lanes of the plain sweep: tag -> spec fields
TWINS = {"channel-off": dict(channel=ChannelSpec(per_model="off")),
         "faults-off": dict(faults=FaultSpec()),
         "sparse": dict(round_mode="sparse")}
#: the inert objective lanes: tag -> (spec, the lanes' round mode)
OBJECTIVE_TWINS = {
    "objective-inert": (ObjectiveSpec(local="fedprox", mu=0.0,
                                      aggregator="fedavgm", beta=0.0,
                                      server_lr=1.0), None),
    "feddyn-inert": (ObjectiveSpec(local="feddyn", alpha=0.0), None),
    "objective-inert-sparse": (ObjectiveSpec(
        local="feddyn", alpha=0.0, aggregator="fedavgm", beta=0.0,
        server_lr=1.0), "sparse")}


def pin_engine(strategy, seed, device, rounds=ROUNDS, **spec):
    """The pin scenario's engine on ``device``: the reference tool's
    users (numpy seed 7), its zero-initialised linear model and its
    mean cross-entropy; ``spec`` adds ``ExperimentSpec`` fields."""
    rng = np.random.default_rng(7)
    user_data = []
    for u in range(NUM_USERS):
        probs = np.ones(4) / 4
        probs[u % 4] += 1.0
        probs /= probs.sum()
        user_data.append({
            "x": rng.normal(size=(64, 16)).astype(np.float32),
            "y": rng.choice(4, 64, p=probs)})

    def loss_fn(params, batch):
        logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], -1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()

    params = {"w": torch.zeros(16, 4, device=device),
              "b": torch.zeros(4, device=device)}
    spec = ExperimentSpec(rounds=rounds, strategy=strategy, seed=seed,
                          **spec)
    return build_host_engine(spec, params, loss_fn, user_data, device=device)


def _sweep(lanes, device, **fields):
    specs = [ExperimentSpec(rounds=ROUNDS, strategy=s, seed=seed, **fields)
             for s, seed in lanes]
    engine = pin_engine(lanes[0][0], lanes[0][1], device, **fields)
    return engine.run_sweep(specs)


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def scenario_winners(device):
    """Every lane's winners, keyed as in the pins, and the twins whose
    merged globals are not bit-equal to their plain lane's."""
    cells = [(s, seed) for s in PAPER_STRATEGIES for seed in SEEDS]
    plain = _sweep(cells, device)
    winners = {f"{s}/seed{seed}": h.winners
               for (s, seed), h in zip(cells, plain.histories)}
    runs, unequal = {None: plain}, []

    def twin(tag, lanes, res, ref):
        for e, (s, seed) in enumerate(lanes):
            key = f"{s}/seed{seed}"
            winners[f"{key}/{tag}"] = res.histories[e].winners
            if not _bit_equal(res.lane_params(e),
                              ref.lane_params(cells.index((s, seed)))):
                unequal.append(f"{key}/{tag}")

    for tag, fields in TWINS.items():
        res = _sweep(cells, device, **fields)
        runs[fields.get("round_mode")] = res
        twin(tag, cells, res, plain)
    lanes = [c for c in cells if c[0] != "random-centralized"]
    for tag, (obj, mode) in OBJECTIVE_TWINS.items():
        twin(tag, lanes, _sweep(lanes, device, objective=obj,
                                round_mode=mode), runs[mode])
    return winners, unequal


def check(device="cuda"):
    """Runs the scenario on ``device`` against the pins. Returns a dict:
    ``ok``, the lanes counted, the keys whose winners differ from the
    pins (or are missing on either side), and the twins whose globals
    differ from their plain lane's."""
    with open(PINS_PATH) as f:
        pinned = json.load(f)
    winners, unequal = scenario_winners(torch.device(device))
    want = pinned["winners"]
    differ = sorted(k for k in set(want) | set(winners)
                    if want.get(k) != winners.get(k))
    return dict(ok=not differ and not unequal, device=str(device),
                lanes=len(winners), pin_hash=pinned.get("pin_hash"),
                winners_differ=differ, twins_not_bit_equal=unequal)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default cuda)")
    res = check(ap.parse_args(argv).device)
    print(json.dumps(res))
    if res["ok"]:
        print(f"OK: {res['lanes']} lanes match the winner pins "
              f"(pin_hash={res['pin_hash']}), every twin bit-equal to its "
              "plain lane")
        return 0
    print("FAIL: the port's pin scenario left the pins")
    return 1


if __name__ == "__main__":
    sys.exit(main())
