"""Quickstart on the PyTorch / CUDA port: the paper's experiment in ~40
lines.

10 users with non-IID (2-classes-each) Fashion-MNIST-like data train an
MLP federated; the users compete for the uplink with CSMA, their
contention windows scaled by Eq. 2 model-distance priority (Eq. 3), with
the fairness counter active. Compare against plain random selection.

  PYTHONPATH=src python examples/quickstart_torch.py                # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import (make_classification_dataset,  # noqa: E402
                              partition_noniid_shards)
from repro_torch.engine import (ExperimentSpec,  # noqa: E402
                                build_host_engine, make_accuracy_eval)
from repro_torch.launch.train import classification_loss  # noqa: E402
from repro_torch.models.paper_models import get_paper_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default cuda; cpu too)")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)

    (xtr, ytr), (xte, yte) = make_classification_dataset(
        "fashion", n_train=3000, n_test=600)
    xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    init_fn, apply_fn = get_paper_model("mlp", "fashion")
    users = partition_noniid_shards(xtr, ytr, num_users=10)
    user_data = [{"x": x, "y": y} for x, y in users]

    eval_fn = make_accuracy_eval(apply_fn, xte, yte, device=args.device)
    params = init_fn(0, device=args.device)

    for strategy in ("random-distributed", "priority-distributed"):
        spec = ExperimentSpec(rounds=args.rounds, strategy=strategy,
                              eval_every=4)
        hist = build_host_engine(spec, params, classification_loss(apply_fn),
                                 user_data, eval_fn,
                                 device=args.device).run()
        print(f"\n== {strategy} ==")
        for r, a in zip(hist.eval_round, hist.accuracy):
            print(f"  round {r:3d}  acc {a:.3f}")
        print(f"  selections per user: {hist.selections.tolist()}")


if __name__ == "__main__":
    main()
