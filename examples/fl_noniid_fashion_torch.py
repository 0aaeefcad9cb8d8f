"""End-to-end driver on the PyTorch / CUDA port: the paper's full
non-IID comparison — all four selection strategies, the counter
ablation, a few hundred rounds — writing per-round curves to
examples/out/. The data is ``make_classification_dataset``'s (the
synthetic stand-in unless ``data/<name>.npz`` is present).

  PYTHONPATH=src python examples/fl_noniid_fashion_torch.py --rounds 200
  PYTHONPATH=src python examples/fl_noniid_fashion_torch.py --rounds 20 \
      --device cpu
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import (make_classification_dataset,  # noqa: E402
                              partition_noniid_shards)
from repro_torch.engine import (ExperimentSpec,  # noqa: E402
                                PAPER_STRATEGIES, build_host_engine,
                                make_accuracy_eval)
from repro_torch.launch.train import classification_loss  # noqa: E402
from repro_torch.models.paper_models import get_paper_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--dataset", default="fashion",
                    choices=["fashion", "cifar"])
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default cuda; cpu too)")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "out"),
                    help="directory of the JSON curves")
    args = ap.parse_args(argv)

    (xtr, ytr), (xte, yte) = make_classification_dataset(
        args.dataset, n_train=args.n_train, n_test=1000, seed=args.seed)
    init_fn, apply_fn = get_paper_model(args.model, args.dataset)
    if args.model == "mlp":
        xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    users = partition_noniid_shards(xtr, ytr, 10, seed=args.seed)
    user_data = [{"x": x, "y": y} for x, y in users]

    eval_fn = make_accuracy_eval(apply_fn, xte, yte, device=args.device)
    params = init_fn(args.seed, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    runs = [(s, True) for s in PAPER_STRATEGIES]
    runs.append(("priority-centralized", False))  # counter ablation
    for strategy, use_counter in runs:
        tag = strategy + ("" if use_counter else "/no-counter")
        spec = ExperimentSpec(rounds=args.rounds, strategy=strategy,
                              use_counter=use_counter, eval_every=2,
                              seed=args.seed)
        hist = build_host_engine(spec, params, classification_loss(apply_fn),
                                 user_data, eval_fn,
                                 device=args.device).run()
        results[tag] = {
            "round": hist.eval_round, "acc": hist.accuracy,
            "selections": hist.selections.tolist(),
            "best": max(hist.accuracy),
        }
        print(f"{tag:45s} best_acc={max(hist.accuracy):.4f} "
              f"selections={hist.selections.tolist()}")

    path = os.path.join(args.out, f"noniid_{args.dataset}_{args.model}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", path)
    return results


if __name__ == "__main__":
    main()
