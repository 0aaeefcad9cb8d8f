"""Engine-API quickstart on the PyTorch / CUDA port: run the paper's
experiment through FLEngine and plug a brand-new selection strategy
into the registry in ~10 lines.

The custom strategy below ("deficit-topk") needs no engine changes: it
registers under a public name, declares its capability flags, and reads
whatever side information it wants off the SelectionContext.

  PYTHONPATH=src python examples/engine_quickstart_torch.py            # GPU
  PYTHONPATH=src python examples/engine_quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.data import (make_classification_dataset,
                              partition_noniid_shards)
from repro_torch.device import resolve_device
from repro_torch.engine import (ExperimentSpec, SelectionResult, Strategy,
                                build_host_engine, make_accuracy_eval,
                                register_strategy)
from repro_torch.models.paper_models import get_paper_model


@register_strategy("deficit-topk")
class DeficitTopK(Strategy):
    """Pick the K_t users whose priority/upload-share ratio is largest —
    a two-line fairness-aware scorer, registered like any builtin."""
    uses_priority = True

    def select(self, ctx):
        shares = (ctx.counter_values if ctx.counter_values is not None
                  else np.zeros(len(ctx.priorities)))
        scores = ctx.priorities / (1.0 + shares)
        cand = np.where(ctx.participating)[0]
        k = min(ctx.k_target, len(cand))
        order = cand[np.argsort(-scores[cand], kind="stable")]
        return SelectionResult(winners=[int(u) for u in order[:k]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the CPU")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    device = resolve_device(args.device)

    (xtr, ytr), (xte, yte) = make_classification_dataset(
        "fashion", n_train=3000, n_test=600)
    xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    init_fn, apply_fn = get_paper_model("mlp", "fashion")
    users = partition_noniid_shards(xtr, ytr, num_users=10)
    user_data = [{"x": x, "y": y} for x, y in users]

    def loss_fn(params, batch):
        # gather, not one_hot: F.one_hot cannot run under torch.func.vmap
        logp = torch.log_softmax(apply_fn(params, batch["x"]), dim=-1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()

    eval_fn = make_accuracy_eval(apply_fn, xte, yte, device=device)
    params = init_fn(0, device=device)

    for strategy in ("priority-distributed", "hetero-topk",
                     "adaptive-biased", "deficit-topk"):
        spec = ExperimentSpec(rounds=args.rounds, strategy=strategy,
                              eval_every=4)
        hist = build_host_engine(spec, params, loss_fn, user_data,
                                 eval_fn, device=device).run()
        print(f"\n== {strategy} ==")
        for r, a in zip(hist.eval_round, hist.accuracy):
            print(f"  round {r:3d}  acc {a:.3f}")
        print(f"  selections per user: {hist.selections.tolist()}")
        print(f"  collisions {hist.collisions}  "
              f"airtime {hist.contention_slots} slots")


if __name__ == "__main__":
    main()
