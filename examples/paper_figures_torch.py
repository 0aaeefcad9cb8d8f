"""The paper's Fig. 2 / Fig. 3 strategy-comparison curves on the PyTorch
/ CUDA port, with ONE ``run_sweep`` call per figure: the four paper
strategies x seeds, 10 users, the MLP on (synthetic) Fashion-MNIST, IID
for Fig. 2 and non-IID shards for Fig. 3. Every cell of a figure trains
in the same (E, U, ...) stack, so a round's training is one pass for all
of them. Trajectories print as small text curves.

  PYTHONPATH=src python examples/paper_figures_torch.py                # GPU
  PYTHONPATH=src python examples/paper_figures_torch.py --device cpu
  ROUNDS=150 SEEDS=3 PYTHONPATH=src python examples/paper_figures_torch.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data import (make_classification_dataset, partition_iid,
                              partition_noniid_shards)
from repro_torch.device import resolve_device
from repro_torch.engine import (ExperimentSpec, PAPER_STRATEGIES, SweepSpec,
                                build_host_engine, make_accuracy_eval)
from repro_torch.launch.train import classification_loss
from repro_torch.models.paper_models import get_paper_model

ROUNDS = int(os.environ.get("ROUNDS", "60"))
SEEDS = int(os.environ.get("SEEDS", "2"))


def build_engine(iid: bool, spec: ExperimentSpec, device):
    (xtr, ytr), (xte, yte) = make_classification_dataset(
        "fashion", n_train=3000, n_test=600, noise=0.5, class_sep=0.6)
    xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    init_fn, apply_fn = get_paper_model("mlp", "fashion")
    part = partition_iid if iid else partition_noniid_shards
    users = part(xtr, ytr, 10, seed=0)
    user_data = [{"x": x, "y": y} for x, y in users]
    eval_fn = make_accuracy_eval(apply_fn, xte, yte, device=device)
    params = init_fn(0, device=device)
    return build_host_engine(spec, params, classification_loss(apply_fn),
                             user_data, eval_fn, device=device)


def text_curve(accs, width=40):
    """Accuracy trajectory as a one-line sparkline."""
    blocks = " .:-=+*#%@"
    lo, hi = min(accs), max(accs)
    span = max(hi - lo, 1e-9)
    idx = np.linspace(0, len(accs) - 1, width).astype(int)
    return "".join(blocks[int((accs[i] - lo) / span * (len(blocks) - 1))]
                   for i in idx)


def figure(name: str, iid: bool, device):
    base = ExperimentSpec(rounds=ROUNDS, eval_every=2)
    sweep = SweepSpec.grid(base, strategy=list(PAPER_STRATEGIES),
                           seed=list(range(SEEDS)))
    engine = build_engine(iid, base, device)
    result = engine.run_sweep(sweep)        # the whole figure, one call

    print(f"\n== {name} ({'IID' if iid else 'non-IID'}; {len(sweep)} "
          f"cells, one run_sweep, {result.wall_s:.1f}s on {device}) ==")
    for i, strat in enumerate(PAPER_STRATEGIES):
        hists = result.histories[i * SEEDS:(i + 1) * SEEDS]
        curves = np.array([h.accuracy for h in hists])
        mean = curves.mean(axis=0)
        print(f"  {strat:22s} |{text_curve(mean)}| "
              f"final {mean[-1]:.3f}  best {curves.max(axis=1).mean():.3f}"
              f"  auc {mean.mean():.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    device = resolve_device(ap.parse_args(argv).device)
    figure("Fig. 2", iid=True, device=device)
    figure("Fig. 3", iid=False, device=device)


if __name__ == "__main__":
    main()
