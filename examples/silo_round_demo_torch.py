"""Cross-silo FL demo on the port: the paper's protocol over silos, on
one device (the GPU unless ``--device cpu``).

4 silos hold topic-skewed token data for a reduced assigned arch. Each
round: every silo takes a local step, computes its Eq.2 priority, the
CSMA contention (host-side) picks K_t=1 winner, and only that silo's
delta crosses between silos (the selection-gated merge).

  PYTHONPATH=src python examples/silo_round_demo_torch.py --rounds 6
  PYTHONPATH=src python examples/silo_round_demo_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.counter import FairnessCounter
from repro_torch.core.csma import CSMASimulator
from repro_torch.core.silo import make_fl_round_step, stack_for_silos
from repro_torch.data import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--cw-base", type=float, default=2048.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    S, B = args.silos, 4
    rng = np.random.default_rng(args.seed)
    params = init_params(args.seed, cfg, device=device)
    stacked = stack_for_silos(params, S)
    fl_round = make_fl_round_step(cfg, lr=3e-2)
    sim = CSMASimulator(seed=args.seed)
    counter = FairnessCounter(S, threshold=0.5)

    data = make_token_stream(S, args.seq, args.rounds * B,
                             cfg.vocab_size, noniid=True, seed=args.seed)

    for t in range(args.rounds):
        batch = {"tokens": torch.from_numpy(np.stack(
            [d[t * B:(t + 1) * B] for d in data])).to(device)}
        # dry pass with zero alphas computes losses+priorities only
        loss, local_stacked, prios = fl_round(
            stacked, batch, torch.zeros((S,), device=device))
        prios_np = prios.double().cpu().numpy()
        windows = args.cw_base / np.maximum(prios_np, 1e-9)
        backoffs = rng.uniform(0, 1, S) * windows * 20e-6
        res = sim.contend(backoffs, windows * 20e-6, k_target=1,
                          participating=counter.participating())
        alphas = np.zeros(S, np.float32)
        for w in res.winners:
            alphas[w] = 1.0 / len(res.winners)
        counter.update(res.winners, max(1, len(res.winners)))
        _, stacked, _ = fl_round(stacked, batch,
                                 torch.from_numpy(alphas).to(device))
        print(f"round {t}: loss {float(loss.mean()):.4f} "
              f"priorities {[round(float(p), 3) for p in prios_np]} "
              f"winner {res.winners} collisions {res.collisions}")
    print("selection counts:", counter.uploads.tolist())


if __name__ == "__main__":
    main()
