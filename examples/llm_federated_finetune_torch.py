"""Federated finetuning of an assigned LLM architecture (reduced config)
with the paper's distributed user selection, on the PyTorch / CUDA port.

8 users hold topic-skewed token streams (the LLM analogue of the paper's
label-skew); each round they finetune locally, compute Eq. 2 priority
over the model's parameters, and contend for the uplink via CSMA.

  PYTHONPATH=src python examples/llm_federated_finetune_torch.py \
      --arch hymba-1.5b --rounds 12                         # GPU
  PYTHONPATH=src python examples/llm_federated_finetune_torch.py \
      --arch mamba2-370m --rounds 4 --device cpu
"""
import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.engine import ExperimentSpec, build_host_engine
from repro_torch.models.model import compute_loss, init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--seqs-per-user", type=int, default=24)
    ap.add_argument("--strategy", default="priority-distributed")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model} V={cfg.vocab_size}) on {device}")

    user_seqs = make_token_stream(
        args.users, args.seq, args.seqs_per_user, cfg.vocab_size,
        noniid=True, seed=args.seed)
    user_data = [{"tokens": s} for s in user_seqs]
    test_tokens = torch.from_numpy(np.concatenate(make_token_stream(
        2, args.seq, 6, cfg.vocab_size, noniid=False,
        seed=args.seed + 9))).to(device)

    loss_fn = functools.partial(compute_loss, cfg=cfg)

    def eval_fn(params):
        with torch.no_grad():   # negated loss: higher = better
            return -float(compute_loss(params, {"tokens": test_tokens}, cfg))

    params = init_params(args.seed, cfg, device=device)
    spec = ExperimentSpec(k_per_round=2, rounds=args.rounds, lr=args.lr,
                          batch_size=8, strategy=args.strategy,
                          seed=args.seed, eval_every=2)
    hist = build_host_engine(spec, params, loss_fn, user_data, eval_fn,
                             device=device).run()
    for r, m in zip(hist.eval_round, hist.accuracy):
        print(f"  round {r:3d}  eval_loss {-m:.4f}")
    print("selections:", hist.selections.tolist())
    if hist.priorities:
        print("round-0 priorities:",
              [round(float(p), 3) for p in hist.priorities[0]])
    return hist


if __name__ == "__main__":
    main()
