"""FL training entry point — runs the paper's experiment end-to-end on the
GPU through the engine API.

Examples:
  # the paper's setup: 10 users, 2/round, MLP on (synthetic) Fashion-MNIST
  PYTHONPATH=src python -m repro_torch.launch.train --model mlp \
      --dataset fashion --strategy priority-distributed --rounds 100

  # the same on the CPU (slow; the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 5

  # CSMA contention on the GPU (the event loop and its three kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --users 1000 --k 64 \
      --n-train 60000 --round-mode fused --contention-backend device

``--arch`` (the LLM finetune), ``--sweep-seeds`` above 1 and ``--ckpt``
belong to parts of the reference that are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.data import (make_classification_dataset, partition_iid,
                              partition_noniid_shards)
from repro_torch.device import resolve_device
from repro_torch.engine import (ExperimentSpec, FLEngine, PAPER_STRATEGIES,
                                available_strategies, build_host_engine,
                                make_accuracy_eval)
from repro_torch.models.paper_models import get_paper_model


def _spec_from_args(args) -> ExperimentSpec:
    return ExperimentSpec(
        k_per_round=args.k, rounds=args.rounds, strategy=args.strategy,
        cw_base=args.cw_base, use_counter=not args.no_counter,
        counter_threshold=args.threshold, lr=args.lr,
        batch_size=args.batch_size, seed=args.seed,
        contention_backend=args.contention_backend)


def classification_loss(apply_fn):
    """Mean cross-entropy of ``apply_fn``'s logits against integer
    labels. Written with ``gather`` — ``F.one_hot`` cannot run under
    ``torch.func.vmap`` (it reads a tensor's value on the host)."""
    def loss_fn(params, batch):
        logp = torch.log_softmax(apply_fn(params, batch["x"]), dim=-1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()
    return loss_fn


def build_paper_engine(args) -> FLEngine:
    """The paper's experiment from parsed arguments. ``args.device``
    ``None`` / ``"cuda"`` needs the GPU; ``"cpu"`` asks for the CPU."""
    device = resolve_device(getattr(args, "device", None))
    (xtr, ytr), (xte, yte) = make_classification_dataset(
        args.dataset, n_train=args.n_train, n_test=args.n_test,
        seed=args.seed)
    init_fn, apply_fn = get_paper_model(args.model, args.dataset)
    if args.model == "mlp":
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)
    part = partition_iid if args.iid else partition_noniid_shards
    users = part(xtr, ytr, args.users, seed=args.seed)
    user_data = [{"x": x, "y": y} for x, y in users]

    eval_fn = make_accuracy_eval(apply_fn, xte, yte, device=device)
    params = init_fn(args.seed, device=device)
    return build_host_engine(_spec_from_args(args), params,
                             classification_loss(apply_fn), user_data,
                             eval_fn, round_mode=args.round_mode,
                             device=device)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--dataset", default="fashion",
                    choices=["fashion", "cifar"])
    ap.add_argument("--arch", default=None,
                    help="(not ported) federated-finetune a reduced LLM "
                         "arch instead of the paper model")
    ap.add_argument("--strategy", default="priority-distributed",
                    choices=available_strategies() or PAPER_STRATEGIES)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--users", type=int, default=10)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--no-counter", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.16)
    ap.add_argument("--cw-base", type=float, default=2048.0)
    ap.add_argument("--contention-backend", default="numpy",
                    choices=["numpy", "device"],
                    help="CSMA engine: numpy reference, or the event "
                         "loop on --device")
    ap.add_argument("--round-mode", default=None,
                    choices=["fused", "stacked", "ragged", "sparse"],
                    help="backend round path; only 'fused' is ported "
                         "(name it explicitly above 15 users at k=2)")
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep-seeds", type=int, default=1,
                    help="(not ported above 1) seed-varied copies of the "
                         "cell as one sweep")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--out", default=None, help="history JSON path")
    ap.add_argument("--ckpt", default=None,
                    help="(not ported) final checkpoint path")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    for flag, bad, what in (
            ("--arch", args.arch is not None, "the LLM stack"),
            ("--sweep-seeds", args.sweep_seeds > 1, "the sweep path"),
            ("--ckpt", args.ckpt is not None, "checkpointing")):
        if bad:
            raise NotImplementedError(
                f"{flag}: {what} is not ported yet")

    t0 = time.perf_counter()
    engine = build_paper_engine(args)
    hist = engine.run(verbose=args.verbose)
    dt = time.perf_counter() - t0

    summary = {
        "strategy": args.strategy,
        "device": str(engine.backend.device),
        "final_metric": hist.accuracy[-1] if hist.accuracy else None,
        "best_metric": max(hist.accuracy) if hist.accuracy else None,
        "selections": hist.selections.tolist(),
        "uploads_total": hist.uploads_total,
        "wall_s": round(dt, 1),
    }
    print(json.dumps(summary, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**summary,
                       "accuracy": hist.accuracy,
                       "eval_round": hist.eval_round,
                       "train_loss": hist.train_loss}, f, indent=1)


if __name__ == "__main__":
    main()
