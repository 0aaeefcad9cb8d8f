"""FL training entry point — runs the paper's experiment end-to-end on the
GPU through the engine API.

Examples:
  # the paper's setup: 10 users, 2/round, MLP on (synthetic) Fashion-MNIST
  PYTHONPATH=src python -m repro_torch.launch.train --model mlp \
      --dataset fashion --strategy priority-distributed --rounds 100

  # the same on the CPU (slow; the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 5

  # 1000 users, 64 winners a round, CSMA contention on the GPU: k * 8 <=
  # users, so the factory picks the winner-sparse round path (priorities
  # from a chunked prepass, then only the winners train)
  PYTHONPATH=src python -m repro_torch.launch.train --users 1000 --k 64 \
      --n-train 60000 --contention-backend device

  # the same cell on the dense fused path
  PYTHONPATH=src python -m repro_torch.launch.train --users 1000 --k 64 \
      --n-train 60000 --round-mode fused --contention-backend device

  # the per-round fallback paths: the stacked cohort, or user by user
  PYTHONPATH=src python -m repro_torch.launch.train --round-mode stacked
  PYTHONPATH=src python -m repro_torch.launch.train --round-mode ragged

  # the same cell over 4 seeds as ONE sweep, the final params saved
  PYTHONPATH=src python -m repro_torch.launch.train --sweep-seeds 4 \
      --ckpt /tmp/final.npz

  # federated finetune of a reduced assigned arch on synthetic tokens
  # (the dense, vlm and moe families; ssm, hybrid and audio raise
  # NotImplementedError)
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --rounds 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-27b \
      --rounds 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch kimi-k2-1t-a32b \
      --rounds 5

  # deepseek-v3 (MLA, MoE, MTP): its Eq. 2 product over 56 leaves starts
  # near 3.4e4 (14 zero-initialised norm scales, each ratio capped at 1),
  # so Eq. 3's N is scaled to keep windows above one slot
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch deepseek-v3-671b --cw-base 2097152 --rounds 5
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import (make_classification_dataset, make_token_stream,
                              partition_iid, partition_noniid_shards)
from repro_torch.device import resolve_device
from repro_torch.engine import (ExperimentSpec, FLEngine, PAPER_STRATEGIES,
                                SweepSpec, available_strategies,
                                build_host_engine, make_accuracy_eval)
from repro_torch.models.model import compute_loss, init_params
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


def build_paper_engine(args, **spec_fields) -> FLEngine:
    """The paper's experiment from parsed arguments. ``args.device``
    ``None`` / ``"cuda"`` needs the GPU; ``"cpu"`` asks for the CPU.
    ``spec_fields`` replace fields of the spec the arguments give (the
    command line has no channel or fault flags; a caller that wants the
    paper's cell with ``channel=`` / ``faults=`` / ``merge_backend=``
    passes them here)."""
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
    spec = dataclasses.replace(_spec_from_args(args), **spec_fields)
    return build_host_engine(spec, params,
                             classification_loss(apply_fn), user_data,
                             eval_fn, round_mode=args.round_mode,
                             device=device)


def build_llm_engine(args, init=None, **spec_fields) -> FLEngine:
    """Federated finetune of ``get_config(args.arch).reduced()`` on the
    synthetic token streams of ``make_token_stream`` (``args.users``
    users, ``args.llm_seqs_per_user`` sequences of ``args.llm_seq + 1``
    tokens each), evaluated as ``-compute_loss`` on held-out tokens
    (seed + 99; "metric up"). ``init``: a nested dict of numpy arrays in
    the reference's layout that replaces the seed's params (a parity
    test hands the reference's). Device and ``spec_fields`` as in
    ``build_paper_engine``."""
    device = resolve_device(getattr(args, "device", None))
    cfg_model = get_config(args.arch).reduced()
    seq = args.llm_seq
    user_seqs = make_token_stream(
        args.users, seq, args.llm_seqs_per_user, cfg_model.vocab_size,
        noniid=not args.iid, seed=args.seed)
    user_data = [{"tokens": s} for s in user_seqs]
    test_tokens = np.concatenate(
        make_token_stream(2, seq, 8, cfg_model.vocab_size,
                          noniid=False, seed=args.seed + 99))
    test = {"tokens": torch.from_numpy(test_tokens).to(device)}

    loss_fn = functools.partial(compute_loss, cfg=cfg_model)

    def eval_fn(params):
        with torch.no_grad():
            return -float(compute_loss(params, test, cfg_model))

    params = (init_params(args.seed, cfg_model, device=device)
              if init is None else params_from_numpy(init, device=device))
    spec = dataclasses.replace(_spec_from_args(args), **spec_fields)
    return build_host_engine(spec, params, loss_fn, user_data, eval_fn,
                             round_mode=args.round_mode, device=device)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--dataset", default="fashion",
                    choices=["fashion", "cifar"])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS,
                    help="federated-finetune a reduced assigned arch "
                         "instead of the paper model (dense, vlm and moe "
                         "families)")
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
                    help="backend round path: 'fused', 'stacked', "
                         "'ragged' or 'sparse' (winner-sparse rounds); "
                         "without it 'sparse' when k * 8 <= users over "
                         "equal user datasets, else 'fused'")
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--llm-seq", type=int, default=128)
    ap.add_argument("--llm-seqs-per-user", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep-seeds", type=int, default=1,
                    help="run this many seed-varied copies of the cell "
                         "as ONE run_sweep")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--out", default=None, help="history JSON path")
    ap.add_argument("--ckpt", default=None, help="final checkpoint path")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    """Runs the cell the arguments name, prints the JSON summary and
    returns ``(engine, summary)``."""
    args = make_parser().parse_args(argv)

    t0 = time.perf_counter()
    engine = (build_llm_engine(args) if args.arch
              else build_paper_engine(args))
    if args.sweep_seeds > 1:
        sweep = SweepSpec.grid(
            engine.spec, seed=range(args.seed,
                                    args.seed + args.sweep_seeds))
        result = engine.run_sweep(sweep, verbose=args.verbose)
        hist = result.histories[0]       # lead cell drives the summary
        final_params = result.lane_params(0)
        extra = {
            "sweep_cells": len(result),
            "sweep_labels": result.labels,
            "sweep_best_metric": [max(h.accuracy) if h.accuracy else None
                                  for h in result],
        }
    else:
        hist = engine.run(verbose=args.verbose)
        final_params = engine.global_params
        extra = {}
    dt = time.perf_counter() - t0

    summary = {
        "strategy": args.strategy,
        "device": str(engine.backend.device),
        "final_metric": hist.accuracy[-1] if hist.accuracy else None,
        "best_metric": max(hist.accuracy) if hist.accuracy else None,
        "selections": hist.selections.tolist(),
        "uploads_total": hist.uploads_total,
        "wall_s": round(dt, 1),
        **extra,
    }
    print(json.dumps(summary, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**summary,
                       "accuracy": hist.accuracy,
                       "eval_round": hist.eval_round,
                       "train_loss": hist.train_loss}, f, indent=1)
    if args.ckpt:
        save_checkpoint(args.ckpt, final_params)
    return engine, summary


if __name__ == "__main__":
    main()
