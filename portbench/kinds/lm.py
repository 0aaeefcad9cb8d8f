"""Kind ``lm``: a causal language model of the program's
``repro_torch.models.model``, each user trained on its own token
sequences through the same entry as the paper's classifiers.

The configuration file holds ``arch`` (an id of
``repro_torch.configs``), ``widths`` (every ``ModelConfig`` field the
model's shape depends on, written out in full: the reference reads
every size from there), ``dtype`` and ``param_dtype``, ``reduced``,
``assumed`` and ``reference``. The program's configuration is
``dataclasses.replace(get_config(arch), **widths, dtype=...,
param_dtype=...)``. Families this kind cannot yet count or reference
(SSM, hybrid, encoder-decoder) are refused.

Traffic (``make_data``, the workload's ``traffic`` block): token ids
under Zipf's law of token frequencies, ``p(rank r) ~ r ** -zipf_s`` over
the configuration's vocabulary. Ranks map to ids through a ranking: one
common random ranking, and each user's own random ranking, from which a
share ``own_share`` of the user's tokens is drawn (the rest from the
common one): users that favour different words, the non-IID split.
Each user gets ``seqs_per_user`` sequences of ``seq_len + 1`` tokens
(inputs and next-token labels); ``test_seqs`` held-out sequences come
from the common ranking alone. Made on the device, handed over as host
int32 arrays.

The program: ``functools.partial(compute_loss, cfg=...)``, users
``{"tokens"}``, and an evaluation of ``-compute_loss`` on the test
sequences under ``no_grad``. The reference (``losses_and_grads(stack,
batch, ops, cfg)`` of the configuration's module) holds one user at a
time. The work: the reference module's ``forward_flops_per_token``, three
times a trained token and once an evaluated one.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from portbench.harness.program import Pieces

#: families the lm kind refuses: no reference or count of them yet
REFUSED = ("ssm", "hybrid", "audio")


def check(cfg, model) -> None:
    """Refuse, before anything is built, a configuration this kind
    cannot count or reference."""
    w = cfg["widths"]
    fam = w.get("family")
    if fam in REFUSED or w.get("hybrid") or w.get("is_encdec"):
        raise ValueError(
            f"portbench kind lm: {cfg.get('name')!r} is of family {fam!r} "
            "(SSM, hybrid and encoder-decoder models have no reference or "
            "FLOP count here yet)")
    model.check(cfg)


def program_config(cfg):
    """The program's ``ModelConfig``: the arch's published one with the
    file's widths and dtypes."""
    from repro_torch.configs.registry import get_config
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["widths"].items()}
    return dataclasses.replace(get_config(cfg["arch"]), **widths,
                               dtype=cfg["dtype"],
                               param_dtype=cfg["param_dtype"])


def _draw(gen, cdf, common, own, share, shape):
    """Token ids (int32) of ``shape``: Zipf ranks through ``common``, or
    through ``own`` with probability ``share``."""
    u = torch.rand(shape, generator=gen, device=cdf.device,
                   dtype=torch.float64)
    r = torch.searchsorted(cdf, u, right=True).clamp_(max=len(cdf) - 1)
    ids = common[r]
    if own is not None:
        pick = torch.rand(shape, generator=gen, device=cdf.device) < share
        ids = torch.where(pick, own[r], ids)
    return ids.to(torch.int32)


def make_data(cell, gen, dev):
    """``(users, test)``: ``{"tokens": (U, seqs_per_user, seq_len + 1)}``
    and ``{"tokens": (test_seqs, seq_len + 1)}``, host int32."""
    tr = cell.traffic
    V = cell.config["widths"]["vocab_size"]
    U, n, T = tr["users"], tr["seqs_per_user"], tr["seq_len"] + 1
    ranks = torch.arange(1, V + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -float(tr["zipf_s"]), 0)
    cdf = cdf / cdf[-1]
    common = torch.randperm(V, generator=gen, device=dev)
    tokens = np.empty((U, n, T), np.int32)
    for u in range(U):
        own = torch.randperm(V, generator=gen, device=dev)
        tokens[u] = _draw(gen, cdf, common, own, float(tr["own_share"]),
                          (n, T)).cpu().numpy()
    test = _draw(gen, cdf, common, None, 0.0, (tr["test_seqs"], T))
    return {"tokens": tokens}, {"tokens": test.cpu().numpy()}


def program(cell, inputs, device) -> Pieces:
    from repro_torch.models.model import compute_loss

    pcfg = program_config(cell.config)
    test = {"tokens": torch.from_numpy(inputs.test["tokens"]).to(device)}

    def evaluate(params):
        with torch.no_grad():
            return -float(compute_loss(params, test, pcfg))

    users = [{"tokens": t} for t in inputs.users["tokens"]]
    return Pieces(functools.partial(compute_loss, cfg=pcfg), users,
                   evaluate)


def reference_step(cell, stack, batch, ops):
    """The users' losses (U,) and gradients on ``batch`` (``tokens``
    (U, B, seq_len + 1))."""
    return cell.model.losses_and_grads(stack, batch, ops, cell.config)


def round_flops(cell) -> dict:
    """FLOPs of one round: three forward passes a trained token of every
    user's local steps, one an evaluated test token."""
    tr, sp = cell.traffic, cell.spec
    fwd = cell.model.forward_flops_per_token(cell.config, tr["seq_len"])
    steps = sp["local_epochs"] * (tr["seqs_per_user"] // sp["batch_size"])
    trained = tr["users"] * steps * sp["batch_size"] * tr["seq_len"]
    return {"train": 3 * fwd * trained,
            "eval": fwd * tr["test_seqs"] * tr["seq_len"],
            "local_steps": steps}
