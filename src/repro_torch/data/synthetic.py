"""Synthetic stand-ins for the paper's datasets (offline container).

``make_classification_dataset`` produces class-conditional data shaped
exactly like Fashion-MNIST (1x28x28) or CIFAR-10 (3x32x32): each class
has a deterministic smooth template; samples are template + structured
noise. Learnable by the paper's MLP/CNN, hard enough that selection
strategy ordering (paper Figs. 2-5) is observable. If a real
``<name>.npz`` (keys: x_train, y_train, x_test, y_test) exists under
``data/``, it is loaded instead.

``make_token_stream`` generates per-user topic-skewed Zipf token
sequences for the federated LLM-finetune examples (non-IID in topic
space, mirroring the paper's label-skew).

Part of the numpy bit-reproducible reference path — reprolint:
reference-path (no jax imports; reference data sequences feed the
winner-pin guard).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from repro_torch.core.rngs import data_stream_rng

_SPECS = {
    "fashion": dict(shape=(28, 28, 1), classes=10),
    "cifar": dict(shape=(32, 32, 3), classes=10),
}


def _smooth_template(rng, shape):
    """Low-frequency random image in [0,1] (few random 2-D cosines)."""
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, c))
    for ch in range(c):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 3.0, 2)
            py, px = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(0.3, 1.0)
            img[:, :, ch] += amp * np.cos(
                2 * np.pi * fy * yy / h + py) * np.cos(
                2 * np.pi * fx * xx / w + px)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return img


def make_classification_dataset(
        name: str = "fashion", n_train: int = 6000, n_test: int = 1000,
        noise: float = 0.35, class_sep: float = 1.0, seed: int = 0,
        data_dir: str = "data"):
    """Returns ((x_train, y_train), (x_test, y_test)); x in [0,1] NHWC f32.

    class_sep < 1 blends every class template toward a shared background,
    so classes overlap and accuracy plateaus below 100% — used by the
    benchmarks so selection strategies remain distinguishable.
    """
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return ((z["x_train"].astype(np.float32), z["y_train"].astype(np.int32)),
                (z["x_test"].astype(np.float32), z["y_test"].astype(np.int32)))

    spec = _SPECS[name]
    rng = np.random.default_rng(seed)  # reprolint: disable=RL101 # copy of a whitelisted site
    shared = _smooth_template(rng, spec["shape"])
    # Asymmetric class difficulty (mirrors the paper's observation that
    # users holding specific labels — 2, 5, 8, 9 in their Fashion-MNIST
    # runs — carry systematically more unlearned knowledge): the "hard"
    # classes come in CONFUSABLE PAIRS — each pair shares a base template
    # and differs only by a small distinct component, so telling them
    # apart is learnable but needs more training. Users holding them have
    # larger model distance (higher Eq. 2 priority), and selecting those
    # users more often genuinely helps — the paper's bias scenario.
    hard_pairs = [(1, 3), (5, 7), (2, 9)]
    in_pair = {c for p in hard_pairs for c in p}
    templates = [None] * spec["classes"]
    for a, b in hard_pairs:
        base = class_sep * _smooth_template(rng, spec["shape"]) \
            + (1.0 - class_sep) * shared
        for c in (a, b):
            templates[c] = np.clip(
                base + 0.30 * class_sep
                * _smooth_template(rng, spec["shape"]) - 0.15, 0.0, 1.0)
    for c in range(spec["classes"]):
        if c not in in_pair:
            templates[c] = (class_sep * _smooth_template(rng, spec["shape"])
                            + (1.0 - class_sep) * shared)

    def gen(n, rng):
        y = rng.integers(0, spec["classes"], size=n).astype(np.int32)
        x = np.stack([templates[c] for c in y]).astype(np.float32)
        x += noise * rng.standard_normal(x.shape).astype(np.float32)
        # per-sample global distortions make classes overlap a bit
        x *= rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        x += rng.uniform(-0.15, 0.15, size=(n, 1, 1, 1)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_tr, y_tr = gen(n_train, rng)
    # test split draws from its own spawn child — the old `seed + 1`
    # stream collided with dataset seed s+1's train stream (the
    # correlated-stream bug class, now reprolint RL102)
    x_te, y_te = gen(n_test, data_stream_rng(seed, 1))
    return (x_tr, y_tr), (x_te, y_te)


def make_token_stream(num_users: int, seq_len: int, seqs_per_user: int,
                      vocab_size: int, num_topics: int = 8,
                      noniid: bool = True, seed: int = 0):
    """Per-user LM data: list of (n, seq_len+1) int32 arrays.

    Each topic is a distinct Zipf distribution over a topic-specific
    vocabulary slice; non-IID gives each user 1-2 dominant topics
    (mirrors the paper's 2-shards-per-user label skew).
    """
    rng = np.random.default_rng(seed)  # reprolint: disable=RL101 # copy of a whitelisted site
    # topic -> permuted vocab preference
    topic_perm = [rng.permutation(vocab_size) for _ in range(num_topics)]
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = 1.0 / ranks ** 1.1
    zipf /= zipf.sum()

    out = []
    for u in range(num_users):
        if noniid:
            topics = rng.choice(num_topics, size=2, replace=False)
        else:
            topics = np.arange(num_topics)
        seqs = np.empty((seqs_per_user, seq_len + 1), np.int32)
        for i in range(seqs_per_user):
            t = rng.choice(topics)
            seqs[i] = topic_perm[t][
                rng.choice(vocab_size, size=seq_len + 1, p=zipf)]
        out.append(seqs)
    return out
