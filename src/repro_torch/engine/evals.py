"""Evaluation helpers for engine runs.

The eval callback is part of the engine surface
(``FLEngine(eval_fn=...)``), not of the paper's core selection math.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_accuracy_eval(apply_fn, x_test, y_test, batch: int = 256,
                       device=None):
    """Batched classifier accuracy eval_fn. The test set is moved to
    ``device`` (``None`` = the CUDA device) once; only the correct-count
    crosses back per call."""
    dev = resolve_device(device)
    x_dev = torch.from_numpy(np.ascontiguousarray(x_test)).to(dev)
    y_dev = torch.from_numpy(
        np.ascontiguousarray(np.asarray(y_test, np.int64))).to(dev)

    def eval_fn(params) -> float:
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for i in range(0, len(y_dev), batch):
                logits = apply_fn(params, x_dev[i:i + batch])
                correct += (logits.argmax(-1) == y_dev[i:i + batch]).sum()
        return int(correct) / len(y_dev)

    return eval_fn
