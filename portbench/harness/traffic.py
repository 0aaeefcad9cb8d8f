"""The one entry to the benchmark's inputs: data, test set and initial
weights, all from ``--seed`` on one ``torch.Generator`` of the device,
drawn in a fixed order: the cell's kind makes the users' data and the
test set (``kinds/<kind>.py::make_data``, from the workload's
``traffic`` block), then the configuration's reference module draws the
initial weights in f32 (``init``). The program gets them cast to the
configuration's ``param_dtype``; the host copy, which the reference and
the records start from, holds those cast values in f32, so both sides
start from equal inputs. The users' data goes to the program as host
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass
class Inputs:
    """What a run hands the program and the reference: the users' data
    (arrays with a leading users axis, by key: ``x`` / ``y`` images and
    labels, or ``tokens``), the test set by key, and the initial global
    (leaf name -> device tensor in the program's ``param_dtype``, and its
    host copy in f32)."""
    users: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    init: Dict[str, torch.Tensor]
    init_host: Dict[str, np.ndarray]

    @property
    def num_users(self) -> int:
        return len(next(iter(self.users.values())))


def make_inputs(cell, seed: int, device) -> Inputs:
    """The cell's inputs for ``seed``: the same seed gives the same
    inputs on the same device."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    users, test = cell.kind.make_data(cell, gen, dev)
    init32 = cell.model.init(cell.config, gen, dev)
    dtype = getattr(torch, cell.param_dtype)
    init, host = {}, {}
    for k in list(init32):
        init[k] = init32.pop(k).to(dtype)
        host[k] = init[k].float().cpu().numpy()
    return Inputs(users=users, test=test, init=init, init_host=host)
