"""Small CPU versions of the benchmark's cells for the tests: the cells'
own files with fewer users and examples (and, for the CNN, fewer
channels), so a run takes seconds on the CPU; ``mlp_cell``, the paper's
MLP under device CSMA, the configuration and contention engine that no
cell runs yet; and ``lm_cell``, a cell of kind ``lm`` (yi-9b at the size
of the program's ``reduced()`` smoke variant) loaded from the files under
``tests/lm/`` as a cell of the benchmark is. Importing it puts the
checkout's root and ``src`` on the path, so every test file imports it
first."""
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import bench, cells  # noqa: E402


def cell(name, users=6, k=2, examples=64, channels=(8, 16)):
    c = cells.load_cell(name)
    c.workload["traffic"].update(users=users, examples_per_user=examples,
                                 test_examples=100)
    c.workload["spec"]["k_per_round"] = k
    if c.config.get("model") == "cnn":
        c.config["conv_channels"] = list(channels)
    return c


def mlp_cell(users=6, k=2, examples=64):
    """``cnn-paper-u10``'s round with the paper's MLP and the device
    contention engine (on the CPU, the loop the card runs)."""
    c = cell("cnn-paper-u10", users=users, k=k, examples=examples)
    c.config = json.loads(
        (cells.BENCH / "configs" / "paper-mlp.json").read_text())
    c.model = cells.load_module(cells.BENCH / "configs"
                                / c.config["reference"])
    c.workload["config"] = c.config["name"]
    c.workload["spec"]["contention_backend"] = "device"
    return c


def lm_cell():
    """The ``lm-tiny`` cell: 4 users x 8 sequences of 33 tokens, k = 2."""
    return cells.load_cell("lm-tiny", root=Path(__file__).parent / "lm")


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread for the block: the tests run beside other
    test processes, and small ops on many threads each thrash."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run(c, seed=2 ** 31 + 7, trace=False, patch=None, seconds=0.5):
    with one_thread():
        return bench.run_cell(c, seed, seconds, trace, "cpu",
                              time.perf_counter(), patch=patch)
