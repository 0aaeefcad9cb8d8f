"""Finding a cell's files by name.

A cell is ``workloads/<name>.json``; it names its configuration,
``configs/<config>.json``, whose plain reference model is the module its
``reference`` key names (a path from the configuration's directory), and
whose kind, ``config.get("kind", "classification")``, is the module
``kinds/<kind>.py`` (the inputs, the program's pieces, how the reference
takes a batch, the work counts); a metric is ``metrics/<name>.py``.
``BENCHMARK.json`` at the checkout's root says which metrics a cell
reports. Adding a cell, a configuration or a metric adds files; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path) -> ModuleType:
    """A Python file loaded by path (its name may hold ``-`` or ``.``)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload: its file's dict, its configuration's dict, the
    configuration's plain reference model module and its kind's
    module."""
    name: str
    workload: dict
    config: dict
    model: ModuleType
    kind: ModuleType

    @property
    def spec(self) -> dict:
        return self.workload["spec"]

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    @property
    def dtype(self) -> str:
        """The configuration's compute dtype."""
        return self.config.get("dtype", "float32")

    @property
    def param_dtype(self) -> str:
        """The dtype the program holds the parameters in."""
        return self.config.get("param_dtype", self.dtype)


def load_kind(config: dict) -> ModuleType:
    return load_module(BENCH / "kinds"
                       / f"{config.get('kind', 'classification')}.py")


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of the benchmark, or of another directory
    ``root`` that holds ``workloads/`` and ``configs/`` laid out alike."""
    root = BENCH if root is None else Path(root)
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no workload {name!r} ({path})")
    workload = json.loads(path.read_text())
    cfg_dir = root / "configs"
    config = json.loads((cfg_dir / f"{workload['config']}.json").read_text())
    model = load_module(cfg_dir / config["reference"])
    kind = load_kind(config)
    kind.check(config, model)
    return Cell(name, workload, config, model, kind)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_names(cell: str, kind: str) -> List[str]:
    """The ``end_to_end`` or ``per_layer`` metrics ``BENCHMARK.json``
    gives the cell: those whose ``workloads`` key lists it, and those
    without the key (for a per-layer metric: where the cell reports the
    end-to-end metric it ``moves``)."""
    bench = benchmark()
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


def reader_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def metric_readers(names: List[str]) -> Dict[str, ModuleType]:
    return {n: load_module(reader_path(n)) for n in names}
