"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: each checked in a fresh
process, by whole top-level module names (``repro_torch`` begins with
``repro``), and in the sources."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
         f"{str(ROOT)!r}]\n{code}\n"
         "import json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_side_module():
    """A whole (small, CPU) run of each cell, as ``run.py`` makes it, and
    the ``lm`` kind's program built for its test cell."""
    mods = _loaded(
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import tiny\n"
        "import portbench.run, portbench.calibrate\n"
        "from portbench.harness import cells, traffic\n"
        "cells.metric_readers([p.stem for p in "
        "(cells.BENCH / 'metrics').glob('*.py')])\n"
        "for w in sorted((cells.BENCH / 'workloads').glob('*.json')):\n"
        "    assert 'checks' in tiny.run(tiny.cell(w.stem), seconds=0.2)\n"
        "assert 'checks' in tiny.run(tiny.mlp_cell(), seconds=0.2)\n"
        "c = tiny.lm_cell()\n"
        "c.kind.program(c, traffic.make_inputs(c, 1, 'cpu'), 'cpu')")
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & JAX_SIDE, mods & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded(
        "import importlib.util\n"
        "from portbench.reference import csma, fl, judge, lm, ops, rngs\n"
        "from portbench.harness import cells\n"
        "for p in sorted((cells.BENCH / 'configs').glob('*.py')):\n"
        "    cells.load_module(p)")
    assert not mods & (JAX_SIDE | {"repro_torch"}), \
        mods & (JAX_SIDE | {"repro_torch"})


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            names.add(n.module.split(".")[0])
    return names


def test_no_source_names_a_jax_side_module():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & JAX_SIDE
        assert not bad, (path, bad)
    for path in [*(BENCH / "reference").glob("*.py"),
                 *(BENCH / "configs").glob("*.py")]:
        assert "repro_torch" not in _imports(path), path
