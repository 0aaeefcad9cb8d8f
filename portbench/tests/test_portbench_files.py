"""``BENCHMARK.json`` and the files it names agree: every cell's workload
and configuration file, every metric's reader with the same unit,
source, direction, layer and ``moves``."""
import json
import re

import pytest


import tiny  # noqa: F401  (the checkout and src on the path)
from portbench.harness import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_and_files():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (cells.BENCH / "configs" / cfg["reference"]).is_file()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        cell = cells.load_cell(w["traffic"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["chips"] == w["chips"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_readers_declare_what_the_benchmark_says(kind):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        mod = cells.load_module(cells.reader_path(m["name"]))
        assert mod.KIND == kind
        assert (mod.UNIT, mod.SOURCE, mod.BETTER) == \
            (m["unit"], m["source"], m["better"])
        if kind == "per_layer":
            assert mod.LAYER == m["layer"] and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = cells.metric_names(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        per = cells.metric_names(w["name"], "per_layer")
        assert per
        # a per-layer metric is reported only beside the metric it moves
        moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
        assert all(moves[p] in e2e for p in per)


def test_limits_cover_every_compared_number():
    from portbench.reference import judge
    for w in BENCH["workloads"]:
        limits = cells.load_cell(w["name"]).workload["limits"]
        assert set(limits) == set(judge.NUMBERS)
        assert limits["winners_mismatch"] == 0
