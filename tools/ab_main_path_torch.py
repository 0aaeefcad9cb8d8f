"""Time the paper MLP cell's rounds on the card for source trees in turns.

    python3 tools/ab_main_path_torch.py TREE_A TREE_B [--turns 2]

Each TREE is the root of a checkout of this repository (``chip_smoke.py``
and ``src/``). The trees run in turns, A B B A (``--turns`` such pairs),
each in a fresh process that builds its own kernels and imports nothing of
the other tree. A run times three cells of ``chip_smoke.py``: the MLP
cell (10 users, k = 2, 20 rounds) through ``FLEngine.run`` and through the
per-round loop, and the 1000-user cell (k = 64, device contention, 8
rounds) through ``run``. Each run prints one JSON line per cell: the
tree, the cell, the per-round seconds after the first round and their
median, the launches and the final global's checksum (so the trees can be
seen to compute the same thing). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CELLS = ("mlp_run", "mlp_run_round", "mlp_U1000_device_run")


def child(tree):
    """One tree's run: every cell once, a JSON line each."""
    sys.path.insert(0, tree)
    sys.argv = [sys.argv[0]]
    import chip_smoke as cs
    from repro_torch.tree import tree_leaves
    cs.kbuild.build_all()
    makes = {
        "mlp_run": (lambda: cs.paper_engine("mlp", 20), lambda e: e.run()),
        "mlp_run_round": (lambda: cs.paper_engine("mlp", 20), cs.round_loop),
        "mlp_U1000_device_run": (
            lambda: cs.paper_engine("mlp", 8, *cs.U1000, "--round-mode",
                                    "fused"),
            lambda e: e.run()),
    }
    for cell in CELLS:
        make, call = makes[cell]
        engine = make()
        _, _, launches, round_s, _ = cs.timed(engine, call)
        checksum = sum(float(x.double().sum())
                       for x in tree_leaves(engine.global_params))
        print(json.dumps({
            "tree": tree, "cell": cell,
            "median_round_ms": 1e3 * statistics.median(round_s[1:]),
            "round_ms": [1e3 * s for s in round_s[1:]],
            "launches": launches, "global_sum": checksum}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child))
        return
    if len(args.trees) != 2:
        ap.error("give two trees")
    a, b = (os.path.abspath(t) for t in args.trees)
    order = [a, b, b, a] * args.turns
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for tree in order[:2 * args.turns]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            sys.exit(f"{tree}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    for cell in CELLS:
        med = {t: statistics.median(r["median_round_ms"] for r in rows
                                    if r["tree"] == t and r["cell"] == cell)
               for t in (a, b)}
        sums = {r["global_sum"] for r in rows if r["cell"] == cell}
        print(json.dumps({"cell": cell, "median_round_ms": med,
                          "b_over_a": med[b] / med[a],
                          "same_global": len(sums) == 1}), flush=True)


if __name__ == "__main__":
    main()
