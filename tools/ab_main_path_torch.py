"""Time cells of the port on the card for two source trees in turns.

    python3 tools/ab_main_path_torch.py TREE_A TREE_B [--turns 2]
        [--cells mlp|token_sum] [--rounds 5]

Each TREE is the root of a checkout of this repository; its ``src/`` is
the port that runs. The harness is this checkout's ``chip_smoke.py`` for
both trees, so only the port differs. The trees run in turns, A B B A
(``--turns`` such pairs), each in a fresh process that builds its own
kernels and imports nothing of the other tree. Needs a CUDA device.

``--cells mlp`` (the default) times the paper MLP cell (10 users, k = 2,
20 rounds) through ``FLEngine.run`` and through the per-round loop, and
the 1000-user cell (k = 64, device contention, 8 rounds) through ``run``:
a JSON line per cell with the per-round seconds after the first round,
their median, the launches and the final global's checksum.

``--cells token_sum`` times ``ops.token_sum`` and ``torch.sum(dim=1)``
from a CUDA graph at every shape of ``TOKEN_SUM_CENSUS``
(``time_token_sums``), then runs each of ``route_cells`` (the six
``--arch`` cells, ``--rounds`` rounds, and ``silo_round_full``'s cell)
on each of ``TOKEN_SUM_ROUTES``: a JSON line per shape and per cell and
route, with the median later round and the training losses.

Then the medians by tree and B over A, and whether the trees (and the
kernel and tree routes) computed the same bits.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_CELLS = ("mlp_run", "mlp_run_round", "mlp_U1000_device_run")


def mlp_rows(cs, rounds):
    from repro_torch.tree import tree_leaves
    makes = {
        "mlp_run": (lambda: cs.paper_engine("mlp", 20), lambda e: e.run()),
        "mlp_run_round": (lambda: cs.paper_engine("mlp", 20), cs.round_loop),
        "mlp_U1000_device_run": (
            lambda: cs.paper_engine("mlp", 8, *cs.U1000, "--round-mode",
                                    "fused"),
            lambda e: e.run()),
    }
    for cell in MLP_CELLS:
        make, call = makes[cell]
        engine = make()
        _, _, launches, round_s, _ = cs.timed(engine, call)
        yield {"cell": cell,
               "median_round_ms": 1e3 * statistics.median(round_s[1:]),
               "round_ms": [1e3 * s for s in round_s[1:]],
               "launches": launches,
               "global_sum": sum(float(x.double().sum())
                                 for x in tree_leaves(engine.global_params))}


def token_sum_rows(cs, rounds):
    import torch
    for r in cs.time_token_sums(sorted(cs.TOKEN_SUM_CENSUS)):
        yield {"shape": r["shape"], "us": 1e3 * r["graph_ms"],
               "torch_sum_us": 1e3 * r["torch_sum_graph_ms"]}
    for tag, run in cs.route_cells(rounds).items():
        for route, fn in cs.TOKEN_SUM_ROUTES.items():
            torch.cuda.empty_cache()
            with cs.token_sum_route(fn):
                hist, round_s = run()
            yield {"cell": tag, "route": route,
                   "median_later_round_s": statistics.median(round_s[1:]),
                   "train_loss": hist.train_loss}


def child(tree, cells, rounds):
    """One tree's run: its port under this checkout's harness, a JSON
    line a row."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch  # noqa: F401  the tree's port, before the harness's
    sys.path.insert(0, HARNESS)
    sys.argv = [sys.argv[0]]
    import chip_smoke as cs
    cs.kbuild.build_all()
    rows = mlp_rows if cells == "mlp" else token_sum_rows
    for row in rows(cs, rounds):
        print(json.dumps({"tree": tree, **row}), flush=True)


def summary(rows, a, b):
    """The medians by tree of every shape and cell, B over A."""
    def med(key, tree, **match):
        return statistics.median(
            r[key] for r in rows if r["tree"] == tree
            and all(r.get(k) == v for k, v in match.items()))
    for shape in dict.fromkeys(tuple(r["shape"]) for r in rows
                               if "shape" in r):
        m = {t: med("us", t, shape=list(shape)) for t in (a, b)}
        lib = {t: med("torch_sum_us", t, shape=list(shape)) for t in (a, b)}
        yield {"shape": list(shape), "us": m, "torch_sum_us": lib,
               "b_over_a": m[b] / m[a], "b_over_torch_sum": m[b] / lib[b]}
    for cell, route in dict.fromkeys((r["cell"], r.get("route"))
                                     for r in rows if "cell" in r):
        match = dict(cell=cell, route=route)
        if route is None:
            m = {t: med("median_round_ms", t, **match) for t in (a, b)}
            same = len({r["global_sum"] for r in rows
                        if r.get("cell") == cell}) == 1
            yield {"cell": cell, "median_round_ms": m,
                   "b_over_a": m[b] / m[a], "same_global": same}
        else:
            m = {t: med("median_later_round_s", t, **match) for t in (a, b)}
            same = len({json.dumps(r["train_loss"]) for r in rows
                        if r.get("cell") == cell
                        and r["route"] in ("kernel", "tree")}) == 1
            yield {"cell": cell, "route": route, "median_later_round_s": m,
                   "b_over_a": m[b] / m[a],
                   "kernel_tree_same_losses": same}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cells", choices=("mlp", "token_sum"), default="mlp")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child), args.cells, args.rounds)
        return
    if len(args.trees) != 2:
        ap.error("give two trees")
    a, b = (os.path.abspath(t) for t in args.trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    rows = []
    for tree in ([a, b, b, a] * args.turns)[:2 * args.turns]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--cells", args.cells, "--rounds", str(args.rounds)],
            capture_output=True, text=True, timeout=1800)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            sys.exit(f"{tree}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    for row in summary(rows, a, b):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
