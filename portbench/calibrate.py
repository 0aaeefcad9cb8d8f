"""Readings that set a cell's limits (run on the card, not by the
benchmark's runs):

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... \
        [--control-seeds 3] [--out chiprun_out/calibrate_<name>.json]

For every seed, the program's checked rounds (the run's set-up, no
window) judged against the reference: the sound readings. For the first
``--control-seeds`` seeds also the control, the reference put in the
program's place with its products in TF32 (the precision below the
configuration's f32 with TF32 off), and the planted fault of a local step
that leaves half of each batch out (the mean over the rest), both judged
the same way. Prints one JSON line a reading and a summary: each number's
largest sound reading, and its smallest control and fault readings.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from portbench.harness import bench, cells, traffic
    from portbench.harness.program import Run
    from portbench.reference import judge
    from portbench.reference.ops import Ops

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def judged(kind, seed, records, inputs):
        ref = bench.reference_records(cell, inputs, seed, dev,
                                      select_by=[r.prio for r in records])
        start = inputs.init_host
        leaves = {
            name: (np.abs(judge._change(p.glob, start)
                          - judge._change(q.glob, start))
                   / judge._change(q.glob, start)).tolist()
            for name, p, q in (("step1_leaves", records[0], ref[0]),
                               ("change3_leaves", records[-1], ref[-1]))}
        by_round = {
            "first_loss_by_round": [judge._rel(p.first_loss, q.first_loss)
                                    for p, q in zip(records, ref)],
            "loss_by_round": [judge._rel(p.loss, q.loss)
                              for p, q in zip(records, ref)],
            "local_by_round": [judge.norm_gap(p.local, q.local)
                               for p, q in zip(records, ref)],
            "prio_by_round": [judge._rel(p.prio, q.prio)
                              for p, q in zip(records, ref)]}
        row = {"kind": kind, "seed": seed,
               **judge.numbers(records, ref, start), **leaves, **by_round}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i, seed in enumerate(seeds):
        s = time.perf_counter()
        inputs = traffic.make_inputs(cell, seed, dev)
        run = Run(cell, inputs, seed, dev, 0.0, False, s)
        run.go()
        judged("sound", seed, run.records, inputs)
        del run
        if i < args.control_seeds:
            judged("control_tf32", seed, bench.reference_records(
                cell, inputs, seed, dev, ops=Ops(tf32=True)), inputs)
            judged("fault_half_batch", seed, bench.reference_records(
                cell, inputs, seed, dev, batch_frac=0.5), inputs)
        print(f"seed {seed}: {time.perf_counter() - s:.1f} s",
              file=sys.stderr, flush=True)
    summary = {}
    for k in judge.NUMBERS:
        by = {kind: [r[k] for r in rows if r["kind"] == kind]
              for kind in ("sound", "control_tf32", "fault_half_batch")}
        summary[k] = {"sound_max": max(by["sound"]),
                      "sound_median": float(np.median(by["sound"])),
                      "control_min": min(by["control_tf32"], default=None),
                      "fault_min": min(by["fault_half_batch"], default=None)}
    out = {"workload": args.workload, "seeds": seeds,
           "device": torch.cuda.get_device_name(dev),
           "rows": rows, "summary": summary,
           "seconds": time.perf_counter() - T0}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
