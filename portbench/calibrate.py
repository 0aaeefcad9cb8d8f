"""Readings that set a cell's limits (run on the card, not by the
benchmark's runs):

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... \
        [--control-seeds 3] [--out chiprun_out/calibrate_<name>.json]

For every seed, the program's checked rounds (the run's set-up, no
window) judged against the reference: the sound readings. For the first
``--control-seeds`` seeds also the control, the reference put in the
program's place with its products' operands rounded to the precision
below the configuration's (``reference/ops.py::control``: TF32's 10
mantissa bits for f32 with TF32 off, fp8 e4m3's 3 for bf16), named by
its bits (``control_10bit``), and the planted fault of a local step that
leaves half of each batch out (the mean over the rest), both judged the
same way. Prints one JSON line a reading and a summary: each number's
largest sound reading, and its smallest control and fault readings.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def calibrate(cell, seeds, control_seeds: int, dev, out=print) -> dict:
    """The readings of ``cell`` on ``seeds`` (the first
    ``control_seeds`` also of the control and the fault), each row handed
    to ``out`` as a JSON line; returns ``{"rows", "summary"}``."""
    import numpy as np
    from portbench.harness import bench, traffic
    from portbench.harness.program import Run
    from portbench.reference import judge, ops

    control = f"control_{ops.control_bits(cell.config)}bit"
    rows = []

    def judged(kind, seed, records, inputs):
        ref = bench.reference_records(cell, inputs, seed, dev,
                                      select_by=[r.prio for r in records])
        leaves = {name: (np.abs(p.change - q.change) / q.change).tolist()
                  for name, p, q in (("step1_leaves", records[0], ref[0]),
                                     ("change3_leaves", records[-1],
                                      ref[-1]))}
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
               **judge.numbers(records, ref), **leaves, **by_round}
        rows.append(row)
        out(json.dumps(row))

    for i, seed in enumerate(seeds):
        s = time.perf_counter()
        inputs = traffic.make_inputs(cell, seed, dev)
        run = Run(cell, inputs, seed, dev, 0.0, False, s)
        run.go()
        judged("sound", seed, run.records, inputs)
        del run
        if i < control_seeds:
            judged(control, seed, bench.reference_records(
                cell, inputs, seed, dev, ops=ops.control(cell.config)),
                inputs)
            judged("fault_half_batch", seed, bench.reference_records(
                cell, inputs, seed, dev, batch_frac=0.5), inputs)
        del inputs
        print(f"seed {seed}: {time.perf_counter() - s:.1f} s",
              file=sys.stderr, flush=True)
    summary = {}
    for k in judge.NUMBERS:
        by = {kind: [r[k] for r in rows if r["kind"] == kind]
              for kind in ("sound", control, "fault_half_batch")}
        summary[k] = {"sound_max": max(by["sound"]),
                      "sound_median": float(np.median(by["sound"])),
                      "control_min": min(by[control], default=None),
                      "fault_min": min(by["fault_half_batch"], default=None)}
    return {"control": control, "rows": rows, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness import cells

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    got = calibrate(cell, seeds, args.control_seeds, dev,
                    out=lambda line: print(line, flush=True))
    out = {"workload": args.workload, "seeds": seeds,
           "device": torch.cuda.get_device_name(dev), **got,
           "seconds": time.perf_counter() - T0}
    print(json.dumps({"summary": got["summary"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
