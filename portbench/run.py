"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding ``src/repro_torch``. ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
(the same window, then a profiled phase and a phase of synchronised
spans). Every run checks the rounds it captured against the plain
reference and prints the numbers compared, with their limits, as its
last lines on standard error and under ``checks`` in the result line,
the last line of standard output. Exits non-zero, with no result, without
enough CUDA devices, or if JAX or the JAX package got loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the benchmark's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("portbench: --seed must be a whole number >= 0",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness import bench, cells

    cell = cells.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; no result",
              file=sys.stderr)
        return 3
    stamps = result.pop("setup_stamps")
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in stamps.items()),
          file=sys.stderr)
    print("reference: " + ", ".join(f"{k} {v!r}" for k, v in
                                    result.pop("reference").items()),
          file=sys.stderr)
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
