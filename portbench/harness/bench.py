"""One run of one cell: inputs from the seed, the program's run, the
metrics, then the reference's check of the captured rounds, and the
result line."""
from __future__ import annotations

import gc
import math
import resource
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from . import cells, traffic
from .program import Run, Timing
from .trace import top
from ..reference import judge
from ..reference.fl import Reference, RoundRecord
from ..reference.ops import Ops
from ..work import peaks


@dataclass
class Reading:
    """What a metric reader sees: the cell, the run's timing, and the
    frozen arithmetic's counts for the cell."""
    cell: cells.Cell
    timing: Timing

    @property
    def params(self) -> int:
        """Parameters of the model: the reference module's shapes."""
        return sum(math.prod(s) for s in
                   self.cell.model.shapes(self.cell.config).values())

    @property
    def param_bytes(self) -> int:
        """Bytes of one parameter in the configuration's ``param_dtype``."""
        return peaks.ITEM_BYTES[self.cell.param_dtype]

    @property
    def peak_flops(self) -> float:
        """The card's peak in the configuration's compute dtype."""
        return peaks.peak_flops(self.cell.dtype,
                                bool(self.cell.config.get("tf32")))

    @property
    def users(self) -> int:
        return self.cell.traffic["users"]

    @property
    def leaves(self) -> int:
        return len(self.cell.model.shapes(self.cell.config))

    @property
    def round_flops(self) -> dict:
        return self.cell.kind.round_flops(self.cell)

    def kernel(self, part: str):
        """(seconds, launches) of the profiled phase's device operations
        whose name holds ``part``; None when there is none."""
        prof = self.timing.profile
        if not prof:
            return None
        hits = [v for k, v in prof["ops"].items() if part in k]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def span_ms(self, name: str):
        """Milliseconds a round of the spans phase spent in ``name``."""
        t = self.timing
        if not t.span_rounds or name not in t.spans:
            return None
        return 1e3 * t.spans[name] / t.span_rounds


def reference_records(cell, inputs, seed: int, device, select_by=None,
                      ops: Optional[Ops] = None, batch_frac: float = 1.0
                      ) -> List[RoundRecord]:
    ref = Reference(cell, inputs, seed, device, ops=ops,
                    batch_frac=batch_frac)
    out = ref.run(cell.workload["checked_rounds"], select_by=select_by)
    del ref
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def check(cell, inputs, seed: int, device, records: List[RoundRecord]):
    """The reference's rounds, selected by ``records``' priorities, and
    the judged numbers: ``(correct, checks, failed)``, ``failed`` the
    checked rounds after which a number is over its limit."""
    limits = cell.workload["limits"]
    ref = reference_records(cell, inputs, seed, device,
                            select_by=[r.prio for r in records])
    values = judge.numbers(records, ref)
    ok, checks = judge.verdict(values, limits)
    failed = 0 if ok else sum(
        not judge.verdict(judge.numbers(records[:r + 1], ref[:r + 1]),
                          limits)[0]
        for r in range(len(records)))
    return ok, checks, failed


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, patch: Optional[Callable] = None) -> dict:
    """The result of one run of ``cell`` (``trace`` picks the metrics;
    ``patch`` as ``Run``'s)."""
    dev = torch.device(device)
    loaded = time.perf_counter() - t0
    inputs = traffic.make_inputs(cell, seed, dev)
    made = time.perf_counter() - t0
    run = Run(cell, inputs, seed, dev, seconds, trace, t0, patch=patch)
    run.timing.stamps.update(loaded=loaded, inputs=made)
    timing = run.go()
    records = run.records
    del run
    gc.collect()
    reading = Reading(cell, timing)
    kind = "per_layer" if trace else "end_to_end"
    readers = cells.metric_readers(cells.metric_names(cell.name, kind))
    metrics = {}
    for m, mod in readers.items():
        v = mod.read(reading)
        if v is not None:
            metrics[m] = {"value": float(v), "unit": mod.UNIT}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    s = time.perf_counter()
    ok, checks, failed = check(cell, inputs, seed, dev, records)
    reference = {"seconds": time.perf_counter() - s,
                 "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                if cuda else None),
                 "host_peak_rss_bytes": 1024 * resource.getrusage(
                     resource.RUSAGE_SELF).ru_maxrss}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": int(timing.peak_bytes)}
    out = {"correct": bool(ok), "attempted": int(timing.rounds_run),
           "failed": int(failed), "metrics": metrics,
           "device": device_info}
    if trace and timing.profile:
        device_info["busy_s"] = timing.profile["busy_s"]
        device_info["window_s"] = timing.profiled_s
        out["breakdown"] = {"device_ops": top(timing.profile["ops"]),
                            "idle_gaps": top(timing.profile["gaps"])}
    out["setup_stamps"] = timing.stamps
    out["reference"] = reference
    out["checks"] = checks
    return out
