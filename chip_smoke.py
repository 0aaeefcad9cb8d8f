#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one NVIDIA GPU with the CUDA toolkit's ``nvcc``; fails at once
without CUDA (there is no CPU path here). It

  1. names the card (``nvidia-smi`` name and power limit) and the
     toolchain;
  2. builds the seven hand-written ``sm_90a`` kernels (five sources)
     from ``src/repro_torch/kernels/csrc/``;
  3. holds every kernel against its plain PyTorch version on the card —
     f32 and bf16, ragged sizes and every leaf shape the driven paths
     hand it (the paper's MLP with 10 and with 1024 users, the full-width
     CNN with 10), including the masked non-finite row and the
     all-zero-weight merge; the three contention passes bit for bit at
     every (B, M) pool shape the contention loop runs on, with forced
     expiry ties, dead lanes and rows with no live lane — and times
     kernel, plain version and, where one exists, the single PyTorch
     library call;
  4. drives the port's main path through its normal entry points:
     ``launch.train.build_paper_engine`` with the paper's defaults (MLP
     784x200x10, 10 users, 2 winners a round, ``priority-distributed``)
     for 20 rounds, the full-width CNN for 3 rounds, and after each the
     ``core.server`` merges and the backend's own merge on a freshly
     trained stack, held against the plain version; then device CSMA
     contention (``--contention-backend device``): the contention loop
     with the kernels against the loop with the plain event op, the
     dense 1e4-1e6-contender regime of ``benchmarks/contention_bench.py``
     through ``CSMASimulator(backend="device")`` (against numpy at 1e4),
     the paper's MLP cell for 20 rounds and the MLP with 1000 users and
     64 winners a round — with the launch counts set to zero just before
     each path and read just after;
  5. checks the result by the repository's own means: the pinned
     winners of ``tests/winner_pins.json``, the card against the CPU run
     of the same rounds, run-to-run bit-equality on the card, and the
     contention invariants and numpy parity of
     ``tests/test_contention_device.py``.

``--profile`` adds a ``torch.profiler`` pass over a few warm rounds
(device time by kernel, the device's idle share); the default run does
not depend on the profiler.

Every phase prints one JSON line; any failed check raises. The line
before the last two is the per-kernel record, then the card's name and
power limit, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: "
             "torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import server as fl_server          # noqa: E402
from repro_torch.core.csma import CSMAConfig, CSMASimulator  # noqa: E402
from repro_torch.engine import (ExperimentSpec, FLHistory,  # noqa: E402
                                build_host_engine)
from repro_torch.engine.backends import compact_weights   # noqa: E402
from repro_torch.kernels import build as kbuild           # noqa: E402
from repro_torch.kernels import contention as kcont       # noqa: E402
from repro_torch.kernels import ops, ref                  # noqa: E402
from repro_torch.launch import train as launch_train      # noqa: E402
from repro_torch.models.paper_models import get_paper_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map        # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
LR = 1e-2

#: tolerances of the CPU parity tests: f32 rtol 1e-5 / atol 1e-6; bf16
#: one ulp of the output type; the two f32 sums of delta_norm rtol 1e-5
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1e-5, atol=0.02)}

KERNELS = {
    "fused_sgd": dict(source="src/repro_torch/kernels/csrc/fused_sgd.cu",
                      replaces="src/repro/kernels/fused_sgd.py:39"),
    "delta_norm": dict(source="src/repro_torch/kernels/csrc/delta_norm.cu",
                       replaces="src/repro/kernels/delta_norm.py:55"),
    "gather_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                           replaces="src/repro/kernels/gather.py:83"),
    "fedavg_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                           replaces="src/repro/kernels/fedavg.py:50"),
    "contention_min": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:133"),
    "contention_expiry": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:139"),
    "contention_transition": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:147"),
}
CONTENTION = ("contention_min", "contention_expiry", "contention_transition")
BIG = ref.CONTENTION_BIG
SLOT_S = 20e-6


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def randn(seed, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32) \
        .to(DEV).to(dtype)


# ------------------------------------------------------------ comparisons
def compare(name, got, want, dtype, rel_only=False):
    """Kernel result vs plain version; returns (max_abs_err, bit_equal).
    Raises when they disagree beyond the stated tolerance."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: shape/dtype {tuple(g.shape)} "
                             f"{got.dtype} vs {tuple(w.shape)} {want.dtype}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = dict(rtol=1e-5, atol=0.0) if rel_only else TOL[dtype]
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e}, tol {tol})")
    return err, bool(torch.equal(got, want))


def merge_inputs(S, winners, k_pad):
    idx = np.zeros(k_pad, np.int32)
    w = np.zeros(k_pad, np.float32)
    idx[:len(winners)] = winners
    sizes = np.arange(1, len(winners) + 1, dtype=np.float64) * 100.0
    w[:len(winners)] = (sizes / sizes.sum()).astype(np.float32)
    assert max(winners) < S
    return torch.from_numpy(idx).to(DEV), torch.from_numpy(w).to(DEV)


def check_kernels_at(shape, U, dtype, seed):
    """All four kernels against their plain versions for one leaf shape
    and cohort size; returns {kernel: (err, bit_equal)}."""
    out = {}
    stack = randn(seed, (U,) + shape, dtype)
    glob = randn(seed + 1, shape, dtype)
    grad = randn(seed + 2, (U,) + shape, dtype)

    want = ref.fused_sgd_ref(stack, grad, LR)
    got = ops.fused_sgd(stack.clone(), grad, LR)
    out["fused_sgd"] = compare("fused_sgd", got, want, dtype)

    d2w, g2w = ref.delta_norm_stacked_ref(stack, glob)
    d2, g2 = ops.delta_norm_stacked(stack, glob)
    e1, b1 = compare("delta_norm.d2", d2, d2w, torch.float32, rel_only=True)
    e2, b2 = compare("delta_norm.g2", g2, g2w, torch.float32, rel_only=True)
    d2o, g2o = ops.delta_norm(stack[0].contiguous(), glob)
    compare("delta_norm.d2[0]", d2o, d2w[0], torch.float32, rel_only=True)
    # relative error is what the tolerance is stated in for the two sums
    rel = max(float(((d2 - d2w).abs() / d2w.clamp(min=1e-30)).max()),
              float((g2 - g2w).abs() / g2w.clamp(min=1e-30)))
    out["delta_norm"] = (max(e1, e2), b1 and b2, rel)

    winners = [U - 1, 0, U // 2] if U >= 3 else [0]
    idx, w = merge_inputs(U, winners, k_pad=len(winners) + 1)
    want = ref.gather_combine_ref(stack, idx, w, glob)
    got = ops.gather_combine(stack, idx, w, glob)
    out["gather_combine"] = compare("gather_combine", got, want, dtype)

    alphas = torch.zeros(U, dtype=torch.float32, device=DEV)
    alphas[idx[:len(winners)].long()] = w[:len(winners)]
    want = ref.fedavg_combine_ref(stack, alphas)
    got = ops.fedavg_combine(stack, alphas)
    out["fedavg_combine"] = compare("fedavg_combine", got, want, dtype)
    return out


def check_merge_contracts(dtype):
    """The merge's exactness contracts, bitwise, on the card."""
    S, shape = 6, (2, 129, 5)
    stack, glob = randn(40, (S,) + shape, dtype), randn(41, shape, dtype)
    idx, w = merge_inputs(S, [4, 1, 3], k_pad=4)
    clean = ops.gather_combine(stack, idx, w, glob)
    for bad in (float("inf"), float("nan")):
        poisoned = stack.clone()
        poisoned[0] = bad               # the pad slot's row, weight zero
        poisoned[5] = bad               # a row nobody selected
        out = ops.gather_combine(poisoned, idx, w, glob)
        torch.cuda.synchronize()
        if not torch.equal(out, clean):
            raise AssertionError("gather_combine: a zero-weight "
                                 f"{bad} row leaked into the merge")
        alphas = torch.zeros(S, dtype=torch.float32, device=DEV)
        alphas[idx[:3].long()] = w[:3]
        dense = ops.fedavg_combine(poisoned, alphas)
        if not torch.equal(dense, ops.fedavg_combine(stack, alphas)):
            raise AssertionError("fedavg_combine: a zero-weight "
                                 f"{bad} row leaked into the merge")
    keep = ops.gather_combine(stack, idx, torch.zeros_like(w), glob)
    if not torch.equal(keep, glob) or keep.data_ptr() == glob.data_ptr():
        raise AssertionError("gather_combine: all-zero weights must "
                             "return a fresh bit-copy of glob")
    for k_pad in (3, 8, 17):
        i2, w2 = merge_inputs(S, [4, 1, 3], k_pad=k_pad)
        if not torch.equal(ops.gather_combine(stack, i2, w2, glob), clean):
            raise AssertionError("gather_combine: the pad width changed "
                                 "the bits of the merge")
    compact = stack[idx.long()].contiguous()
    pos = torch.arange(4, dtype=torch.int32, device=DEV)
    if not torch.equal(ops.gather_combine(compact, pos, w, glob), clean):
        raise AssertionError("gather_combine: winner ids into (U, ...) "
                             "and positions into (K, ...) disagree")
    a = ops.delta_norm_stacked(stack, glob)
    b = ops.delta_norm_stacked(stack, glob)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("delta_norm: two runs differ bitwise")


# ------------------------------------------------------------ contention
def event_inputs(B, N, seed, kind):
    """One (counters, live, doublings, windows, rand) pool on the card.

    ``"tie"``: small counters, a forced expiry tie in row 0, dead lanes
    and (B > 1) a last row with no live lane; ``"dead"``: no live lane
    at all; ``"loop"``: absolute expiries as the loop holds them (up to
    BIG, BIG where a lane has left), windows up to 1e6 slots so redraws
    reach the clamp."""
    rng = np.random.default_rng(seed)
    dbl = rng.integers(0, 6, (B, N)).astype(np.int32)
    rand = rng.random((B, N)).astype(np.float32)
    if kind == "loop":
        cnt = rng.integers(0, 1 << 20, (B, N)).astype(np.int32)
        cnt[rng.random((B, N)) < 0.2] = BIG
        cnt[:, :min(3, N)] = cnt[:, :1]            # a tie at the row min
        live = cnt < BIG
        win = rng.uniform(1.0, 1e6, (B, N)).astype(np.float32)
    else:
        cnt = rng.integers(0, 50, (B, N)).astype(np.int32)
        live = rng.random((B, N)) > 0.3
        cnt[0, :min(4, N)] = 5
        live[0, :min(4, N)] = True
        if B > 1:
            live[-1] = False
        if kind == "dead":
            live[:] = False
        win = rng.uniform(1.0, 1e4, (B, N)).astype(np.float32)
    return [torch.from_numpy(a).to(DEV) for a in (cnt, live, dbl, win, rand)]


def check_contention_at(B, N, seed):
    """The event op (three kernels) against its plain version at one
    pool shape: every output bit-equal, dtypes equal; raises if not."""
    for kind, mds in (("tie", (5, 7)), ("dead", (5,)), ("loop", (5,))):
        args = event_inputs(B, N, seed, kind)
        for md in mds:
            got = ops.contention_event(*args, md)
            want = ref.contention_event_ref(*args, md)
            torch.cuda.synchronize()
            for name, g, w in zip(("step", "nexp", "winner", "counters",
                                   "doublings", "active"), got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(
                        f"contention {name} at {(B, N)}: {g.dtype} "
                        f"{tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
                if not torch.equal(g, w):
                    err = float((g.double() - w.double()).abs().max())
                    raise AssertionError(
                        f"contention {name} at {(B, N)} ({kind}, max "
                        f"doublings {md}): not bit-equal to the plain "
                        f"version (max abs err {err})")


def dense_inputs(n, lanes, seed):
    """``benchmarks/contention_bench.py::_dense_inputs``: CW = n/2 slots
    (about two expiries a slot), in seconds."""
    rng = np.random.default_rng(seed)
    cw = (n // 2) * SLOT_S
    return rng.uniform(0.0, 1.0, (lanes, n)) * cw, np.full(n, cw)


def check_contention_invariants(name, res, k, part=None):
    """``tests/test_contention_device.py::test_pool_mode_invariants_large_n``
    per row: unique, participating winners, exactly k, increasing
    finish slots."""
    for b in range(res.winners.shape[0]):
        w = res.winners[b][res.winners[b] >= 0]
        if not len(w) == len(set(w.tolist())) == k:
            raise AssertionError(f"{name}: row {b} delivered {w.tolist()}")
        if part is not None and not part[b, w].all():
            raise AssertionError(f"{name}: row {b}: a refrained winner")
        if not (np.diff(res.finish_slots[b][:k]) > 0).all():
            raise AssertionError(f"{name}: row {b}: finish slots not "
                                 "increasing")


def contention_run(sim, backoffs, windows, k):
    """One ``contend_batch`` through the simulator with the launch counts
    and loop stats set to 0 just before and read just after; returns
    (result, seconds, launches, loop stats)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    kcont.reset_loop_stats()
    t0 = time.perf_counter()
    res = sim.contend_batch(backoffs, windows, k_target=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k_: ops.LAUNCHES[k_] for k_ in CONTENTION}
    loop = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
    if any(v != loop["events"] for v in launches.values()) \
            or loop["events"] < 1:
        raise AssertionError(f"contention: launches {launches} are not "
                             f"one per pass per event ({loop})")
    return res, dt, launches, loop


def phase_contention_loop_agree():
    """The loop with the kernels against the loop with the plain event op,
    fed the same counter-based draws: every field bit-equal. Dense 1e4 x
    64, and the retry ladder (identical backoffs drain the pool)."""
    out, shapes = {}, set()
    cases = {"dense_1e4x64": (*(a / SLOT_S for a in dense_inputs(
                 10_000, 64, seed=10_000)), 8),
             "retry_ladder_2x2000": (np.full((2, 2000), 50.0),
                                     np.full(2000, 2.5e6), 3)}
    for label, (bo, win, k) in cases.items():
        kw = dict(entropy=1234, call_index=5, tx_slots=50,
                  max_backoff_doublings=5, max_sim_slots=2_000_000,
                  device=DEV)
        kcont.reset_loop_stats()
        t0 = time.perf_counter()
        got = kcont.device_contend_batch(bo, win, k, None, **kw)
        t1 = time.perf_counter()
        loop = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
        shapes |= kcont.LOOP["shapes"]
        want = kcont.device_contend_batch(
            bo, win, k, None, event_op=ref.contention_event_ref, **kw)
        t2 = time.perf_counter()
        for f in ("winners", "finish_slots", "collisions", "elapsed_slots",
                  "n_delivered"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"contention_loop_agree {label}: {f} "
                                     "differs from the plain loop")
        out[label] = dict(kernel_loop_s=t1 - t0, plain_loop_s=t2 - t1,
                          events=loop["events"], attempts=loop["attempts"],
                          pool_shapes=loop["shapes"],
                          delivered=int(got.n_delivered.sum()),
                          collisions=int(got.collisions.sum()))
    if out["retry_ladder_2x2000"]["attempts"] < 2:
        raise AssertionError("contention_loop_agree: the retry ladder was "
                             "not climbed")
    emit("contention_loop_agree", bit_equal=True, cases=out)
    return shapes


def phase_contention_dense():
    """``benchmarks/contention_bench.py``'s dense grid through
    ``CSMASimulator(backend="device")``: against numpy at 1e4 x 64 (the
    bars of ``tests/test_contention_device.py``'s 1e5 test), invariants
    at 1e5 x 64 and 1e6 x 8."""
    k, out, shapes = 8, {}, set()
    for n, lanes in ((10_000, 64), (100_000, 64), (1_000_000, 8)):
        backoffs, windows = dense_inputs(n, lanes, seed=n)
        sim = CSMASimulator(CSMAConfig(), seed=0, backend="device",
                            device=DEV)
        res, first_s, _, loop = contention_run(sim, backoffs, windows, k)
        shapes.update(map(tuple, loop["shapes"]))
        steady = []
        for _ in range(2):
            res, dt, launches, loop = contention_run(sim, backoffs, windows,
                                                     k)
            steady.append(dt)
            shapes.update(map(tuple, loop["shapes"]))
        check_contention_invariants(f"contention_dense {n}", res, k)
        row = dict(contenders=n, lanes=lanes, first_call_s=first_s,
                   steady_s=min(steady), events=loop["events"],
                   attempts=loop["attempts"],
                   launches=launches,
                   launches_per_event=sum(launches.values())
                   / loop["events"],
                   pool_width=max(m for _, m in loop["shapes"]),
                   rounds_per_s=lanes / min(steady),
                   delivered=int(res.n_delivered.sum()),
                   collisions=int(res.collisions.sum()),
                   mean_elapsed_slots=float(res.elapsed_slots.mean()),
                   numpy_s=None)
        if n == 10_000:
            t0 = time.perf_counter()
            host = CSMASimulator(CSMAConfig(), seed=0).contend_batch(
                backoffs, windows, k_target=k, seeds=list(range(lanes)))
            row["numpy_s"] = time.perf_counter() - t0
            if not np.array_equal(res.n_delivered, host.n_delivered):
                raise AssertionError("contention_dense: deliveries differ "
                                     "from numpy")
            dc, hc = int(res.collisions.sum()), int(host.collisions.sum())
            if abs(dc - hc) > max(20, int(0.5 * hc)):
                raise AssertionError(f"contention_dense: collisions {dc} "
                                     f"vs numpy {hc}")
            a, b = res.elapsed_slots.mean(), host.elapsed_slots.mean()
            if abs(a - b) > 0.5 * max(a, b):
                raise AssertionError(f"contention_dense: mean airtime {a} "
                                     f"vs numpy {b}")
            row.update(numpy_collisions=hc,
                       numpy_mean_elapsed_slots=float(b))
        out[f"{n}x{lanes}"] = row
        del backoffs, windows
    emit("contention_dense", k=k, regime="CW = n/2 slots",
         invariants="unique participating winners, exactly k, increasing "
                    "finish slots", sizes=out)
    return shapes


# ----------------------------------------------------------------- timing
def time_ms(fn, reps, samples=5, warmup=3):
    """Median over ``samples`` of (CUDA-event time of ``reps`` calls) /
    ``reps``, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, reps=20):
    """Device time of one call: ``reps`` calls captured into a CUDA
    graph and replayed, so no launch waits for the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=3) / reps


def rotating(make, n_sets):
    """``n_sets`` independent input sets, visited in turn, so that a call
    does not find its operands in the L2 cache."""
    sets = [make(i) for i in range(n_sets)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n_sets
        return sets[state["i"]]
    return nxt


def measure(kernel, plain, library, nbytes, ops_count, reps, plain_reps):
    """Kernel (eager and from a CUDA graph), plain version and library
    call times, and the bound: the larger of bytes over the HBM rate and
    operations over the f32 rate outside the tensor cores (the integer
    passes are counted at that rate too; bytes bound every kernel here)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / F32_FLOPS_PER_S * 1e3
    return dict(
        ms=time_ms(kernel, reps),
        graph_ms=graph_ms(kernel),
        plain_ms=time_ms(plain, plain_reps, samples=3, warmup=1),
        library_ms=(time_ms(library, reps) if library else None),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes)


def bench_contention(B, N, reps):
    """The three passes at one (B, N) pool shape, on a pool as the loop
    holds it (operands stay in L2, as they do in the loop)."""
    cnt, live, dbl, win, rand = event_inputs(B, N, seed=B * N, kind="loop")
    step = kcont.contention_min_cuda(cnt, live)
    nexp, _ = kcont.contention_expiry_cuda(cnt, live, step)
    big = torch.tensor(BIG, dtype=torch.int32, device=DEV)
    lanes, plain_reps = B * N, max(1, min(reps, 50))
    return {
        # reads counter + live flag a lane, writes (B,) int32
        "contention_min": measure(
            lambda: kcont.contention_min_cuda(cnt, live),
            lambda: ref.contention_min_ref(cnt, live),
            lambda: torch.where(live, cnt, big).amin(1),
            5 * lanes + 4 * B, 2 * lanes, reps, plain_reps),
        # reads counter + live flag a lane and step, writes two (B,) int32
        "contention_expiry": measure(
            lambda: kcont.contention_expiry_cuda(cnt, live, step),
            lambda: ref.contention_expiry_ref(cnt, live, step),
            None, 5 * lanes + 12 * B, 4 * lanes, reps, plain_reps),
        # reads 17 bytes a lane and step / nexp, writes 9 bytes a lane
        "contention_transition": measure(
            lambda: kcont.contention_transition_cuda(
                cnt, live, dbl, win, rand, step, nexp, 5),
            lambda: ref.contention_transition_ref(
                cnt, live, dbl, win, rand, step, nexp, 5),
            None, 26 * lanes + 8 * B, 10 * lanes, reps, plain_reps)}


def bench_kernels(U, shape, dtype, reps):
    """Times at one leaf shape: kernel (eager, cold operands), kernel
    from a CUDA graph, plain version, library call; plus the bound."""
    n = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    set_bytes = 2 * U * n * item
    n_sets = max(2, min(16, int(128e6 // set_bytes) + 1))
    winners = [U - 1, 0]                       # k_per_round = 2
    idx, w = merge_inputs(U, winners, k_pad=2)
    alphas = torch.zeros(U, dtype=torch.float32, device=DEV)
    alphas[idx.long()] = w
    nxt = rotating(lambda i: (randn(100 + i, (U,) + shape, dtype),
                              randn(200 + i, (U,) + shape, dtype),
                              randn(300 + i, shape, dtype)), n_sets)
    res = {}

    def record(name, kernel, plain, library, nbytes, flops, plain_reps):
        res[name] = measure(kernel, plain, library, nbytes, flops, reps,
                            plain_reps)

    def sgd_k():
        p, g, _ = nxt()
        ops.fused_sgd(p, g, LR)

    def sgd_p():
        p, g, _ = nxt()
        ref.fused_sgd_ref(p, g, LR)

    def sgd_l():
        p, g, _ = nxt()
        torch.add(p, g, alpha=-LR)

    record("fused_sgd", sgd_k, sgd_p, sgd_l, 3 * U * n * item, 2 * U * n,
           reps)

    def dn_k():
        s, _, g = nxt()
        ops.delta_norm_stacked(s, g)

    def dn_p():
        s, _, g = nxt()
        ref.delta_norm_stacked_ref(s, g)

    record("delta_norm", dn_k, dn_p, None,
           (U + 1) * n * item + (U + 1) * 4, 5 * U * n + 2 * n, reps)

    def gc_k():
        s, _, g = nxt()
        ops.gather_combine(s, idx, w, g)

    def gc_p():
        s, _, g = nxt()
        ref.gather_combine_ref(s, idx, w, g)

    def gc_l():
        s, _, _ = nxt()
        torch.einsum("k,kn->n", w,
                     torch.index_select(s, 0, idx.long()).reshape(2, n)
                     .float())

    # both weights are nonzero: two rows read, one written, glob unread
    record("gather_combine", gc_k, gc_p, gc_l, (2 + 1) * n * item,
           2 * 2 * n, reps)

    def fa_k():
        s, _, _ = nxt()
        ops.fedavg_combine(s, alphas)

    def fa_p():
        s, _, _ = nxt()
        ref.fedavg_combine_ref(s, alphas)

    def fa_l():
        s, _, _ = nxt()
        torch.matmul(alphas, s.reshape(U, n).float())

    # masked rows are not read: this run's alphas have two nonzero rows
    record("fedavg_combine", fa_k, fa_p, fa_l, (2 + 1) * n * item,
           2 * 2 * n, max(1, min(reps, 2000 // U)))
    return res


# -------------------------------------------------------------- main path
def paper_args(*extra):
    return launch_train.make_parser().parse_args(["--device", "cuda", *extra])


def run_main_path(model, rounds, *extra, split=None):
    """The paper's cell (``extra`` appends command-line flags) through
    ``launch.train.build_paper_engine`` and ``FLEngine.run``; returns
    (history, engine, seconds, launches, per-round seconds, contention
    events). The engine evaluates after every round, so the clock is read
    inside its eval callback, after a synchronize. A ``split`` dict
    collects the seconds spent in training and in selection."""
    engine = launch_train.build_paper_engine(
        paper_args("--model", model, "--rounds", str(rounds), *extra))
    inner, stamps = engine.eval_fn, []
    if split is not None:
        for obj, attr in ((engine.backend, "train_round"),
                          (engine.strategy, "select")):
            split[attr] = 0.0
            setattr(obj, attr, _timed(getattr(obj, attr), split, attr))

    def timed_eval(params):
        acc = inner(params)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return acc

    engine.eval_fn = timed_eval
    torch.cuda.synchronize()
    ops.reset_launches()                      # just before the main path
    kcont.reset_loop_stats()
    t0 = time.perf_counter()
    hist = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)             # just after it
    loop = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
    round_s = np.diff([t0, *stamps]).tolist()
    return hist, engine, dt, launches, round_s, loop


def _timed(fn, split, key):
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out
    return wrapped


def check_main_path(name, hist, engine, launches, rounds, check_accuracy,
                    events=0):
    """``events``: the contention loop's events in the run (0 on the
    numpy backend); each runs the three contention passes once."""
    leaves = len(tree_leaves(engine.global_params))
    steps = engine.backend._nb * engine.spec.local_epochs
    merged = sum(1 for w in hist.winners if w)
    want = {"fused_sgd": leaves * steps * rounds,
            "delta_norm": leaves * rounds,
            "gather_combine": leaves * merged,
            "fedavg_combine": 0,
            **{k: events for k in CONTENTION}}
    if engine.spec.contention_backend == "device" and events < rounds:
        raise AssertionError(f"{name}: {events} contention events in "
                             f"{rounds} rounds")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, the code "
                             f"predicts {want}")
    if min(want["fused_sgd"], want["delta_norm"],
           want["gather_combine"]) < 1:
        raise AssertionError(f"{name}: a kernel of the path never ran")
    if len(hist.winners) != rounds or len(hist.train_loss) != rounds:
        raise AssertionError(f"{name}: history is short")
    for t, winners in enumerate(hist.winners):
        # a round ends with deliveries, or with a recorded reason for none
        if not winners and hist.collisions == 0:
            raise AssertionError(f"{name}: round {t} has no winners and "
                                 "no collision was recorded")
    prios = np.asarray(hist.priorities)
    if not (np.isfinite(hist.train_loss).all() and np.isfinite(prios).all()
            and (prios >= 1.0).all()):
        raise AssertionError(f"{name}: losses / priorities not finite or "
                             "priorities below 1")
    for leaf in tree_leaves(engine.global_params):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"{name}: non-finite global parameter")
    if check_accuracy:
        # the global after the last round beats the one after the first,
        # and the training loss fell
        if not (hist.accuracy[-1] > hist.accuracy[0]
                and hist.train_loss[-1] < 0.7 * hist.train_loss[0]):
            raise AssertionError(
                f"{name}: no learning: accuracy {hist.accuracy}, "
                f"loss {hist.train_loss}")
    return leaves, steps, merged


def phase_main_path(model, rounds, check_accuracy):
    hist, engine, dt, launches, round_s, _ = run_main_path(model, rounds)
    leaves, steps, merged = check_main_path(
        f"main_path_{model}", hist, engine, launches, rounds, check_accuracy)
    steady = statistics.median(round_s[1:])
    emit(f"main_path_{model}", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, launches=launches,
         launches_per_round={"fused_sgd": leaves * steps,
                             "delta_norm": leaves,
                             "gather_combine": leaves},
         merged_rounds=merged, collisions=hist.collisions,
         accuracy_first=hist.accuracy[0], accuracy_best=max(hist.accuracy),
         accuracy_last=hist.accuracy[-1], loss_first=hist.train_loss[0],
         loss_last=hist.train_loss[-1],
         priority_max=float(np.max(hist.priorities)),
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    return engine, launches


def phase_server_path(engine, model):
    """On a freshly trained stack of ``model``: the backend's merge is
    bit-equal to the plain version on the same stack, and the
    ``core.server`` merges agree with it (masked dense merge in index
    order vs gather merge in delivery order)."""
    be = engine.backend
    U = be.num_users
    ids = list(range(U))
    state = engine.state
    tr = be.train_round(state, 0, ids, need_priority=True)
    trained = tr.local_handle["fused_stack"]
    winners = [7, 3, 5]                        # delivery != index order
    sizes = [be.num_examples(u) for u in winners]
    locals_ = [be.extract_local(tr, u) for u in winners]
    ops.reset_launches()                       # just before the path
    masked = fl_server.fedavg_masked(
        trained, fl_server.winner_alphas(U, winners, sizes))
    listed = fl_server.fedavg(locals_, sizes)
    deltas = [tree_map(lambda l, g: l - g, loc, state) for loc in locals_]
    delta = fl_server.fedavg_delta(state, deltas, sizes)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)              # just after it
    # the plain version first: the merge overwrites the trained stack
    idx, w = compact_weights(be._k_pad(len(winners)), winners, sizes)
    idx_d, w_d = torch.from_numpy(idx).to(DEV), torch.from_numpy(w).to(DEV)
    plain = tree_map(lambda l, g: ref.gather_combine_ref(l, idx_d, w_d, g),
                     trained, state)
    gathered = be.merge(state, tr, winners)
    torch.cuda.synchronize()
    leaves = len(tree_leaves(state))
    if launches["fedavg_combine"] != 3 * leaves:
        raise AssertionError(f"server_path_{model}: launches {launches}")
    for p, g in zip(tree_leaves(plain), tree_leaves(gathered)):
        if not (torch.isfinite(g).all() and torch.equal(p, g)):
            raise AssertionError(
                f"server_path_{model}: the backend's merge of a leaf of "
                f"shape {tuple(g.shape)} is not bit-equal to the plain "
                "version on the same trained stack")
    worst = 0.0
    for m, l, d, g in zip(*(tree_leaves(t) for t in
                            (masked, listed, delta, gathered))):
        # same rows and weights, summed in index order (masked) vs
        # delivery order (gathered): f32 rounding only
        if not torch.allclose(m, g, rtol=1e-6, atol=1e-7):
            raise AssertionError("server_path: fedavg_masked disagrees "
                                 "with the gather merge")
        # the listed form stacks the winners in delivery order: bit-equal
        if not torch.equal(l, g):
            raise AssertionError("server_path: fedavg over the winners' "
                                 "models is not bit-equal to the gather "
                                 "merge")
        if not torch.allclose(d, g, rtol=1e-4, atol=1e-6):
            raise AssertionError("server_path: fedavg_delta disagrees")
        worst = max(worst, float((m - g).abs().max()))
    emit(f"server_path_{model}", launches=launches, winners=winners,
         merge_bit_equal_to_plain=True,
         masked_vs_gather_max_abs_err=worst, listed_bit_equal=True)
    return launches


# ------------------------------------------------- correctness of results
def pin_scenario(strategy, seed, device, rounds=4):
    """The scenario of ``tools/check_winner_pins.py``: 8 users, a 16 -> 4
    linear model, 4 rounds."""
    rng = np.random.default_rng(7)
    user_data = []
    for u in range(8):
        probs = np.ones(4) / 4
        probs[u % 4] += 1.0
        probs /= probs.sum()
        user_data.append({
            "x": rng.normal(size=(64, 16)).astype(np.float32),
            "y": rng.choice(4, 64, p=probs)})

    def loss_fn(params, batch):
        logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], -1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()

    params = {"w": torch.zeros(16, 4, device=device),
              "b": torch.zeros(4, device=device)}
    spec = ExperimentSpec(rounds=rounds, strategy=strategy, seed=seed)
    engine = build_host_engine(spec, params, loss_fn, user_data,
                               device=device)
    return engine.run(), engine.global_params


def phase_reference_small():
    """The card's winners equal the pinned ones, and for a priority
    strategy (whose winners depend on trained floats) the card and the
    CPU run of the same rounds agree. One strategy and seed each: the
    CPU tests hold every pinned cell against the reference package."""
    with open(os.path.join(ROOT, "tests", "winner_pins.json")) as f:
        pins = json.load(f)["winners"]
    hist, _ = pin_scenario("random-distributed", 0, "cuda")
    if hist.winners != pins["random-distributed/seed0"]:
        raise AssertionError("random-distributed winners differ from "
                             f"the pins: {hist.winners}")
    gh, gp = pin_scenario("priority-distributed", 0, "cuda")
    ch, cp = pin_scenario("priority-distributed", 0, "cpu")
    if gh.winners != ch.winners or gh.collisions != ch.collisions \
            or gh.contention_slots != ch.contention_slots:
        raise AssertionError("priority-distributed: the card and the CPU "
                             f"chose differently: {gh.winners} vs "
                             f"{ch.winners}")
    if gh.winners != pins["priority-distributed/seed0"]:
        raise AssertionError("priority-distributed: winners differ from "
                             "the pins")
    np.testing.assert_allclose(gh.priorities, ch.priorities, rtol=1e-4)
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=1e-4, atol=1e-6)
    emit("reference_small", agree_with_pins=["random-distributed/seed0",
                                             "priority-distributed/seed0"],
         card_equals_cpu=["priority-distributed/seed0"])


def phase_determinism(rounds=5):
    runs = []
    for _ in range(2):
        hist, engine, _, _, _, _ = run_main_path("mlp", rounds)
        runs.append((hist.winners,
                     [l.clone() for l in tree_leaves(engine.global_params)]))
    if runs[0][0] != runs[1][0]:
        raise AssertionError("determinism: winners differ between two runs")
    for a, b in zip(runs[0][1], runs[1][1]):
        if not torch.equal(a, b):
            raise AssertionError("determinism: final globals differ "
                                 "bitwise between two runs")
    emit("determinism", rounds=rounds, winners=runs[0][0],
         final_global_bit_equal=True)


def phase_main_path_device(rounds=20):
    """The paper's MLP cell with ``--contention-backend device``, run
    twice: the checks of ``check_main_path`` (learning included), each
    contention pass launched once per loop event, and the two runs
    bit-equal in winners and final global."""
    runs = []
    for _ in range(2):
        hist, engine, dt, launches, round_s, loop = run_main_path(
            "mlp", rounds, "--contention-backend", "device")
        leaves, steps, merged = check_main_path(
            "main_path_mlp_device", hist, engine, launches, rounds, True,
            events=loop["events"])
        runs.append((hist, [l.clone() for l in
                            tree_leaves(engine.global_params)]))
        del engine
    if runs[0][0].winners != runs[1][0].winners or not all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])):
        raise AssertionError("main_path_mlp_device: two runs differ in "
                             "winners or final global")
    steady = statistics.median(round_s[1:])
    emit("main_path_mlp_device", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, launches=launches,
         events=loop["events"], attempts=loop["attempts"],
         pool_shapes=loop["shapes"],
         launches_per_round={"fused_sgd": leaves * steps,
                             "delta_norm": leaves, "gather_combine": leaves,
                             **{k: loop["events"] / rounds
                                for k in CONTENTION}},
         merged_rounds=merged, collisions=hist.collisions,
         contention_slots=hist.contention_slots,
         accuracy_first=hist.accuracy[0], accuracy_last=hist.accuracy[-1],
         loss_first=hist.train_loss[0], loss_last=hist.train_loss[-1],
         winners_and_global_bit_equal_run_to_run=True)
    return launches, set(map(tuple, loop["shapes"]))


def phase_main_path_u1000(rounds=3):
    """The MLP at full width with 1000 users and 64 winners a round —
    the large-cohort regime device contention exists for (the fc1 stack
    alone is 627 MB f32) — with the seconds spent in training and in
    selection."""
    torch.cuda.reset_peak_memory_stats()
    split = {}
    hist, engine, dt, launches, round_s, loop = run_main_path(
        "mlp", rounds, "--users", "1000", "--k", "64", "--n-train",
        "60000", "--round-mode", "fused", "--contention-backend", "device",
        split=split)
    check_main_path("main_path_mlp_U1000_device", hist, engine, launches,
                    rounds, False, events=loop["events"])
    steady = statistics.median(round_s[1:])
    emit("main_path_mlp_U1000_device", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, round_s=round_s, launches=launches,
         events=loop["events"], attempts=loop["attempts"],
         pool_shapes=loop["shapes"],
         train_s=split["train_round"], select_s=split["select"],
         train_share=split["train_round"] / dt,
         select_share=split["select"] / dt,
         deliveries=[len(w) for w in hist.winners],
         collisions=hist.collisions, contention_slots=hist.contention_slots,
         accuracy=hist.accuracy, loss=hist.train_loss,
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    return launches, set(map(tuple, loop["shapes"]))


def phase_profile(model, rounds=4, *extra):
    """``--profile``: where a steady round's time goes — device time by
    kernel name and the device's busy share, from ``torch.profiler``
    over the rounds after the first."""
    from torch.profiler import ProfilerActivity, profile
    engine = launch_train.build_paper_engine(
        paper_args("--model", model, "--rounds", str(rounds), *extra))
    engine.run()                               # warm-up
    hist = FLHistory(selections=np.zeros(engine.num_users, np.int64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(rounds):
            engine.run_round(t, hist)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError("profile: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "repro" in r[0] or "fused_sgd" in r[0]
               or "delta_norm" in r[0] or "combine_kernel" in r[0]
               or "contention_cu" in r[0])
    label = model + ("_device" if extra else "")
    emit(f"profile_{label}", rounds=rounds, wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
         port_kernels_ms=ours, port_kernels_share_of_busy=ours / busy_ms,
         device_kernels=len(rows),
         launches=sum(r[2] for r in rows),
         top=[dict(name=k[:90], ms=ms, count=c) for k, ms, c in rows[:12]],
         host_top=[dict(name=e.key[:60], self_cpu_ms=e.self_cpu_time_total
                        / 1e3, count=e.count)
                   for e in sorted(prof.key_averages(),
                                   key=lambda e: -e.self_cpu_time_total)[:10]])


# -------------------------------------------------------------------- run
def main():
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = kbuild.build_all(verbose=True)
    for stem in built:
        kbuild.library(stem)                   # load, set argtypes
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=kbuild.find_nvcc(), flags=" ".join(kbuild.NVCC_FLAGS),
         libraries=sorted(os.path.basename(str(p)) for p in built.values()))

    # ---- every kernel against its plain version ----------------------
    # the leaf shapes are read off the models the main path trains, so a
    # path cannot hand a kernel a shape that is compared nowhere
    leaves = {m: [tuple(l.shape) for l in tree_leaves(
        get_paper_model(m)[0](0, device="cpu"))] for m in ("mlp", "cnn")}
    cases = [((127,), 3), ((2, 129, 5), 4)]
    cases += [(s, U) for U in (10, 1024) for s in leaves["mlp"]]
    cases += [(s, 10) for s in leaves["cnn"]]
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNELS}
    bit_equal = {k: True for k in KERNELS}
    dn_rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, U) in enumerate(cases):
            got = check_kernels_at(shape, U, dtype, seed=10 * i)
            for k, v in got.items():
                key = str(dtype).split(".")[1]
                worst[k][key] = max(worst[k][key], v[0])
                bit_equal[k] = bit_equal[k] and v[1]
            dn_rel = max(dn_rel, got["delta_norm"][2])
        check_merge_contracts(dtype)
    # the contention passes at the JAX test's shapes, the paper cell's
    # pool, the dense pool and its first retry, the exact M = N fallback;
    # every pool shape the loop runs on later is checked after it ran
    c_shapes = [(3, 7), (2, 300), (4, 2049), (1, 10), (1, 128), (64, 128),
                (64, 1024), (8, 100000)]
    for i, (B, N) in enumerate(c_shapes):
        check_contention_at(B, N, seed=1000 + i)
    torch.cuda.empty_cache()
    emit("kernels_agree", cases=[[list(s), U] for s, U in cases],
         max_abs_err=worst, bit_equal_to_plain=bit_equal,
         delta_norm_max_rel_err=dn_rel,
         tolerance="f32 rtol 1e-5 atol 1e-6; bf16 atol 0.02 (one ulp of "
                   "the output type); delta_norm sums rtol 1e-5; "
                   "contention: bit-equal, all six outputs and dtypes",
         merge_contracts="bitwise: zero weight masks inf/NaN rows, "
                         "all-zero weights return glob, pad width, "
                         "S=U ids vs S=K positions",
         contention_cases=[list(c) for c in c_shapes],
         contention_inputs="forced expiry tie, dead lanes, a row with no "
                           "live lane (B > 1), no live lane at all, "
                           "absolute expiries up to BIG; max doublings 5 "
                           "and 7")

    # ---- times at the main path's largest leaf, and its small ones ---
    timed = {}
    for label, U, shape, reps in (("mlp_fc1w_U10", 10, (784, 200), 200),
                                  ("mlp_fc2b_U10", 10, (10,), 200),
                                  ("mlp_fc1w_U1024", 1024, (784, 200), 10)):
        timed[label] = bench_kernels(U, shape, torch.float32, reps)
        torch.cuda.empty_cache()
    # the contention passes at the paper cell's pool (1, 10), the 1000-
    # user pool (1, 512), (1, 128), the dense pool (64, 128) and a pool
    # of the exact fallback's size (8, 100000)
    for B, N in ((1, 10), (1, 128), (1, 512), (64, 128), (8, 100000)):
        timed[f"contention_{B}x{N}"] = bench_contention(B, N, reps=200)
    emit("kernel_times", dtype="float32 / int32", timed=timed)

    # ---- the main path, through the entry points ---------------------
    torch.cuda.reset_peak_memory_stats()
    engine, l_mlp = phase_main_path("mlp", rounds=20, check_accuracy=True)
    l_srv = phase_server_path(engine, "mlp")
    del engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, l_cnn = phase_main_path("cnn", rounds=3, check_accuracy=False)
    phase_server_path(engine, "cnn")
    del engine
    torch.cuda.empty_cache()
    phase_reference_small()
    phase_determinism()

    # ---- device contention --------------------------------------------
    ran = phase_contention_loop_agree() | phase_contention_dense()
    l_dev, s_dev = phase_main_path_device()
    torch.cuda.empty_cache()
    l_u1000, s_u1000 = phase_main_path_u1000()
    torch.cuda.empty_cache()
    ran |= s_dev | s_u1000
    late = sorted(ran - set(c_shapes))
    for i, (B, N) in enumerate(late):
        check_contention_at(B, N, seed=2000 + i)
    emit("contention_shapes_agree", loop_pool_shapes=sorted(ran),
         checked_before=[list(c) for c in c_shapes],
         checked_now=[list(c) for c in late], bit_equal=True)

    if "--profile" in sys.argv[1:]:
        phase_profile("mlp")
        phase_profile("mlp", 4, "--contention-backend", "device")
        phase_profile("cnn", rounds=2)

    # ---- the record ---------------------------------------------------
    record = []
    for name, meta in KERNELS.items():
        contention = name in CONTENTION
        launches = (l_dev if contention else l_srv
                    if name == "fedavg_combine" else l_mlp)[name]
        if launches < 1:
            raise AssertionError(f"{name}: never launched on its path")
        t = timed["contention_1x10" if contention else "mlp_fc1w_U10"][name]
        record.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches,
            max_abs_err=worst[name]["float32"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            graph_ms=t["graph_ms"],
            max_abs_err_bf16=None if contention else worst[name]["bfloat16"],
            # delta_norm's outputs are sums of ~1e5: its tolerance is
            # relative, and so is the error worth reading
            max_rel_err=(dn_rel if name == "delta_norm" else None),
            bit_equal_to_plain=bit_equal[name],
            launches_cnn=l_cnn[name],
            launches_U1000_device=l_u1000[name],
            timed_at=("int32 (1, 10): the paper cell's contention pool, "
                      "10 users" if contention else
                      "f32 (10, 784, 200): the MLP's fc1.w leaf, 10 users")))
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
