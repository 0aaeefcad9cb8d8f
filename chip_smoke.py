#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one NVIDIA GPU with the CUDA toolkit's ``nvcc``; fails at once
without CUDA (there is no CPU path here). It

  1. names the card (``nvidia-smi`` name and power limit) and the
     toolchain;
  2. builds the four hand-written ``sm_90a`` kernels from
     ``src/repro_torch/kernels/csrc/``;
  3. holds every kernel against its plain PyTorch version on the card —
     f32 and bf16, ragged sizes and every leaf shape the driven paths
     hand it (the paper's MLP with 10 and with 1024 users, the full-width
     CNN with 10), including the masked non-finite row and the
     all-zero-weight merge — and times kernel, plain version and, where
     one exists, the single PyTorch library call;
  4. drives the port's main path through its normal entry points:
     ``launch.train.build_paper_engine`` with the paper's defaults (MLP
     784x200x10, 10 users, 2 winners a round, ``priority-distributed``)
     for 20 rounds, the full-width CNN for 3 rounds, and after each the
     ``core.server`` merges and the backend's own merge on a freshly
     trained stack, held against the plain version — with the launch
     counts set to zero just before each and read just after;
  5. checks the result by the repository's own means: the pinned
     winners of ``tests/winner_pins.json``, the card against the CPU run
     of the same rounds, and run-to-run bit-equality on the card.

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
from repro_torch.engine import (ExperimentSpec, FLHistory,  # noqa: E402
                                build_host_engine)
from repro_torch.engine.backends import compact_weights   # noqa: E402
from repro_torch.kernels import build as kbuild           # noqa: E402
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
}


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
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        res[name] = dict(
            ms=time_ms(kernel, reps),
            graph_ms=graph_ms(kernel),
            plain_ms=time_ms(plain, plain_reps, samples=3, warmup=1),
            library_ms=(time_ms(library, reps) if library else None),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes)

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


def run_main_path(model, rounds):
    """The paper's cell through ``launch.train.build_paper_engine`` and
    ``FLEngine.run``; returns (history, engine, seconds, launches,
    per-round seconds). The engine evaluates after every round, so the
    clock is read inside its eval callback, after a synchronize."""
    engine = launch_train.build_paper_engine(
        paper_args("--model", model, "--rounds", str(rounds)))
    inner, stamps = engine.eval_fn, []

    def timed_eval(params):
        acc = inner(params)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return acc

    engine.eval_fn = timed_eval
    torch.cuda.synchronize()
    ops.reset_launches()                      # just before the main path
    t0 = time.perf_counter()
    hist = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)             # just after it
    round_s = np.diff([t0, *stamps]).tolist()
    return hist, engine, dt, launches, round_s


def check_main_path(name, hist, engine, launches, rounds, check_accuracy):
    leaves = len(tree_leaves(engine.global_params))
    steps = engine.backend._nb * engine.spec.local_epochs
    merged = sum(1 for w in hist.winners if w)
    want = {"fused_sgd": leaves * steps * rounds,
            "delta_norm": leaves * rounds,
            "gather_combine": leaves * merged,
            "fedavg_combine": 0}
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
    hist, engine, dt, launches, round_s = run_main_path(model, rounds)
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
        hist, engine, _, _, _ = run_main_path("mlp", rounds)
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


def phase_profile(model, rounds=4):
    """``--profile``: where a steady round's time goes — device time by
    kernel name and the device's busy share, from ``torch.profiler``
    over the rounds after the first."""
    from torch.profiler import ProfilerActivity, profile
    engine = launch_train.build_paper_engine(
        paper_args("--model", model, "--rounds", str(rounds)))
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
               or "delta_norm" in r[0] or "combine_kernel" in r[0])
    emit(f"profile_{model}", rounds=rounds, wall_ms=wall_ms,
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
    torch.cuda.empty_cache()
    emit("kernels_agree", cases=[[list(s), U] for s, U in cases],
         max_abs_err=worst, bit_equal_to_plain=bit_equal,
         delta_norm_max_rel_err=dn_rel,
         tolerance="f32 rtol 1e-5 atol 1e-6; bf16 atol 0.02 (one ulp of "
                   "the output type); delta_norm sums rtol 1e-5",
         merge_contracts="bitwise: zero weight masks inf/NaN rows, "
                         "all-zero weights return glob, pad width, "
                         "S=U ids vs S=K positions")

    # ---- times at the main path's largest leaf, and its small ones ---
    timed = {}
    for label, U, shape, reps in (("mlp_fc1w_U10", 10, (784, 200), 200),
                                  ("mlp_fc2b_U10", 10, (10,), 200),
                                  ("mlp_fc1w_U1024", 1024, (784, 200), 10)):
        timed[label] = bench_kernels(U, shape, torch.float32, reps)
        torch.cuda.empty_cache()
    emit("kernel_times", dtype="float32", timed=timed)

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
    if "--profile" in sys.argv[1:]:
        phase_profile("mlp")
        phase_profile("cnn", rounds=2)

    # ---- the record ---------------------------------------------------
    primary = timed["mlp_fc1w_U10"]
    record = []
    for name, meta in KERNELS.items():
        launches = (l_srv if name == "fedavg_combine" else l_mlp)[name]
        if launches < 1:
            raise AssertionError(f"{name}: never launched on its path")
        t = primary[name]
        record.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches,
            max_abs_err=worst[name]["float32"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            graph_ms=t["graph_ms"],
            max_abs_err_bf16=worst[name]["bfloat16"],
            # delta_norm's outputs are sums of ~1e5: its tolerance is
            # relative, and so is the error worth reading
            max_rel_err=(dn_rel if name == "delta_norm" else None),
            bit_equal_to_plain=bit_equal[name],
            launches_cnn=l_cnn[name],
            timed_at="f32 (10, 784, 200): the MLP's fc1.w leaf, 10 users"))
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
