"""Device-resident slotted CSMA/CA contention engine.

Counterpart of ``repro/kernels/contention.py``. Three parts:

  * the CUDA bindings of the per-event passes (``csrc/contention.cu``):
    ``contention_min_cuda`` (masked row min), ``contention_expiry_cuda``
    (expiry count, first expiring index) and ``contention_transition_cuda``
    (decrement / deliver / redraw); ``ops.contention_event`` composes them;
  * ``_contend_device``, the event loop: a Python ``while`` over medium
    events on a candidate pool of the M smallest expiries per row, in
    absolute idle-time coordinates, with one host sync per event for the
    stop test;
  * ``device_contend_batch``, the host driver: range checks, counter
    quantisation, the host pool gather and the exact retry ladder.

Protocol parity with the numpy reference is exact; stream parity is not:
collision redraws are counter-based (event ``ev``'s draws are a function
of ``(entropy, call_index, ev)`` alone), so the same simulator seed and
call order give the same result, retries included, but not numpy's
``Generator`` draws — nor the JAX package's threefry draws, nor the same
draws on the CPU and on the card. The loop takes the draw function (and
the event op) as parameters, so a test can hand it the reference's
draws and a smoke run the plain event op; no user-facing option reaches
either.

All slot arithmetic is int32, clamped to ``ref.CONTENTION_BIG`` (2^29)
so ``t + step + tx_slots`` can never overflow.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.build import check_launch, launch_stream, library
from repro_torch.kernels.ref import CONTENTION_BIG

#: what the event loop did since the last ``reset_loop_stats()``: calls of
#: ``device_contend_batch``, loop attempts (one more per retry), medium
#: events (one ``contention_event`` each) and every (B, M) pool shape run
LOOP: Dict = {"calls": 0, "attempts": 0, "events": 0, "shapes": set()}


def reset_loop_stats() -> None:
    LOOP.update(calls=0, attempts=0, events=0, shapes=set())


# ------------------------------------------------------------- bindings
def _check(name, t, dtype, shape, device):
    if not (t.is_cuda and t.device == device):
        raise ValueError(f"contention: {name} must lie on {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"contention: {name} must be a contiguous {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)}")


def _pool_dims(counters):
    if counters.dim() != 2:
        raise ValueError("contention: counters must be (B, N)")
    B, N = counters.shape
    if N >= (1 << 31) - (1 << 20):
        raise ValueError(f"contention: N={N} is out of int32 range")
    return B, N


def contention_min_cuda(counters, live):
    """Pass 1: (B,) int32 ``min(live ? counters : BIG)`` per row."""
    B, N = _pool_dims(counters)
    dev = counters.device
    _check("counters", counters, torch.int32, (B, N), dev)
    _check("live", live, torch.bool, (B, N), dev)
    step = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = library("contention").repro_contention_min(
        counters.data_ptr(), live.data_ptr(), step.data_ptr(), B, N,
        launch_stream(counters))
    check_launch(rc, "contention_min")
    return step


def contention_expiry_cuda(counters, live, step):
    """Pass 2: ``(nexp, winner)``, (B,) int32 each (winner N if none)."""
    B, N = _pool_dims(counters)
    dev = counters.device
    _check("counters", counters, torch.int32, (B, N), dev)
    _check("live", live, torch.bool, (B, N), dev)
    _check("step", step, torch.int32, (B,), dev)
    out = torch.empty((2, B), dtype=torch.int32, device=dev)
    rc = library("contention").repro_contention_expiry(
        counters.data_ptr(), live.data_ptr(), step.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), B, N, launch_stream(counters))
    check_launch(rc, "contention_expiry")
    return out[0], out[1]


def contention_transition_cuda(counters, live, doublings, windows, rand,
                               step, nexp, max_doublings: int):
    """Pass 3: ``(new_counters, new_doublings, new_active)``."""
    B, N = _pool_dims(counters)
    dev = counters.device
    for name, t, dt in (("counters", counters, torch.int32),
                        ("live", live, torch.bool),
                        ("doublings", doublings, torch.int32),
                        ("windows", windows, torch.float32),
                        ("rand", rand, torch.float32)):
        _check(name, t, dt, (B, N), dev)
    _check("step", step, torch.int32, (B,), dev)
    _check("nexp", nexp, torch.int32, (B,), dev)
    ncnt = torch.empty((B, N), dtype=torch.int32, device=dev)
    ndbl = torch.empty((B, N), dtype=torch.int32, device=dev)
    nact = torch.empty((B, N), dtype=torch.bool, device=dev)
    rc = library("contention").repro_contention_transition(
        counters.data_ptr(), live.data_ptr(), doublings.data_ptr(),
        windows.data_ptr(), rand.data_ptr(), step.data_ptr(),
        nexp.data_ptr(), ncnt.data_ptr(), ndbl.data_ptr(), nact.data_ptr(),
        B, N, int(max_doublings), launch_stream(counters))
    check_launch(rc, "contention_transition")
    return ncnt, ndbl, nact


# ---------------------------------------------------------- redraw draws
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def counter_seed(entropy: int, call_index: int, ev: int) -> int:
    """A 63-bit generator seed from a fixed splitmix64 mix of
    ``(entropy, call_index, ev)`` — a function of those three alone."""
    base = _splitmix64(_splitmix64(int(entropy) & _MASK64)
                       ^ (int(call_index) & _MASK64))
    return _splitmix64(base ^ (int(ev) & _MASK64)) >> 1


def counter_draw(entropy: int, call_index: int, device) -> Callable:
    """The loop's default redraw material: ``draw(ev, B, M)`` is a (B, M)
    f32 U(0, 1) tensor on ``device`` from a generator seeded with
    ``counter_seed(entropy, call_index, ev)``, so a retry attempt and a
    re-run see the same draws."""
    def draw(ev: int, B: int, M: int) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(counter_seed(entropy, call_index, ev))
        return torch.rand((B, M), generator=gen, dtype=torch.float32,
                          device=device)
    return draw


# ------------------------------------------------------- the event loop
#
# Candidate-pool formulation. A medium event only ever touches the
# counters that achieve the running minimum, so the loop runs on the M
# smallest initial counters per row, in ABSOLUTE idle-time coordinates (a
# pool member's value is the total idle time at which it expires — no
# per-event decrement of the full (B, N) state). Collision redraws
# re-enter the pool at ``tau + redraw``. Every excluded counter is >= the
# (M+1)-th smallest initial value (``threshold``), so events are exact
# while ``tau < threshold``; a row that reaches it raises ``invalid`` and
# the host retries the batch with a larger M (exact when M == N).
def _contend_device(pool_exp, pool_win, pool_idx, threshold, k_arr, *,
                    k_max: int, tx_slots: int, max_doublings: int,
                    max_sim_slots: int, draw: Callable,
                    event_op: Optional[Callable] = None):
    """Run the event loop on (B, M) pool tensors; returns ``(winners,
    finish, collisions, t, wins, invalid, events)`` — int32 tensors, a
    bool (B,) ``invalid`` and the number of events run."""
    if event_op is None:
        from repro_torch.kernels.ops import contention_event as event_op
    dev = pool_exp.device
    i32 = torch.int32
    B, M = pool_exp.shape
    big = torch.tensor(CONTENTION_BIG, dtype=i32, device=dev)
    cap = torch.tensor(max_sim_slots, dtype=i32, device=dev)
    pool_act = pool_exp < big
    pool_dbl = torch.zeros_like(pool_exp)

    t = torch.zeros((B,), dtype=i32, device=dev)
    idle = torch.zeros_like(t)                 # idle slots consumed
    wins = torch.zeros_like(t)
    cols = torch.zeros_like(t)
    invalid = torch.zeros((B,), dtype=torch.bool, device=dev)
    winners = torch.full((B, k_max), -1, dtype=i32, device=dev)
    finish = torch.full((B, k_max), -1, dtype=i32, device=dev)
    rows = torch.arange(B, device=dev)

    ev = 0
    while True:
        running = ((wins < k_arr) & pool_act.any(dim=1) & (t < cap)
                   & ~invalid)
        if not bool(running.any()):             # the per-event host sync
            break
        live = pool_act & running[:, None]
        # the event op sees ABSOLUTE expiries: its "step" is tau (the pool
        # min) and its decremented counters are relative to tau
        tau, nexp, wslot, ncnt, ndbl, nact = event_op(
            pool_exp, live, pool_dbl, pool_win, draw(ev, B, M),
            max_doublings)
        tau = torch.minimum(tau, big)
        # pool-exhaustion guard: an excluded counter could expire first
        bad = running & (tau >= threshold)
        running = running & ~bad
        finish_t = t + (tau - idle) + tx_slots
        # horizon clamp: an event whose airtime can't complete by the cap
        # freezes the row at exactly the cap
        overrun = running & (finish_t > cap)
        apply = running & ~overrun
        deliver = apply & (nexp == 1)
        collide = apply & (nexp >= 2)
        t = torch.where(overrun, cap, torch.where(apply, finish_t, t))
        idle = torch.where(apply, tau, idle)
        winner = pool_idx.gather(
            1, torch.clamp(wslot, max=M - 1).long()[:, None])[:, 0]
        slot = torch.clamp(wins, max=k_max - 1).long()
        winners[rows, slot] = torch.where(deliver, winner,
                                          winners[rows, slot])
        finish[rows, slot] = torch.where(deliver, finish_t,
                                         finish[rows, slot])
        wins = wins + deliver.to(i32)
        cols = cols + collide.to(i32)
        # redraws come back relative to tau; re-absolutize and clamp
        keep = apply[:, None]
        pool_exp = torch.where(keep, torch.minimum(tau[:, None] + ncnt, big),
                               pool_exp)
        pool_dbl = torch.where(keep, ndbl, pool_dbl)
        pool_act = torch.where(keep, nact, pool_act)
        invalid = invalid | bad
        ev += 1
    return winners, finish, cols, t, wins, invalid, ev


def device_contend_batch(backoff_slots, window_slots, k_arr,
                         participating, *, entropy: int, call_index: int,
                         tx_slots: int, max_backoff_doublings: int,
                         max_sim_slots: int, device=None,
                         draw: Optional[Callable] = None,
                         event_op: Optional[Callable] = None):
    """Run B contention rounds on ``device``; returns ``BatchCSMAResult``.

    Inputs are in SLOT units (``CSMASimulator`` converts its second-based
    surface). ``entropy`` / ``call_index`` seed the counter-based redraw
    stream: one stream per simulator, one fold per call, one more per
    medium event — the same (entropy, call order) gives bit-identical
    results. ``device=None`` is the CUDA device (raises without one);
    ``"cpu"`` runs the kernels' plain versions. ``draw`` and
    ``event_op`` replace the loop's redraw material and event op (see
    ``_contend_device``); both are test hooks.
    """
    from repro_torch.core.csma import BatchCSMAResult

    if max_sim_slots > CONTENTION_BIG:
        raise ValueError(
            f"device contention runs int32 slot arithmetic: "
            f"max_sim_slots={max_sim_slots} exceeds {CONTENTION_BIG}")
    if not 0 < tx_slots < (1 << 20):
        raise ValueError(f"tx_slots={tx_slots} out of device range")
    dev = resolve_device(device)
    backoff_slots = np.atleast_2d(np.asarray(backoff_slots, np.float64))
    B, N = backoff_slots.shape
    k_arr = np.broadcast_to(np.asarray(k_arr, np.int64), (B,))
    k_max = int(k_arr.max(initial=0))
    part = (np.ones((B, N), bool) if participating is None
            else np.broadcast_to(np.asarray(participating, bool), (B, N)))
    if k_max == 0:
        z = np.zeros(B, np.int64)
        return BatchCSMAResult(
            winners=np.zeros((B, 0), np.int64),
            finish_slots=np.zeros((B, 0), np.int64),
            collisions=z, elapsed_slots=z.copy(), n_delivered=z.copy())

    entropy = int(entropy) & (2 ** 63 - 1)
    if draw is None:
        draw = counter_draw(entropy, call_index, dev)
    windows = np.broadcast_to(
        np.asarray(window_slots, np.float64), (B, N))
    counters = np.minimum(
        np.maximum(0, np.round(backoff_slots)), CONTENTION_BIG
    ).astype(np.int32)
    counters = np.where(part, counters, np.int32(CONTENTION_BIG))

    def gather_pool(M: int):
        """Host-side O(B*N) candidate selection: the M smallest expiries
        per row plus the (M+1)-th value as the validity threshold."""
        if M >= N:
            idx = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N))
            thr = np.full((B,), np.iinfo(np.int32).max, np.int32)
            return counters, idx, thr
        cand = np.argpartition(counters, M, axis=1)[:, :M + 1]
        vals = np.take_along_axis(counters, cand, axis=1)
        order = np.argsort(vals, axis=1, kind="stable")
        pool_cols = order[:, :M]
        idx = np.take_along_axis(cand, pool_cols, axis=1).astype(np.int32)
        thr = np.take_along_axis(vals, order[:, M:M + 1], axis=1)[:, 0]
        return (np.take_along_axis(counters, idx, axis=1), idx, thr)

    def on_dev(a, dtype):
        # np.array copies: broadcast views are read-only
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    k_dev = on_dev(k_arr, np.int32)
    LOOP["calls"] += 1
    # candidate-pool sizing with exactness retry: start small (the usual
    # k + colliders regime), grow geometrically on pool exhaustion, land
    # on the exact full-cohort loop at M >= N. The retry decision depends
    # on the data but not on chance: the same inputs, entropy and call
    # index always give the same result.
    M = min(N, max(128, 8 * k_max))
    while True:
        pool_exp, pool_idx, threshold = gather_pool(M)
        pool_win = (np.take_along_axis(windows, pool_idx, axis=1)
                    if pool_idx.shape[1] < N else windows)
        winners, finish, cols, t, wins, invalid, events = _contend_device(
            on_dev(pool_exp, np.int32), on_dev(pool_win, np.float32),
            on_dev(pool_idx, np.int32), on_dev(threshold, np.int32),
            k_dev, k_max=k_max, tx_slots=int(tx_slots),
            max_doublings=int(max_backoff_doublings),
            max_sim_slots=int(max_sim_slots), draw=draw, event_op=event_op)
        LOOP["attempts"] += 1
        LOOP["events"] += events
        LOOP["shapes"].add(tuple(pool_exp.shape))
        if M >= N or not bool(invalid.any()):
            break
        M = min(N, M * 8)

    def host(x):
        return x.cpu().numpy().astype(np.int64)
    return BatchCSMAResult(
        winners=host(winners), finish_slots=host(finish),
        collisions=host(cols), elapsed_slots=host(t),
        n_delivered=host(wins))
