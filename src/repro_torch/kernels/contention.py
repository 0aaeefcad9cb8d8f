"""Device-resident slotted CSMA/CA contention engine.

Counterpart of ``repro/kernels/contention.py``. Four parts:

  * the CUDA bindings (``csrc/contention.cu``): ``contention_loop_cuda``,
    the persistent kernel that runs a whole contention call's event loop,
    one block per pool row, in one launch; and the per-event passes
    ``contention_min_cuda`` (masked row min), ``contention_expiry_cuda``
    (expiry count, first expiring index) and ``contention_transition_cuda``
    (decrement / deliver / redraw), which ``ops.contention_event``
    composes;
  * the redraw material: ``counter_uniform``, a counter-based U[0, 1) of
    ``(key, event, row, pool column)`` in int64 torch arithmetic, the same
    function the kernel computes (``counter_bits`` is the integer draw,
    ``counter_uniform53`` its 53-bit twin on (0, 1], which the AirComp
    noise plane is made from);
  * ``_contend_device``, the event loop as a Python ``while`` over medium
    events on a candidate pool of the M smallest expiries per row, in
    absolute idle-time coordinates, with one host sync per event for the
    stop test — the persistent kernel's plain version;
  * ``device_contend_batch``, the host driver: range checks, counter
    quantisation, the host pool gather and the exact retry ladder.

Protocol parity with the numpy reference is exact; stream parity is not:
collision redraws are counter-based (the draw of pool column ``c`` of row
``b`` in event ``ev`` is a function of ``(entropy, call_index, ev, b, c)``
alone), so the same simulator seed and call order give the same result,
retries included, but not numpy's ``Generator`` draws nor the JAX
package's threefry draws. The CPU and the card draw the same numbers, so
``device="cpu"`` and the card give the same results. The loop takes the
draw function (and the event op) as parameters, so a test can hand it the
reference's draws and a smoke run the plain or the three-pass event op;
no user-facing option reaches either.

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
#: events (an attempt adds the most any of its rows ran, which is what the
#: Python loop iterates) and every (B, M) pool shape run; ``row_events``
#: holds the per-row event counts of each attempt of the LAST call
LOOP: Dict = {"calls": 0, "attempts": 0, "events": 0, "shapes": set(),
              "row_events": []}

#: columns of the loop's packed (B, HEAD + 2 k_max) int32 result before the
#: winners and finish slots
HEAD = ("elapsed", "wins", "collisions", "invalid", "events")


def reset_loop_stats() -> None:
    LOOP.update(calls=0, attempts=0, events=0, shapes=set(), row_events=[])


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


def loop_shared_lanes() -> int:
    """The widest pool whose lane state the persistent kernel keeps in
    shared memory; wider pools run the same loop on global scratch."""
    return library("contention").repro_contention_loop_shared_lanes()


def contention_loop_cuda(pool_exp, pool_win, pool_idx, threshold, k_arr, *,
                         k_max: int, tx_slots: int, max_doublings: int,
                         max_sim_slots: int, key: int):
    """The persistent event loop: one launch for the whole loop over (B, M)
    pool tensors (int32 expiries, f32 windows, int32 user ids; (B,) int32
    thresholds and k). Returns the packed (B, 5 + 2 k_max) int32 result
    (``HEAD``, then winners and finish slots)."""
    B, M = _pool_dims(pool_exp)
    dev = pool_exp.device
    _check("pool_exp", pool_exp, torch.int32, (B, M), dev)
    _check("pool_win", pool_win, torch.float32, (B, M), dev)
    _check("pool_idx", pool_idx, torch.int32, (B, M), dev)
    _check("threshold", threshold, torch.int32, (B,), dev)
    _check("k_arr", k_arr, torch.int32, (B,), dev)
    scratch = [None, None]
    if M > loop_shared_lanes():
        scratch = [torch.empty((B, M), dtype=torch.int32, device=dev)
                   for _ in range(2)]
    out = torch.empty((B, len(HEAD) + 2 * k_max), dtype=torch.int32,
                      device=dev)
    rc = library("contention").repro_contention_loop(
        pool_exp.data_ptr(), pool_win.data_ptr(), pool_idx.data_ptr(),
        threshold.data_ptr(), k_arr.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        out.data_ptr(), B, M, int(k_max), int(tx_slots), int(max_doublings),
        int(max_sim_slots), int(key) & _MASK64, launch_stream(pool_exp))
    check_launch(rc, "contention_loop")
    return out


# ---------------------------------------------------------- redraw draws
_MASK64 = (1 << 64) - 1
_GOLDEN, _MIX1, _MIX2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, \
    0x94D049BB133111EB


def _splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & _MASK64
    x = ((x ^ (x >> 30)) * _MIX1) & _MASK64
    x = ((x ^ (x >> 27)) * _MIX2) & _MASK64
    return x ^ (x >> 31)


def counter_key(entropy: int, call_index: int) -> int:
    """The 64-bit key of one contention call: a fixed splitmix64 mix of
    ``(entropy, call_index)``."""
    return _splitmix64(_splitmix64(int(entropy) & _MASK64)
                       ^ (int(call_index) & _MASK64))


def _i64(x: int) -> int:
    """A 64-bit pattern as the signed int64 that holds it."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x``: the arithmetic shift with the
    sign-extended bits masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64_t(x: torch.Tensor) -> torch.Tensor:
    """``_splitmix64`` on int64 tensors: additions and products keep their
    low 64 bits (two's complement wraps), shifts are logical."""
    x = x + _i64(_GOLDEN)
    x = (x ^ _lshr(x, 30)) * _i64(_MIX1)
    x = (x ^ _lshr(x, 27)) * _i64(_MIX2)
    return x ^ _lshr(x, 31)


def counter_bits(key: int, ev: int, B: int, M: int,
                 device) -> torch.Tensor:
    """(B, M) int64: element ``(b, c)`` holds the 64 bits of
    ``splitmix64(splitmix64(key ^ ev) ^ (b << 32 | c))`` — a function of
    ``(key, ev, b, c)`` alone, computed alike on every device."""
    if M > 1 << 32:
        raise ValueError(f"counter_bits: M = {M} columns exceed 2^32")
    k = torch.tensor(_i64(key), dtype=torch.int64, device=device)
    kev = _splitmix64_t(k ^ _i64(ev))
    lane = ((torch.arange(B, dtype=torch.int64, device=device) << 32)[:, None]
            | torch.arange(M, dtype=torch.int64, device=device)[None, :])
    return _splitmix64_t(kev ^ lane)


def counter_uniform(key: int, ev: int, B: int, M: int,
                    device) -> torch.Tensor:
    """(B, M) f32 U[0, 1): the top 24 bits of ``counter_bits`` times
    2^-24 (exact in f32) — the persistent kernel's draw, bit for bit."""
    x = counter_bits(key, ev, B, M, device)
    return _lshr(x, 40).to(torch.float32) * (2.0 ** -24)


def counter_uniform53(key: int, ev: int, B: int, M: int,
                      device) -> torch.Tensor:
    """(B, M) f64 on (0, 1]: ``((counter_bits >> 11) + 1) * 2^-53``, the
    top 53 bits of the draw (exact in f64), never 0 — a logarithm of it
    is finite."""
    x = counter_bits(key, ev, B, M, device)
    return (_lshr(x, 11) + 1).to(torch.float64) * (2.0 ** -53)


def counter_draw(entropy: int, call_index: int, device) -> Callable:
    """The loop's default redraw material: ``draw(ev, B, M)`` is
    ``counter_uniform(counter_key(entropy, call_index), ev, B, M)`` on
    ``device`` — a function of ``(entropy, call_index, ev, row, pool
    column)`` alone, so a retry attempt and a re-run see the same draws,
    and so do the CPU and the card."""
    key = counter_key(entropy, call_index)

    def draw(ev: int, B: int, M: int) -> torch.Tensor:
        return counter_uniform(key, ev, B, M, device)
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
    """Run the event loop on (B, M) pool tensors; returns the packed
    (B, 5 + 2 k_max) int32 result of ``contention_loop_cuda``: per row
    ``HEAD`` (elapsed t, wins, collisions, invalid, the events the row
    ran), then its winners and finish slots."""
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
    row_events = torch.zeros_like(t)
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
        row_events += running.to(i32)
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
    head = torch.stack([t, wins, cols, invalid.to(i32), row_events], dim=1)
    return torch.cat([head, winners, finish], dim=1)


def gather_pool(counters: np.ndarray, windows: np.ndarray, M: int):
    """Host-side O(B*N) candidate selection: the M smallest expiries per
    row (stable by value), their windows and user ids, and the (M+1)-th
    value as the validity threshold (int32 max when M >= N)."""
    B, N = counters.shape
    if M >= N:
        idx = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N))
        thr = np.full((B,), np.iinfo(np.int32).max, np.int32)
        return counters, windows, idx, thr
    cand = np.argpartition(counters, M, axis=1)[:, :M + 1]
    vals = np.take_along_axis(counters, cand, axis=1)
    order = np.argsort(vals, axis=1, kind="stable")
    pool_cols = order[:, :M]
    idx = np.take_along_axis(cand, pool_cols, axis=1).astype(np.int32)
    thr = np.take_along_axis(vals, order[:, M:M + 1], axis=1)[:, 0]
    return (np.take_along_axis(counters, idx, axis=1),
            np.take_along_axis(windows, idx, axis=1), idx, thr)


def device_contend_batch(backoff_slots, window_slots, k_arr,
                         participating, *, entropy: int, call_index: int,
                         tx_slots: int, max_backoff_doublings: int,
                         max_sim_slots: int, device=None,
                         draw: Optional[Callable] = None,
                         event_op: Optional[Callable] = None):
    """Run B contention rounds on ``device``; returns ``BatchCSMAResult``.

    Inputs are in SLOT units (``CSMASimulator`` converts its second-based
    surface). ``entropy`` / ``call_index`` seed the counter-based redraw
    stream: one stream per simulator, one key per call, one draw per
    (event, row, pool column) — the same (entropy, call order) gives
    bit-identical results, on the CPU and on the card alike.
    ``device=None`` is the CUDA device (raises without one); ``"cpu"``
    runs the plain loop. Each pool attempt is ``ops.contention_loop``: on
    the card one launch of the persistent kernel and one sync. ``draw``
    and ``event_op`` replace the loop's redraw material and event op and
    run the Python loop (``_contend_device``) instead; both are test
    hooks.
    """
    from repro_torch.core.csma import BatchCSMAResult
    from repro_torch.kernels import ops

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
    hooked = draw is not None or event_op is not None
    if hooked and draw is None:
        draw = counter_draw(entropy, call_index, dev)
    windows = np.broadcast_to(
        np.asarray(window_slots, np.float64), (B, N))
    counters = np.minimum(
        np.maximum(0, np.round(backoff_slots)), CONTENTION_BIG
    ).astype(np.int32)
    counters = np.where(part, counters, np.int32(CONTENTION_BIG))

    def on_dev(a, dtype):
        # a C-ordered copy: broadcast views are read-only and strided
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)

    k_dev = on_dev(k_arr, np.int32)
    loop_kw = dict(k_max=k_max, tx_slots=int(tx_slots),
                   max_doublings=int(max_backoff_doublings),
                   max_sim_slots=int(max_sim_slots))
    LOOP["calls"] += 1
    LOOP["row_events"] = []
    # candidate-pool sizing with exactness retry: start small (the usual
    # k + colliders regime), grow geometrically on pool exhaustion, land
    # on the exact full-cohort loop at M >= N. The retry decision depends
    # on the data but not on chance: the same inputs, entropy and call
    # index always give the same result.
    M = min(N, max(128, 8 * k_max))
    while True:
        pool = gather_pool(counters, windows, M)
        args = [on_dev(a, dt) for a, dt in zip(
            pool, (np.int32, np.float32, np.int32, np.int32))]
        if hooked:
            packed = _contend_device(*args, k_dev, draw=draw,
                                     event_op=event_op, **loop_kw)
        else:
            packed = ops.contention_loop(
                *args, k_dev, key=counter_key(entropy, call_index),
                **loop_kw)
        res = packed.cpu().numpy().astype(np.int64)   # the attempt's sync
        row_events = res[:, HEAD.index("events")]
        LOOP["attempts"] += 1
        LOOP["events"] += int(row_events.max(initial=0))
        LOOP["row_events"].append(row_events.tolist())
        LOOP["shapes"].add((B, args[0].shape[1]))
        if M >= N or not res[:, HEAD.index("invalid")].any():
            break
        M = min(N, M * 8)

    h = len(HEAD)
    return BatchCSMAResult(
        winners=np.ascontiguousarray(res[:, h:h + k_max]),
        finish_slots=np.ascontiguousarray(res[:, h + k_max:]),
        collisions=res[:, HEAD.index("collisions")].copy(),
        elapsed_slots=res[:, HEAD.index("elapsed")].copy(),
        n_delivered=res[:, HEAD.index("wins")].copy())
