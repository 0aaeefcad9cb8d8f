"""Slotted CSMA/CA contention of one round (paper Sec. II-B, III), written
out plainly in NumPy for one cohort.

Each contender's backoff ``R * W`` (Eq. 3) is quantised to 20 us slots;
counters count down while the medium is idle; a lone expiry delivers
after ``tx_slots`` of airtime; two or more collide, burn the airtime and
redraw from doubled windows (capped); the round closes after ``k``
deliveries or at the horizon.

Two engines share that protocol and differ in how a collision redraws:

* ``contend_numpy``: a redraw is ``rng.uniform(0, w)`` from the strategy
  stream, colliders in index order;
* ``contend_device``: the device loop's semantics. The loop runs on a
  candidate pool of the M smallest counters (stable by value), in
  absolute idle time, and retries with M eight times larger whenever a
  row could have missed an excluded counter (exact at M = N); a redraw
  of pool column c in event ev is the top 24 bits of a splitmix64 hash
  of ``(key, ev, row, c)``, times 2^-24, in f32:
  ``round(f32(u * w) * 2^d)`` clipped to [1, 2^29].
"""
from __future__ import annotations

import numpy as np

SLOT_S = 20.0 * 1e-6
TX_SLOTS = 50
MAX_DOUBLINGS = 5
MAX_SIM_SLOTS = 2_000_000
BIG = 1 << 29

_M64 = (1 << 64) - 1
_GOLDEN, _MIX1, _MIX2 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                         0x94D049BB133111EB)


def contend_numpy(backoff_s, window_s, k, participating, rng):
    """Winners (delivery order) of one round; ``backoff_s`` / ``window_s``
    in seconds, ``rng`` the strategy stream (consumed in place)."""
    n = len(backoff_s)
    counters = np.maximum(0, np.round(np.asarray(backoff_s) / SLOT_S)
                          ).astype(np.int64)
    active = np.asarray(participating, bool).copy()
    doublings = np.zeros(n, np.int64)
    winners, t = [], 0
    while len(winners) < k and active.any() and t < MAX_SIM_SLOTS:
        live = np.where(active)[0]
        step = int(counters[live].min())
        if t + step + TX_SLOTS > MAX_SIM_SLOTS:
            break
        t += step
        counters[live] -= step
        expiring = live[counters[live] == 0]
        t += TX_SLOTS
        if len(expiring) == 1:
            winners.append(int(expiring[0]))
            active[expiring[0]] = False
            continue
        for u in expiring:
            doublings[u] = min(doublings[u] + 1, MAX_DOUBLINGS)
            w = window_s[u] * (2.0 ** doublings[u])
            counters[u] = max(1, int(round(rng.uniform(0.0, w) / SLOT_S)))
    return winners


def _splitmix(x):
    """splitmix64 on uint64 arrays (wrapping arithmetic)."""
    x = x + np.uint64(_GOLDEN)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX2)
    return x ^ (x >> np.uint64(31))


def call_key(entropy: int, call: int) -> int:
    e = np.array([entropy & (2 ** 63 - 1)], np.uint64)
    return int(_splitmix(_splitmix(e) ^ np.uint64(call & _M64))[0])


def redraw_uniform(key: int, ev: int, row: int, m: int) -> np.ndarray:
    """(m,) f32 uniforms of event ``ev``, row ``row``, pool columns 0..m-1."""
    kev = _splitmix(np.array([key], np.uint64) ^ np.uint64(ev & _M64))
    lane = (np.uint64(row) << np.uint64(32)) | np.arange(m, dtype=np.uint64)
    bits = _splitmix(kev ^ lane)
    return (bits >> np.uint64(40)).astype(np.float32) * np.float32(2.0 ** -24)


def _pool(counters, windows, m):
    """The m smallest counters (stable by value among an argpartition's
    m + 1 candidates), their f32 windows, user ids, and the (m+1)-th
    value; the whole cohort in user order when m covers it."""
    n = len(counters)
    if m >= n:
        return (counters.copy(), windows.astype(np.float32),
                np.arange(n), np.iinfo(np.int32).max)
    cand = np.argpartition(counters[None], m, axis=1)[0, :m + 1]
    vals = counters[cand]
    order = np.argsort(vals, kind="stable")
    idx = cand[order[:m]]
    return (counters[idx].copy(), windows[idx].astype(np.float32), idx,
            int(vals[order[m]]))


def _pool_loop(exp, win, idx, threshold, k, key):
    """The event loop on one row's pool; returns (winners, invalid)."""
    m = len(exp)
    exp = exp.astype(np.int64)
    act = exp < BIG
    dbl = np.zeros(m, np.int64)
    winners, t, idle, ev = [], 0, 0, 0
    while len(winners) < k and act.any() and t < MAX_SIM_SLOTS:
        tau = int(np.where(act, exp, BIG).min())
        hit = act & (exp == tau)
        nexp = int(hit.sum())
        rand = redraw_uniform(key, ev, 0, m)
        ev += 1
        if tau >= threshold:
            return winners, True
        finish = t + (tau - idle) + TX_SLOTS
        if finish > MAX_SIM_SLOTS:
            break
        t, idle = finish, tau
        if nexp == 1:
            winners.append(int(idx[int(np.argmax(hit))]))
            act = act & ~hit
            continue
        nd = np.minimum(dbl + 1, MAX_DOUBLINGS)
        scaled = (rand * win) * np.exp2(nd).astype(np.float32)
        redraw = np.clip(np.round(scaled), 1.0, float(BIG)).astype(np.int64)
        exp = np.where(hit, np.minimum(tau + redraw, BIG), exp)
        dbl = np.where(hit, nd, dbl)
    return winners, False


def contend_device(backoff_s, window_s, k, participating, entropy, call):
    """Winners (delivery order) of one round under the device loop's
    semantics: ``entropy`` the strategy stream's 64 bits, ``call`` the
    number of earlier contention calls of the run."""
    backoff = np.asarray(backoff_s, np.float64) / SLOT_S
    windows = np.asarray(window_s, np.float64) / SLOT_S
    counters = np.minimum(np.maximum(0, np.round(backoff)), BIG
                          ).astype(np.int32)
    counters = np.where(participating, counters, np.int32(BIG))
    key = call_key(entropy, call)
    n = len(counters)
    m = min(n, max(128, 8 * k))
    while True:
        exp, win, idx, thr = _pool(counters, windows, m)
        winners, invalid = _pool_loop(exp, win, idx, thr, k, key)
        if m >= n or not invalid:
            return winners
        m = min(n, m * 8)
