"""The reference's two contention engines give the program's winners, in
delivery order, on the same backoffs and windows: the NumPy event loop
against ``CSMASimulator.contend_batch`` on the same strategy stream, and
the device loop's semantics against ``device_contend_batch`` on the CPU
(which draws the card's numbers), pool retries included."""
import numpy as np
import pytest


import tiny
from portbench.reference import csma, rngs


def _inputs(seed, U, scale, refrain=0.1):
    g = np.random.default_rng(seed)
    prio = 1.0 + g.random(U)
    windows = scale / prio
    backoff = g.uniform(0.0, 1.0, U) * windows
    part = g.random(U) >= refrain
    return backoff * csma.SLOT_S, windows * csma.SLOT_S, part


@pytest.mark.parametrize("U,k,scale", [(10, 2, 2048.0), (200, 16, 256.0),
                                       (2000, 64, 2048.0)])
def test_numpy_engine_matches_the_program(U, k, scale):
    from repro_torch.core.csma import CSMASimulator
    seed = 2 ** 31 + 99
    b, w, part = _inputs(seed, U, scale)
    sim = CSMASimulator(seed=rngs.child(seed, rngs.STRATEGY))
    got = sim.contend_batch(b[None], w[None], k_target=np.array([k]),
                            participating=part[None], rngs=[sim._rng])
    want = csma.contend_numpy(b, w, k, part, rngs.strategy_rng(seed))
    assert got.round_result(0).winners == want
    assert got.collisions[0] > 0 or U == 10


@pytest.mark.parametrize("U,k,scale,call", [(10, 2, 2048.0, 0),
                                            (2000, 64, 2048.0, 3),
                                            (3000, 64, 96.0, 1)])
def test_device_engine_matches_the_program(U, k, scale, call):
    from repro_torch.kernels import contention
    seed = 3 * 10 ** 9 + U
    b, w, part = _inputs(seed, U, scale)
    entropy = rngs.strategy_entropy(seed)
    contention.reset_loop_stats()
    with tiny.one_thread():
        got = contention.device_contend_batch(
            b[None] / csma.SLOT_S, w[None] / csma.SLOT_S, np.array([k]),
            part[None], entropy=entropy, call_index=call,
            tx_slots=csma.TX_SLOTS,
            max_backoff_doublings=csma.MAX_DOUBLINGS,
            max_sim_slots=csma.MAX_SIM_SLOTS, device="cpu")
    want = csma.contend_device(b, w, k, part, entropy, call)
    assert got.round_result(0).winners == want
    if scale < 100:          # dense collisions: the pool had to grow
        assert contention.LOOP["attempts"] > 1


def test_device_redraws_are_the_programs_counter_draws():
    import torch
    from repro_torch.kernels import contention
    key = contention.counter_key(123456789012345, 7)
    assert key == csma.call_key(123456789012345, 7)
    want = contention.counter_uniform(key, 5, 1, 300, "cpu")[0].numpy()
    np.testing.assert_array_equal(csma.redraw_uniform(key, 5, 0, 300), want)
    assert want.dtype == np.float32 and torch.is_tensor(
        contention.counter_uniform(key, 0, 1, 1, "cpu"))
