"""The cohort split of ``HostBackend(mesh=...)`` on the CPU: the
reference's unsplit cases (``tests/test_fused_round.py``: a 1-device
mesh, a cohort the axis does not divide, a mesh without a cohort axis)
and a 2-way ``[cpu, cpu]`` split of the fused, sparse and sweep paths
(the sweep split over its lanes and over its users), with the
objective, fault and AirComp merges, and a kill-and-resume under the
mesh. A row's result does not depend on the rows beside it, so every
split run must equal the unsplit run bit for bit: winners, every
history count, losses, priorities and globals. The pin scenario (8
users, a 16 -> 4 linear model) keeps it cheap.
"""
import numpy as np
import pytest
import torch

from repro_torch import engine as teng
from repro_torch.device import Mesh
from repro_torch.engine import FLHistory
from repro_torch.engine import backends as tb
from repro_torch.faults import FaultSpec
from repro_torch.sharding import cohort_mesh, shardable
from torch_port_util import (HISTORY_COUNTS, LOSSY, PIN_USERS, bitwise_equal,
                             pin_torch_engine)

SPEC = dict(rounds=5, seed=0, strategy="priority-distributed")
FEDDYN = teng.ObjectiveSpec(local="feddyn", alpha=0.01, aggregator="fedavgm")
FAULTS = FaultSpec(crash_prob=0.1, straggle_prob=0.2, corrupt_prob=0.1,
                   outage_prob=0.1, max_retries=2, clip_norm=2.0)
AIR = teng.ChannelSpec(fading="rayleigh", aircomp_gain_floor=0.3,
                       aircomp_sigma=0.05)


def two_way():
    return cohort_mesh(["cpu", "cpu"])


def round_loop(eng):
    """The per-round loop (``FLEngine.run_round``): the fused path's own
    train and merge, not the E = 1 sweep ``run`` delegates to."""
    hist = FLHistory(selections=np.zeros(eng.num_users, np.int64))
    for t in range(eng.spec.rounds):
        eng.run_round(t, hist)
    return hist


def assert_same(a, b):
    for name in HISTORY_COUNTS + ("train_loss", "priorities"):
        assert getattr(a, name) == getattr(b, name), name
    assert np.array_equal(a.selections, b.selections)


def test_one_device_mesh_parity():
    """A 1-long cohort mesh is a bit-exact no-op against no mesh: the
    reference's predicate says shardable, and nothing splits."""
    mesh = cohort_mesh(["cpu"])
    assert shardable(PIN_USERS, mesh)
    e_mesh = pin_torch_engine(SPEC, mesh=mesh)
    assert e_mesh.backend._shard and e_mesh.backend._devs is None
    e_none = pin_torch_engine(SPEC)
    assert_same(e_mesh.run(), e_none.run())
    assert bitwise_equal(e_mesh.global_params, e_none.global_params)


class _FakeMesh:
    """The reference test's mesh stand-in: a 3-long cohort axis and no
    devices, enough surface for the divisibility guard."""
    shape = {"cohort": 3}
    size = 3


@pytest.mark.parametrize("mesh", [_FakeMesh(), cohort_mesh(["cpu"] * 3)],
                         ids=["duck", "cpu3"])
def test_non_divisible_cohort_skips_sharding(mesh):
    """8 users over a 3-long axis: the unsplit path, identical results,
    and the data not spread over the mesh."""
    assert not shardable(PIN_USERS, mesh) and not shardable(3, None)
    spec = dict(SPEC, rounds=3)
    eng = pin_torch_engine(spec, mesh=mesh)
    assert eng.backend._shard is False and not eng.backend._split_fused
    assert_same(eng.run(), pin_torch_engine(spec).run())
    # the user data stays one stack on the backend's device
    assert eng.backend._xsplit is None and eng.backend._xstack is not None


def test_mesh_without_cohort_axis_falls_back():
    """A reused mesh whose axis is not named 'cohort' runs unsplit."""
    mesh = Mesh(["cpu", "cpu"], ("data",))
    assert not shardable(PIN_USERS, mesh)
    eng = pin_torch_engine(SPEC, mesh=mesh)
    assert eng.backend._shard is False
    tr = eng.backend.train_round(eng.state, 0, list(range(PIN_USERS)), False)
    assert not isinstance(tr.local_handle["fused_stack"], tb._Split)


def _sweep(kw, lanes):
    return [teng.ExperimentSpec(**dict(SPEC, seed=s, **kw))
            for s in range(lanes)]


CASES = {
    # run(): the E = 1 sweep, split over its users
    "fused_run": (dict(), {}, "run"),
    # the per-round loop: the fused path's own split
    "fused_run_round": (dict(), {}, "loop"),
    # the compact (K_max, ...) winner stack, 2 rows a chunk; the prepass
    # reads data rows of both chunks
    "sparse": (dict(k_per_round=2), dict(round_mode="sparse"), "loop"),
    "sweep_over_lanes": (dict(), {}, 2),
    "sweep_over_users": (dict(), {}, 3),
    "objective_run": (dict(objective=FEDDYN,
                           channel=teng.ChannelSpec(**LOSSY)), {}, "run"),
    "objective_sweep_over_lanes": (dict(objective=FEDDYN,
                                        channel=teng.ChannelSpec(**LOSSY)),
                                   {}, 2),
    "objective_run_round": (dict(objective=FEDDYN,
                                 channel=teng.ChannelSpec(**LOSSY)), {},
                            "loop"),
    "faults_run_round": (dict(faults=FAULTS,
                              channel=teng.ChannelSpec(**LOSSY)), {}, "loop"),
    "aircomp_run": (dict(merge_backend="aircomp", channel=AIR), {}, "run"),
}


def counting_chunks(monkeypatch):
    """Count the chunk trainings (``_train_rows`` / ``_train_lanes``
    calls) and the devices each chunk's work was entered on (``_on``)."""
    calls = {"chunks": 0, "devices": []}
    for name in ("_train_rows", "_train_lanes"):
        orig = getattr(tb.HostBackend, name)

        def spy(self, *a, _orig=orig, **k):
            calls["chunks"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(tb.HostBackend, name, spy)
    on = tb._on

    def on_spy(dev):
        calls["devices"].append(dev)
        return on(dev)
    monkeypatch.setattr(tb, "_on", on_spy)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_way_split_is_bit_equal(case, monkeypatch):
    """A 2-way ``[cpu, cpu]`` split against no mesh: winners, every
    history count, losses, priorities and globals bit for bit, and the
    split path really taken (one more chunk trained every round)."""
    kw, ekw, drive = CASES[case]
    calls = counting_chunks(monkeypatch)
    spec = dict(SPEC, **kw)
    plain = pin_torch_engine(spec, **ekw)
    split = pin_torch_engine(spec, mesh=two_way(), **ekw)
    counted = []
    for eng in (plain, split):
        calls["chunks"] = 0
        if isinstance(drive, int):
            cells = _sweep(kw, drive)
            out = eng.run_sweep(cells)
        else:
            out = eng.run() if drive == "run" else round_loop(eng)
        counted.append(calls["chunks"])
        if eng is plain:
            want = out
    if isinstance(drive, int):
        for ha, hb in zip(want, out):
            assert_same(ha, hb)
        assert bitwise_equal(want.final_globals, out.final_globals)
    else:
        assert_same(want, out)
        assert bitwise_equal(plain.global_params, split.global_params)
    assert counted[1] >= counted[0] + SPEC["rounds"]


def test_each_chunk_runs_on_its_device(monkeypatch):
    """Every chunk's training, Eq. 2 and restack run with the chunk's
    device entered (``_on``): a CUDA device is made current, since a
    kernel wrapper launches on the current device only."""
    calls = counting_chunks(monkeypatch)
    eng = pin_torch_engine(dict(SPEC, rounds=2), mesh=two_way())
    round_loop(eng)
    # a round: two chunks trained, two restacked
    assert len(calls["devices"]) == 2 * 2 * 2
    assert {str(d) for d in calls["devices"]} == {"cpu"}
    guard = tb._on(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1


def test_split_run_resumes_bit_equal(tmp_path):
    """A run checkpointed under the 2-way mesh resumes bit-equal to the
    unkilled unsplit run, with the mesh and without it (the payload
    holds whole globals and streams); the same for a 2-lane sweep."""
    spec = dict(SPEC, rounds=6)
    want = pin_torch_engine(spec)
    h_want = want.run()
    first = pin_torch_engine(spec, mesh=two_way())
    assert_same(first.run(checkpoint_dir=str(tmp_path / "a"),
                          checkpoint_every=2), h_want)
    for mesh in (two_way(), None):
        again = pin_torch_engine(spec, mesh=mesh)
        assert_same(again.run(checkpoint_dir=str(tmp_path / "a")), h_want)
        assert bitwise_equal(again.global_params, want.global_params)
    cells = _sweep({}, 2)
    r_want = pin_torch_engine(spec).run_sweep(cells)
    pin_torch_engine(spec, mesh=two_way()).run_sweep(
        cells, checkpoint_dir=str(tmp_path / "b"), checkpoint_every=2)
    r_got = pin_torch_engine(spec, mesh=two_way()).run_sweep(
        cells, checkpoint_dir=str(tmp_path / "b"))
    for ha, hb in zip(r_want, r_got):
        assert_same(ha, hb)
    assert bitwise_equal(r_want.final_globals, r_got.final_globals)


def test_shape_only_mesh_refuses_a_split():
    """A split needs devices: a shape-only mesh that would split the
    cohort raises instead of running unsplit."""
    with pytest.raises(ValueError, match="shape-only"):
        pin_torch_engine(SPEC, mesh=Mesh(None, ("cohort",), shape=(2,)))
