"""Checkpoint / resume in the port: the per-round ``"run"`` payload
(stacked rounds) and the sweep payload (``run_sweep``, and ``run`` on the
fused path, its E = 1 case) each resume bit-identically to the
uninterrupted run — fault and channel streams, objective m / v / h and a
bf16 model's dtypes included — and a changed spec or a payload of the
other kind is refused (the scenarios of tests/test_faults.py:412-470 and
tests/test_objectives.py:385-440, on the port). The ``.npz`` parameter
writer makes the reference writer's keys and bytes, and each package
loads the other's files."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.channel import ChannelSpec
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.engine import ExperimentSpec, SweepSpec, build_host_engine
from repro_torch.faults import FaultSpec
from repro_torch.objectives import ObjectiveSpec
from torch_port_util import bits, bitwise_equal, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, N_PER, DIM = 8, 32, 6


def make_data():
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(N_PER, DIM)).astype(np.float32),
             "y": rng.integers(0, 2, size=(N_PER,)).astype(np.int32)}
            for _ in range(U)]


DATA = make_data()


def loss_fn(params, batch):
    logits = batch["x"].to(params["w"].dtype) @ params["w"] + params["b"]
    return ((logits.float() - batch["y"]) ** 2).mean()


def init_params(dtype="float32"):
    rng = np.random.default_rng(0)
    return to_torch({"w": rng.normal(size=(DIM,)).astype(np.float32) * 0.1,
                     "b": np.zeros((), np.float32)}, dtype)


def make_spec(rounds=6, strategy="priority-distributed", seed=7, **kw):
    return ExperimentSpec(strategy=strategy, rounds=rounds, k_per_round=3,
                          seed=seed, **kw)


def engine(spec, dtype="float32", **kw):
    return build_host_engine(spec, init_params(dtype), loss_fn, DATA,
                             device="cpu", **kw)


ACTIVE = FaultSpec(crash_prob=0.2, straggle_prob=0.3, corrupt_prob=0.2,
                   outage_prob=0.2, max_retries=1, clip_norm=2.0)
CHANNEL = ChannelSpec(per_model="waterfall")
FEDDYN_ADAM = ObjectiveSpec(local="feddyn", alpha=0.1, aggregator="fedadam",
                            server_lr=0.1)


def hist_equal(a, b):
    return (a.winners == b.winners and a.delivered == b.delivered
            and np.array_equal(a.selections, b.selections)
            and a.round_seconds == b.round_seconds
            and a.train_loss == b.train_loss
            and a.retries == b.retries
            and a.stale_merges == b.stale_merges
            and a.quarantined_updates == b.quarantined_updates)


def test_run_checkpoint_resume_bit_identical(tmp_path):
    """Per-round path (stacked rounds, the "run" payload): the run that
    wrote checkpoints and a FRESH engine resuming from the last one both
    match the uninterrupted run bit for bit."""
    spec = make_spec(faults=ACTIVE, channel=CHANNEL)
    ref = engine(spec, round_mode="stacked")
    h_ref = ref.run()
    e1 = engine(spec, round_mode="stacked")
    assert not e1._delegates()
    h1 = e1.run(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert hist_equal(h_ref, h1)
    e2 = engine(spec, round_mode="stacked")
    h2 = e2.run(checkpoint_dir=str(tmp_path))
    assert hist_equal(h_ref, h2)
    assert bitwise_equal(ref.global_params, e2.global_params)
    assert sum(h_ref.winners, []) and h_ref.stale_merges > 0


def test_sweep_checkpoint_resume_bit_identical(tmp_path):
    """Sweep path: E = 3 lanes with channel + active faults, resumed from
    the mid-run checkpoint, match the uninterrupted sweep lane for
    lane."""
    sw = SweepSpec(specs=[
        make_spec(seed=7, faults=ACTIVE, channel=CHANNEL),
        make_spec(seed=8, faults=ACTIVE, channel=CHANNEL),
        make_spec(seed=9, strategy="random-distributed", faults=ACTIVE)])
    r_ref = engine(sw.specs[0]).run_sweep(sw)
    r1 = engine(sw.specs[0]).run_sweep(sw, checkpoint_dir=str(tmp_path),
                                       checkpoint_every=2)
    r2 = engine(sw.specs[0]).run_sweep(sw, checkpoint_dir=str(tmp_path))
    for ha, hb, hc in zip(r_ref, r1, r2):
        assert hist_equal(ha, hb) and hist_equal(ha, hc)
    assert bitwise_equal(r_ref.final_globals, r2.final_globals)


def test_resume_rejects_spec_mismatch(tmp_path):
    spec = make_spec(rounds=4, faults=FaultSpec())
    engine(spec, round_mode="stacked").run(checkpoint_dir=str(tmp_path),
                                           checkpoint_every=2)
    other = make_spec(rounds=4, faults=FaultSpec(), seed=99)
    with pytest.raises(ValueError, match="different experiment"):
        engine(other, round_mode="stacked").run(
            checkpoint_dir=str(tmp_path))


def test_resume_rejects_the_other_payload_kind(tmp_path):
    """The fused ``run`` writes the sweep payload, the stacked one the
    "run" payload; neither resumes from the other's."""
    spec = make_spec(rounds=4)
    fused, stacked = tmp_path / "fused", tmp_path / "stacked"
    engine(spec).run(checkpoint_dir=str(fused), checkpoint_every=2)
    engine(spec, round_mode="stacked").run(checkpoint_dir=str(stacked),
                                           checkpoint_every=2)
    with pytest.raises(ValueError, match="sweep path"):
        engine(spec, round_mode="stacked").run(checkpoint_dir=str(fused))
    with pytest.raises(ValueError, match="per-round path"):
        engine(spec).run(checkpoint_dir=str(stacked))


def test_run_checkpoint_resume_objective_state(tmp_path):
    """The fused run (the E = 1 sweep): m / v / h ride the sweep payload
    and a fresh engine resumes bit-identically, the backend's objective
    state included."""
    spec = make_spec(objective=FEDDYN_ADAM)
    ref = engine(spec)
    h_ref = ref.run()
    engine(spec).run(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    e2 = engine(spec)
    h2 = e2.run(checkpoint_dir=str(tmp_path))
    assert h2.winners == h_ref.winners
    assert bitwise_equal(ref.global_params, e2.global_params)
    a, b = ref.backend.objective_state(), e2.backend.objective_state()
    for key in ("m", "v", "h"):
        for x, y in zip(jax.tree.leaves(a[key]), jax.tree.leaves(b[key])):
            assert np.array_equal(x, y), key


def test_sweep_checkpoint_resume_objective_state(tmp_path):
    specs = [make_spec(seed=7),
             make_spec(seed=8, objective=ObjectiveSpec(local="fedprox",
                                                       mu=0.1)),
             make_spec(seed=9, objective=ObjectiveSpec(
                 local="feddyn", alpha=0.1, aggregator="fedavgm",
                 server_lr=0.5))]
    sw = SweepSpec(specs=specs)
    r_ref = engine(specs[0]).run_sweep(sw)
    engine(specs[0]).run_sweep(sw, checkpoint_dir=str(tmp_path),
                               checkpoint_every=2)
    r2 = engine(specs[0]).run_sweep(sw, checkpoint_dir=str(tmp_path))
    for ha, hb in zip(r_ref, r2):
        assert ha.winners == hb.winners and ha.train_loss == hb.train_loss
    assert bitwise_equal(r_ref.final_globals, r2.final_globals)


def test_resume_rejects_objective_change(tmp_path):
    spec = make_spec(rounds=4, objective=ObjectiveSpec(local="fedprox",
                                                       mu=0.1))
    engine(spec).run(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    other = make_spec(rounds=4, objective=ObjectiveSpec(local="fedprox",
                                                        mu=0.2))
    with pytest.raises(ValueError, match="different"):
        engine(other).run(checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("path", ["sweep", "run"])
def test_bf16_model_resumes_in_its_dtypes(tmp_path, path):
    """A bf16 model: the payload widens its leaves to f32 (numpy has no
    bfloat16); the resumed globals — and on the fused path m / v / h —
    come back bf16, bit-equal to the uninterrupted run."""
    if path == "sweep":
        spec, kw = make_spec(objective=FEDDYN_ADAM), {}
    else:
        spec, kw = make_spec(faults=ACTIVE, channel=CHANNEL), dict(
            round_mode="stacked")
    ref = engine(spec, "bfloat16", **kw)
    h_ref = ref.run()
    engine(spec, "bfloat16", **kw).run(checkpoint_dir=str(tmp_path),
                                       checkpoint_every=2)
    e2 = engine(spec, "bfloat16", **kw)
    h2 = e2.run(checkpoint_dir=str(tmp_path))
    assert h2.winners == h_ref.winners
    for a, b in zip(jax.tree.leaves(ref.global_params),
                    jax.tree.leaves(e2.global_params)):
        assert b.dtype == torch.bfloat16
        assert np.array_equal(bits(a), bits(b))
    if path == "sweep":
        be = e2.backend
        for x in (be._obj_m, be._obj_v, be._obj_h):
            assert {l.dtype for l in jax.tree.leaves(x)} == {torch.bfloat16}


TREE = {"fc1.w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
        "fc1.b": np.linspace(-1, 1, 4).astype(np.float32),
        "head": {"w": np.full((2, 2), 1.5, np.float32),
                 "scale": np.float32(0.25)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_keys_and_bytes_match_the_reference_writer(tmp_path, dtype):
    port, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_checkpoint(str(port), to_torch(TREE, dtype))
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32), TREE)
    j_save(str(ref), jt)
    with np.load(port) as p, np.load(ref) as r:
        assert sorted(p.files) == sorted(r.files) == [
            "fc1b", "fc1w", "head/scale", "head/w"]
        for k in p.files:
            assert p[k].dtype.str == r[k].dtype.str
            assert p[k].shape == r[k].shape
            assert p[k].tobytes() == r[k].tobytes(), k


def test_npz_loads_in_both_directions(tmp_path):
    """The reference reads the port's file and the port the reference's
    (a bf16 file too, whose ``<V2`` arrays the reference's own loader
    cannot cast)."""
    port, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_checkpoint(str(port), to_torch(TREE), extra={"round": 3})
    j_tmpl = jax.tree.map(jnp.zeros_like, TREE)
    got = j_load(str(port), j_tmpl)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(TREE)):
        np.testing.assert_array_equal(np.asarray(a), b)
    j_save(str(ref), jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.bfloat16), TREE))
    t_tmpl = to_torch(jax.tree.map(np.zeros_like, TREE), "bfloat16")
    back = load_checkpoint(str(ref), t_tmpl)
    want = to_torch(TREE, "bfloat16")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    from repro_torch.checkpoint.checkpoint import load_extra
    assert int(load_extra(str(port))["round"]) == 3


def _kill_resume_tool(scenario):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "kill_resume_smoke_torch.py"),
         "--device", "cpu", "--scenario", scenario],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"OK[{scenario}]" in out.stdout


def test_kill_resume_tool_on_the_cpu():
    """``tools/kill_resume_smoke_torch.py``: a child SIGTERMed after its
    first checkpoint, resumed, bit-identical to the uninterrupted run."""
    _kill_resume_tool("objectives")


def test_kill_resume_tool_stale_sparse_on_the_cpu():
    """The tool's winner-sparse scenario: a stale-priority run killed and
    resumed bit for bit, its checkpoint carrying the priority cache."""
    _kill_resume_tool("stale-sparse")
