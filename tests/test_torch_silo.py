"""The port's cross-silo path (``repro_torch.core.silo``,
``repro_torch.engine.SiloBackend``) against the JAX package's, on the
CPU: the reduced phi3-mini-3.8b (the arch of the reference's demo and
tests), the JAX package's own params carried across with
``convert.params_from_numpy``, the same numpy tokens on both sides.

Bars: ``TOL`` (rtol 1e-5, atol 1e-6) for losses, priorities and merged
params against JAX; every history count of an engine run exact; the
bf16 merge (``merge_dtype="bfloat16"``) within 0.02 of the f32 merge and
within 1e-2 of the f32 merge's own update (its largest move off the
global). Within the port, bit for bit: a zero-weight merge (the global
itself). The replicas after a merge are one merged tensor expanded over
the silo axis (stride 0), equal by construction: that structure is what
is checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import silo as jsilo
from repro.core.priority import layer_distance_ratios as j_ratios
from repro.core.priority import model_priority as j_model_priority
from repro.data import make_token_stream
from repro.engine import ExperimentSpec as JSpec
from repro.engine import FLEngine as JEngine
from repro.engine import SiloBackend as JSilo
from repro.models.model import init_params as j_init
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import silo as tsilo
from repro_torch.core.priority import layer_distance_ratios, \
    model_priority, stacked_model_priorities
from repro_torch.engine import ExperimentSpec, FLEngine, SiloBackend
from repro_torch.engine.backends import SiloBackend as BackendsSilo
from repro_torch.tree import tree_leaves, tree_map
from torch_port_util import HISTORY_COUNTS

ARCH = "phi3-mini-3.8b"
TOL = dict(rtol=1e-5, atol=1e-6)
N_SILOS, B, SEQ = 2, 2, 16


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def trees_close(a, b, **tol):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(f32(x), f32(y), **(tol or TOL))


def replicas_equal(stacked):
    return all(torch.equal(p, p[:1].expand_as(p))
               for p in tree_leaves(stacked))


def expanded_over_silos(stacked):
    """Every leaf one tensor expanded over the silo axis (stride 0)."""
    return all(p.stride(0) == 0 for p in tree_leaves(stacked))


@pytest.fixture(scope="module")
def setup():
    """tests/test_silo.py's setup, in both packages."""
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (N_SILOS, B, SEQ + 1), 0, jc.vocab_size),
        np.int32)
    return (jc, jp, {"tokens": jnp.asarray(toks)}, tc, tp,
            {"tokens": torch.from_numpy(toks)})


def rounds(setup, alphas, **kw):
    jc, jp, jb, tc, tp, tb = setup
    jr = jax.jit(jsilo.make_fl_round_step(jc, lr=1e-2, **kw))(
        jsilo.stack_for_silos(jp, N_SILOS), jb, jnp.asarray(alphas))
    tr = tsilo.make_fl_round_step(tc, lr=1e-2, **kw)(
        tsilo.stack_for_silos(tp, N_SILOS), tb,
        torch.tensor(alphas, dtype=torch.float32))
    return jr, tr


def test_fl_round_runs_and_merges(setup):
    """Per-silo losses (S,), priorities >= 1 and the merged stack
    against JAX's; the merged stack one tensor expanded over the silos;
    the state handed in is left as it was."""
    tp = setup[4]
    kept = [p.clone() for p in tree_leaves(tp)]
    (jl, js, jpr), (tl, ts, tpr) = rounds(setup, [1.0, 0.0])
    assert tl.shape == (N_SILOS,) and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tpr.shape == (N_SILOS,) and (tpr >= 1.0).all()
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), **TOL)
    trees_close(ts, js)
    assert expanded_over_silos(ts)
    for p, k in zip(tree_leaves(tp), kept):
        assert torch.equal(p, k)


def test_fl_round_selection_gating(setup):
    """Another selected silo (other local data) gives another merge; all
    weights zero keep the global: bit for bit in the port, as JAX's
    within its own test's bar; ``do_merge=False`` hands back the trained
    locals, their losses and priorities those of the merged round."""
    (_, j0, _), (tl, t0, tpr) = rounds(setup, [1.0, 0.0])
    (_, j1, _), (_, t1, _) = rounds(setup, [0.0, 1.0])
    trees_close(t1, j1)
    assert max(float((a[0] - b[0]).abs().max()) for a, b in zip(
        tree_leaves(t0), tree_leaves(t1))) > 0
    (_, jn, _), (_, tn, _) = rounds(setup, [0.0, 0.0])
    stacked = tsilo.stack_for_silos(setup[4], N_SILOS)
    for a, b in zip(tree_leaves(tn), tree_leaves(stacked)):
        assert torch.equal(a, b)
    trees_close(tn, jn, rtol=2e-2, atol=1e-4)
    (_, jloc, _), (tl2, tloc, tpr2) = rounds(setup, [1.0, 0.0],
                                            do_merge=False)
    trees_close(tloc, jloc)
    assert torch.equal(tl2, tl) and torch.equal(tpr2, tpr)
    assert not expanded_over_silos(tloc) and not replicas_equal(tloc)


def test_stacked_delta_norm_matches_reference(setup):
    """Eq. 2 over a silo stack: row 0 (moved by 0.01) against
    ``model_priority`` in both packages, row 1 (the global) 1.0."""
    jc, jp, _, tc, tp, _ = setup
    local = tree_map(lambda p: p + 0.01, tp)
    stacked = tree_map(lambda a, b: torch.stack([a, b]), local, tp)
    prios = stacked_model_priorities(stacked, tp)
    np.testing.assert_allclose(float(prios[0]),
                               float(model_priority(local, tp)), rtol=1e-6)
    # tests/test_silo.py's own bar for this product of 12 ratios: the
    # reference's side drifts ~1e-5 off the exact sums (a reference fault,
    # test_eq2_product_is_nearer_the_f64_sums_than_the_reference's)
    np.testing.assert_allclose(float(prios[0]), float(j_model_priority(
        jax.tree.map(lambda p: p + 0.01, jp), jp)), rtol=1e-4)
    assert float(prios[1]) == 1.0
    assert tsilo.silo_batch_struct(tc, 3, 4, 8)["tokens"].shape == \
        jsilo.silo_batch_struct(jc, 3, 4, 8)["tokens"].shape


def test_eq2_product_is_nearer_the_f64_sums_than_the_reference(setup):
    """Every leaf of the reduced phi3-mini moved by 0.01: the port's
    per-leaf ratios and Eq. 2 product (``model_priority``, row 0 of
    ``stacked_model_priorities``) within rtol 1e-6 of the same ratios
    from float64 sums of the same f32 deltas. The reference's product
    lands further off: on the CPU its ``delta_norm`` is a plain
    ``jnp.sum`` of f32 squares (``repro/kernels/ref.py::delta_norm_ref``),
    which drifts ~1e-5 over a 1.3e5-element leaf under XLA's CPU
    reduction (ROADMAP, reference faults). Should the reference ever come
    nearer than the port, this fails and the record is to be revised."""
    _, jp, _, _, tp, _ = setup
    local = tree_map(lambda p: p + 0.01, tp)
    exact = []
    for wl, wg in zip(tree_leaves(local), tree_leaves(tp)):
        d = (wl - wg).double()                 # the f32 delta, summed in f64
        g = wg.double()
        r = float(torch.sqrt((d * d).sum())
                  / torch.sqrt((g * g).sum()).clamp(min=1e-12))
        exact.append(min(r, 1.0))
    prod = float(np.prod([1.0 + r for r in exact]))
    got = [float(r) for r in layer_distance_ratios(local, tp)]
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    stacked = tree_map(lambda a, b: torch.stack([a, b]), local, tp)
    port = [float(model_priority(local, tp)),
            float(stacked_model_priorities(stacked, tp)[0])]
    np.testing.assert_allclose(port, [prod, prod], rtol=1e-6)
    jlocal = jax.tree.map(lambda p: p + 0.01, jp)
    jprod = float(j_model_priority(jlocal, jp))
    jgot = [float(r) for r in j_ratios(jlocal, jp)]
    port_off = max(abs(p / prod - 1) for p in port)
    assert abs(jprod / prod - 1) > port_off
    assert max(abs(a / b - 1) for a, b in zip(jgot, exact)) > \
        max(abs(a / b - 1) for a, b in zip(got, exact))


def engine_pair(merge_dtype="float32", rounds=2):
    """tests/test_engine.py's silo run (2 silos of ``make_token_stream``,
    batch 2, priority-distributed, k = 1) in both packages from the JAX
    params; the port's merges spied on: whether each merged stack is
    one tensor expanded over the silos."""
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    data = make_token_stream(2, 16, 8, jc.vocab_size, seed=0)
    jp = j_init(jax.random.PRNGKey(0), jc)
    kw = dict(rounds=rounds, k_per_round=1, strategy="priority-distributed",
              counter_threshold=0.9, seed=0)
    je = JEngine(JSpec(**kw), JSilo(jc, data, lr=1e-2, batch_size=2,
                                    merge_dtype=merge_dtype), jp)
    te = FLEngine(ExperimentSpec(**kw), SiloBackend(
        tc, data, lr=1e-2, batch_size=2, merge_dtype=merge_dtype,
        device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    merged = []
    inner = te.backend.merge

    def spy(state, tr, winners, **k):
        out = inner(state, tr, winners, **k)
        merged.append(expanded_over_silos(out))
        return out
    te.backend.merge = spy
    return je, te, merged


def test_silo_backend_runs_through_engine_like_the_reference():
    """``FLEngine.run`` over ``SiloBackend``: every history count, the
    selections, losses and priorities of the reference's run; the
    global within TOL; every merged stack one expanded tensor."""
    je, te, merged = engine_pair()
    jh, th = je.run(), te.run()
    for name in HISTORY_COUNTS:
        assert getattr(th, name) == getattr(jh, name), name
    assert np.array_equal(th.selections, jh.selections)
    assert th.uploads_total >= 1 and len(th.winners) == 2
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(th.priorities),
                               np.asarray(jh.priorities), rtol=1e-5)
    trees_close(te.state, je.state)
    trees_close(te.global_params, je.global_params)
    assert merged and all(merged) and expanded_over_silos(te.state)


def test_silo_bf16_merge_within_the_bf16_bar():
    """``merge_dtype="bfloat16"`` (deltas shipped in bf16, the update
    added in f32): within 0.02 of the f32 merge, and of JAX's bf16
    merge, on one trained round, and within 1e-2 of the f32 merge's
    update (a merge that dropped the update or took another silo's
    would miss it by about the update); the merged stack still one
    expanded tensor."""
    je, te, merged = engine_pair("bfloat16", rounds=1)
    _, t32, _ = engine_pair("float32", rounds=1)
    start = [p.clone() for p in tree_leaves(t32.global_params)]
    jh, th = je.run(), te.run()
    t32.run()
    assert th.winners == jh.winners and th.uploads_total == 1
    trees_close(te.global_params, t32.global_params, rtol=0, atol=0.02)
    trees_close(te.global_params, je.global_params, rtol=0, atol=0.02)
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(te.global_params), tree_leaves(t32.global_params)))
    update = max(float((b - w).abs().max()) for b, w in zip(
        tree_leaves(t32.global_params), start))
    assert update > 0 and gap <= 1e-2 * update
    assert merged and all(merged)
    # the merge itself, the deltas in bf16 against f32, on one stack
    stack = tree_map(lambda p: p + 0.01 * torch.sin(torch.arange(
        p.numel(), dtype=torch.float32).reshape(p.shape)),
        t32.state)
    glob = t32.global_params
    a = torch.tensor([0.25, 0.75])
    m16 = tsilo.make_silo_merge("bfloat16")(stack, glob, a)
    m32 = tsilo.make_silo_merge("float32")(stack, glob, a)
    for x, y, w in zip(tree_leaves(m16), tree_leaves(m32),
                       tree_leaves(glob)):
        assert x.dtype == y.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=0.02)
        update = float((y[0] - w).abs().max())
        assert update > 0
        assert float((x - y).abs().max()) <= 1e-2 * update


def test_silo_backend_rejects_aircomp():
    """tests/test_channel.py's case: AirComp needs HostBackend."""
    class _Dummy(SiloBackend):
        def __init__(self):     # skip silo construction
            self.num_users = 2

    with pytest.raises(ValueError, match="aircomp"):
        _Dummy().merge(None, None, [0], merge_ctx=object())


def test_silo_backend_rejects_fault_ctx():
    """tests/test_faults.py's case: the robust guard needs HostBackend."""
    backend = object.__new__(BackendsSilo)     # merge() needs no state
    with pytest.raises(ValueError, match="robust merge guard"):
        BackendsSilo.merge(backend, None, None, [], fault_ctx=object())


def test_silo_backend_refuses_the_sweep_and_builds_its_batches():
    """No sweep on the silo path (the engine refuses it as the
    reference's does); a round's batch is each silo's rows t*B..(t+1)*B
    mod its length, as in the reference."""
    from repro.engine import SweepSpec as JSweep
    from repro_torch.engine import SweepSpec
    je, te, _ = engine_pair()
    with pytest.raises(ValueError, match="sweep"):
        je.run_sweep(JSweep.grid(je.spec, seed=range(2)))
    with pytest.raises(ValueError, match="sweep"):
        te.run_sweep(SweepSpec.grid(te.spec, seed=range(2)))
    for t in (0, 3, 5):
        got = te.backend._round_batch(t)["tokens"].numpy()
        want = np.asarray(je.backend._round_batch(t)["tokens"])
        assert np.array_equal(got, want)


def test_demo_twin_runs_on_the_cpu(capsys):
    """``examples/silo_round_demo_torch.py --device cpu``: a round line
    each, with one winner, and the selection counts."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "silo_round_demo_torch.py")
    spec = importlib.util.spec_from_file_location("silo_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main(["--device", "cpu", "--rounds", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["round 0", "round 1"]
    assert all("winner [" in ln for ln in lines[:2])
    assert lines[2].startswith("selection counts:")
    assert sum(eval(lines[2].split(":")[1])) == 2
