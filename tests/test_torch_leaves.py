"""The port's leaf-list kernel ops against the JAX package, on the CPU.

``ops.delta_norm_leaves`` (Eq. 2's reduction for every leaf of a model
in one call) and ``ops.server_opt_leaves`` (the objectives layer's server
step for every leaf of the global in one call) take the plain version on
a CPU tensor; here they are held against the reference leaf by leaf:
``jax.vmap(ref.delta_norm_ref)`` at ``rtol=1e-5`` (the two sum the
squares in different orders), and ``ref.server_opt_combine_ref`` and the
Pallas kernel in interpret mode at the bars of ``tests/test_kernels.py``
(f32 ``rtol=1e-5, atol=1e-6``; bf16 ``atol=0.02``, one ulp of the output
type), the inert passthrough bitwise. Inputs are made with numpy from a
seed on the paper MLP's and CNN's leaf shapes and on a ragged list. The
callers that now make one call where they looped over leaves
(``stacked_model_priorities``, ``row_delta_normsq``, the objective
merge) give the bits of the per-leaf route.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.core import priority as tprio
from repro_torch.faults.robust import row_delta_normsq
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.objectives import ObjectiveSpec

from torch_port_util import arr_j, arr_t, bits, f32, run_port

DTYPES = ["float32", "bfloat16"]
#: the global's leaves (tree order) of the paper's MLP and CNN
#: (models/paper_models.py), and sizes that are no multiple of 4 or 8,
#: below 4, one past a warp's span and past one chunk
LEAF_LISTS = {
    "mlp": [(200,), (784, 200), (10,), (200, 10)],
    "cnn": [(128,), (5, 5, 1, 128), (256,), (5, 5, 128, 256), (10,),
            (12544, 10)],
    "ragged": [(1,), (3,), (7,), (2, 5), (513,), (4097,), (3, 129, 5),
               (8,)],
}
#: the reduced yi-9b's leaves (tree order; an --arch round's list)
LLM_LEAVES = [(2, 256, 4, 64), (2, 4, 64, 256), (2, 256, 4, 64),
              (2, 256, 4, 64), (2, 256), (2, 256), (2, 512, 256),
              (2, 256, 512), (2, 256, 512), (512, 256), (256,), (256, 512)]
#: more leaves than one launch takes on the card
MANY = [(k % 7 + 1, 33 * (k % 5) + 8) for k in range(40)]
#: [kind, beta1, beta2, server_lr, eps] — identity, FedAvgM, FedAdam
KINDS = {
    "identity": np.asarray([0, 0.0, 0.0, 1.0, 1e-3], np.float32),
    "momentum": np.asarray([1, 0.9, 0.0, 0.5, 1e-3], np.float32),
    "adam": np.asarray([2, 0.9, 0.99, 0.1, 1e-3], np.float32),
}


def _atol(dtype):
    return 1e-6 if dtype == "float32" else 0.02


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _cohort(shapes, U, seed):
    """(U, ...) stacks and their globals, one pair a leaf, as numpy."""
    return ([_normal(seed + 2 * i, (U,) + s) for i, s in enumerate(shapes)],
            [_normal(seed + 2 * i + 1, s) for i, s in enumerate(shapes)])


def _opt_leaves(shapes, seed):
    """(avg, old, m, v) a leaf, v >= 0, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a, o, m, v = (rng.normal(size=s).astype(np.float32)
                      for _ in range(4))
        out.append((a, o, m, np.abs(v)))
    return out


# ------------------------------------------------------ delta_norm_leaves
def _delta_norm_case(leaves, dtype):
    shapes = MANY if leaves == "many" else LEAF_LISTS[leaves]
    U = 2 if leaves == "cnn" else 3
    stacks, globs = _cohort(shapes, U, seed=11)
    d2, g2 = tops.delta_norm_leaves([arr_t(s, dtype) for s in stacks],
                                    [arr_t(g, dtype) for g in globs])
    assert d2.shape == (len(shapes), U) and g2.shape == (len(shapes),)
    assert d2.dtype == g2.dtype == torch.float32
    return stacks, globs, d2, g2


#: every list and dtype but the CNN's in bf16 (see the next test)
JAX_CASES = [(leaves, dtype) for leaves in list(LEAF_LISTS) + ["many"]
             for dtype in DTYPES if (leaves, dtype) != ("cnn", "bfloat16")]


@pytest.mark.parametrize("leaves,dtype", JAX_CASES)
def test_delta_norm_leaves_matches_vmapped_jax_leaf_by_leaf(leaves, dtype):
    stacks, globs, d2, g2 = _delta_norm_case(leaves, dtype)
    for l, (s, g) in enumerate(zip(stacks, globs)):
        d2r, g2r = jax.vmap(jref.delta_norm_ref, in_axes=(0, None))(
            arr_j(s, dtype), arr_j(g, dtype))
        np.testing.assert_allclose(f32(d2[l]), f32(d2r), rtol=1e-5)
        np.testing.assert_allclose(f32(g2[l]), f32(g2r)[0], rtol=1e-5)


def test_delta_norm_leaves_cnn_bf16_matches_the_exact_sums():
    """The CNN's leaves in bf16 against the reference's law summed in
    float64 (the widening to f32 is exact, so this is the exact value),
    at the same ``rtol=1e-5``. XLA's CPU f32 sum of the (5, 5, 128, 256)
    leaf's bf16 differences lands 1.7e-5 from that value on these
    inputs, so the JAX call cannot serve as the bar for this leaf."""
    stacks, globs, d2, g2 = _delta_norm_case("cnn", "bfloat16")
    for l, (s, g) in enumerate(zip(stacks, globs)):
        s64 = f32(arr_t(s, "bfloat16")).astype(np.float64)
        g64 = f32(arr_t(g, "bfloat16")).astype(np.float64)
        exact = ((s64 - g64[None]) ** 2).reshape(len(s), -1).sum(1)
        np.testing.assert_allclose(f32(d2[l]), exact, rtol=1e-5)
        np.testing.assert_allclose(f32(g2[l]), (g64 ** 2).sum(), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norm_one_leaf_cases_equal_the_leaf_list(dtype):
    """``delta_norm_stacked`` is the one-leaf case bit for bit, and the
    two-operand ``delta_norm`` the one-row case to f32 rounding."""
    stacks, globs = _cohort(LEAF_LISTS["ragged"], 4, seed=13)
    st = [arr_t(s, dtype) for s in stacks]
    gl = [arr_t(g, dtype) for g in globs]
    d2, g2 = tops.delta_norm_leaves(st, gl)
    for l, (s, g) in enumerate(zip(st, gl)):
        d2s, g2s = tops.delta_norm_stacked(s, g)
        assert np.array_equal(bits(d2[l]), bits(d2s))
        assert np.array_equal(bits(g2[l]), bits(g2s))
        d2o, g2o = tops.delta_norm(s[1], g)
        np.testing.assert_allclose(f32(d2o), f32(d2[l, 1]), rtol=1e-6)
        np.testing.assert_allclose(f32(g2o), f32(g2[l]), rtol=1e-6)


def test_delta_norm_leaves_global_row_is_exact():
    """A local model equal to the global gives d2 = 0 exactly; a zero
    global gives g2 = 0 and d2 = the local's own norm."""
    g = arr_t(_normal(3, (2, 130)))
    st = torch.stack([g, torch.zeros_like(g), 2 * g])
    d2, g2 = tops.delta_norm_leaves([st, st], [g, torch.zeros_like(g)])
    assert float(d2[0, 0]) == 0.0 and float(g2[1]) == 0.0
    assert float(d2[1, 1]) == 0.0
    np.testing.assert_allclose(f32(d2[0, 1]), f32(g2[0]), rtol=1e-6)
    np.testing.assert_allclose(f32(d2[1, 2]), 4 * f32(g2[0]), rtol=1e-6)


# ------------------------------------------------------ server_opt_leaves
@pytest.mark.parametrize("leaves", list(LEAF_LISTS) + ["llm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norm_leaves_row_bits_do_not_follow_the_row_count(leaves,
                                                                dtype):
    """A row's sums are the same bits reduced alone, in a chunk and
    inside a wider stack (the sparse prepass reduces 256-row chunks, the
    fused round the whole cohort; the card's kernel keeps this too)."""
    shapes = LLM_LEAVES if leaves == "llm" else LEAF_LISTS[leaves]
    U = 9
    stacks, globs = _cohort(shapes, U, seed=23)
    st = [arr_t(x, dtype) for x in stacks]
    gl = [arr_t(g, dtype) for g in globs]
    full, g2 = tops.delta_norm_leaves(st, gl)
    alone = torch.cat([tops.delta_norm_leaves([x[u:u + 1] for x in st],
                                              gl)[0] for u in range(U)], 1)
    chunks = torch.cat([tops.delta_norm_leaves([x[lo:lo + 4] for x in st],
                                               gl)[0]
                        for lo in range(0, U, 4)], 1)
    assert np.array_equal(bits(alone), bits(full))
    assert np.array_equal(bits(chunks), bits(full))
    assert np.array_equal(bits(tops.delta_norm_leaves(st[:1], gl[:1])[1]),
                          bits(g2[:1]))


@pytest.mark.parametrize("leaves", list(LEAF_LISTS))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_leaves_matches_jax_ref_leaf_by_leaf(leaves, kind, dtype):
    case = _opt_leaves(LEAF_LISTS[leaves], seed=21)
    t = [[arr_t(a, dtype) for a in leaf] for leaf in case]
    outs = tops.server_opt_leaves(*zip(*t), KINDS[kind])
    assert [len(o) for o in outs] == [len(case)] * 3
    for l, leaf in enumerate(case):
        want = jref.server_opt_combine_ref(
            *(arr_j(a, dtype) for a in leaf), KINDS[kind])
        for got, w in zip((o[l] for o in outs), want):
            assert got.shape == leaf[0].shape
            assert str(got.dtype) == f"torch.{dtype}"
            np.testing.assert_allclose(f32(got), f32(w), rtol=1e-5,
                                       atol=_atol(dtype))


@pytest.mark.parametrize("leaves", ["mlp", "ragged"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_leaves_matches_pallas_interpret_leaf_by_leaf(
        leaves, kind, dtype):
    case = _opt_leaves(LEAF_LISTS[leaves], seed=23)
    t = [[arr_t(a, dtype) for a in leaf] for leaf in case]
    outs = tops.server_opt_leaves(*zip(*t), KINDS[kind])
    for l, leaf in enumerate(case):
        want = jops.server_opt_combine(*(arr_j(a, dtype) for a in leaf),
                                       KINDS[kind], interpret=True)
        for got, w in zip((o[l] for o in outs), want):
            np.testing.assert_allclose(f32(got), f32(w), rtol=1e-5,
                                       atol=_atol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("consts", [[0, 0.9, 0.99, 0.5, 1e-3],
                                    [1, 0.0, 0.0, 1.0, 1e-3]],
                         ids=["identity", "momentum-inert"])
def test_server_opt_leaves_inert_passes_avg_bits(dtype, consts):
    case = _opt_leaves(LEAF_LISTS["ragged"], seed=25)
    avgs, olds, ms, vs = ([arr_t(leaf[i], dtype) for leaf in case]
                          for i in range(4))
    outs, nms, nvs = tops.server_opt_leaves(avgs, olds, ms, vs, consts)
    for out, nv, a, v in zip(outs, nvs, avgs, vs):
        assert np.array_equal(bits(out), bits(a))
        assert np.array_equal(bits(nv), bits(v))
        assert out.data_ptr() != a.data_ptr()          # a fresh tensor


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_combine_is_the_one_leaf_case_bitwise(kind, dtype):
    case = _opt_leaves(LEAF_LISTS["mlp"], seed=27)
    t = [[arr_t(a, dtype) for a in leaf] for leaf in case]
    outs = tops.server_opt_leaves(*zip(*t), KINDS[kind])
    for l, leaf in enumerate(t):
        one = tops.server_opt_combine(*leaf, KINDS[kind])
        for got, want in zip((o[l] for o in outs), one):
            assert np.array_equal(bits(got), bits(want))


# ------------------------------------------ the callers, one call instead
def _mlp_cohort(U, seed):
    from repro_torch.models.paper_models import get_paper_model
    from repro_torch.tree import tree_map
    glob = get_paper_model("mlp")[0](seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    stack = tree_map(lambda p: p.unsqueeze(0) + 0.01 * torch.randn(
        (U,) + p.shape, generator=gen), glob)
    return stack, glob


def test_stacked_model_priorities_bits_equal_the_per_leaf_route():
    from repro_torch.tree import tree_leaves
    stack, glob = _mlp_cohort(5, seed=2)
    got = tprio.stacked_model_priorities(stack, glob)
    want = torch.ones(5)
    for s, g in zip(tree_leaves(stack), tree_leaves(glob)):
        want = want * (1.0 + tprio._ratio(*tops.delta_norm_stacked(s, g)))
    assert got.shape == (5,) and np.array_equal(bits(got), bits(want))


def test_row_delta_normsq_bits_equal_the_per_leaf_route():
    from repro_torch.tree import tree_leaves
    stack, glob = _mlp_cohort(4, seed=3)
    got = row_delta_normsq(stack, glob)
    want = None
    for s, g in zip(tree_leaves(stack), tree_leaves(glob)):
        d2, _ = tops.delta_norm_stacked(s, g)
        want = d2 if want is None else want + d2
    assert np.array_equal(bits(got), bits(want))


def test_fedadam_merge_bits_equal_the_per_leaf_route(monkeypatch):
    """The objective merge's one ``server_opt_leaves`` call against the
    same run with the call replaced by the plain step leaf by leaf:
    winners, the global and m / v bit for bit."""
    obj = ObjectiveSpec(local="fedprox", mu=0.01, aggregator="fedadam",
                        server_lr=0.1)
    hist, eng = run_port(objective=obj)
    calls = []

    def per_leaf(avgs, olds, ms, vs, consts):
        calls.append(len(avgs))
        c = torch.as_tensor(np.asarray(consts, np.float32))
        rows = [tref.server_opt_combine_ref(a, o, m, v, c)
                for a, o, m, v in zip(avgs, olds, ms, vs)]
        return tuple([r[i] for r in rows] for i in range(3))

    monkeypatch.setattr(tops, "server_opt_leaves", per_leaf)
    hist_pl, eng_pl = run_port(objective=obj)
    assert calls and all(n == 2 for n in calls)
    assert hist.winners == hist_pl.winners
    for a, b in ((eng.global_params, eng_pl.global_params),
                 (eng.backend._obj_m, eng_pl.backend._obj_m),
                 (eng.backend._obj_v, eng_pl.backend._obj_v)):
        for k in a:
            assert np.array_equal(bits(a[k]), bits(b[k]))


# ------------------------------------------------------------- refusals
def _bad_delta_norm_lists():
    x, y = torch.ones(3, 4), torch.ones(4)
    return {
        "unequal": ([x, x], [y]),
        "empty": ([], []),
        "mixed dtypes": ([x, x.bfloat16()], [y, y.bfloat16()[:4]]),
        "glob dtype": ([x], [y.bfloat16()]),
        "shape": ([x], [torch.ones(5)]),
        "U differs": ([x, torch.ones(2, 4)], [y, y]),
    }


@pytest.mark.parametrize("case", list(_bad_delta_norm_lists()))
def test_delta_norm_leaves_rejects_bad_lists(case):
    stacks, globs = _bad_delta_norm_lists()[case]
    with pytest.raises(ValueError):
        tops.delta_norm_leaves(stacks, globs)


def _bad_server_opt_lists():
    x = torch.ones(3, 4)
    return {
        "unequal": ([x, x], [x, x], [x, x], [x]),
        "empty": ([], [], [], []),
        "mixed dtypes": ([x, x.bfloat16()], [x, x.bfloat16()],
                         [x, x.bfloat16()], [x, x.bfloat16()]),
        "operand dtype": ([x], [x], [x.bfloat16()], [x]),
        "shape": ([x], [x], [x], [torch.ones(4, 3)]),
    }


@pytest.mark.parametrize("case", list(_bad_server_opt_lists()) + ["consts"])
def test_server_opt_leaves_rejects_bad_lists(case):
    if case == "consts":
        x = torch.ones(3)
        with pytest.raises(ValueError):
            tops.server_opt_leaves([x], [x], [x], [x], [2, 0.9, 0.99])
        return
    with pytest.raises(ValueError):
        tops.server_opt_leaves(*_bad_server_opt_lists()[case], KINDS["adam"])
