"""The port's four kernel ops against the JAX package, on the CPU.

Each op's plain PyTorch version (what ``repro_torch.kernels.ops`` runs
for a CPU tensor) is held against ``repro.kernels.ref`` over the shapes
and dtypes of ``tests/test_kernels.py``, and against the Pallas kernel
in interpret mode over a subset (interpret mode is slow). Tolerances
are that file's: f32 ``rtol=1e-5, atol=1e-6``; bf16 ``atol=0.02`` (one
ulp of the output type — fused and unfused versions round at different
places). The exactness contracts of the merge are re-pinned bitwise
within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops as tops, ref as tref

from torch_port_util import arr_j, arr_t, bits, f32

SHAPES = [(8,), (127,), (784, 200), (200,), (3, 5, 7), (1024, 128),
          (2, 129, 5), (4096,)]
INTERPRET_SHAPES = [(8,), (127,), (3, 5, 7), (2, 129, 5)]
DTYPES = ["float32", "bfloat16"]


def _atol(dtype):
    return 1e-6 if dtype == "float32" else 0.02


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _alphas(seed, k):
    a = np.random.default_rng(seed).uniform(0.1, 1.0, k)
    return (a / a.sum()).astype(np.float32)


# ------------------------------------------------------------ delta_norm
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norm_matches_jax_ref(shape, dtype):
    wl, wg = _normal(0, shape), _normal(1, shape)
    d2, g2 = tops.delta_norm(arr_t(wl, dtype), arr_t(wg, dtype))
    d2r, g2r = jref.delta_norm_ref(arr_j(wl, dtype), arr_j(wg, dtype))
    assert d2.dtype == torch.float32 and d2.dim() == 0
    np.testing.assert_allclose(f32(d2), f32(d2r), rtol=1e-5)
    np.testing.assert_allclose(f32(g2), f32(g2r), rtol=1e-5)


@pytest.mark.parametrize("shape", INTERPRET_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norm_matches_pallas_interpret(shape, dtype):
    wl, wg = _normal(0, shape), _normal(1, shape)
    d2, g2 = tops.delta_norm(arr_t(wl, dtype), arr_t(wg, dtype))
    d2k, g2k = jops.delta_norm(arr_j(wl, dtype), arr_j(wg, dtype),
                               interpret=True)
    np.testing.assert_allclose(f32(d2), f32(d2k), rtol=1e-5)
    np.testing.assert_allclose(f32(g2), f32(g2k), rtol=1e-5)


@pytest.mark.parametrize("shape", [(127,), (784, 200), (2, 129, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norm_stacked_matches_vmapped_jax(shape, dtype):
    """The batched (U, n) vs (n,) entry equals the reference's vmap of
    the two-operand op over the stack axis."""
    U = 5
    st, wg = _normal(2, (U,) + shape), _normal(3, shape)
    d2, g2 = tops.delta_norm_stacked(arr_t(st, dtype), arr_t(wg, dtype))
    d2r, g2r = jax.vmap(jref.delta_norm_ref, in_axes=(0, None))(
        arr_j(st, dtype), arr_j(wg, dtype))
    assert d2.shape == (U,) and g2.dim() == 0
    np.testing.assert_allclose(f32(d2), f32(d2r), rtol=1e-5)
    np.testing.assert_allclose(f32(g2), f32(g2r)[0], rtol=1e-5)
    # and the port's own two-operand entry, row by row
    for u in range(U):
        d2u, g2u = tops.delta_norm(arr_t(st[u], dtype), arr_t(wg, dtype))
        np.testing.assert_allclose(f32(d2[u]), f32(d2u), rtol=1e-6)
        np.testing.assert_allclose(f32(g2), f32(g2u), rtol=1e-6)


def test_delta_norm_invariants():
    wg = arr_t(_normal(4, (300,)))
    d2, g2 = tops.delta_norm(wg, wg)
    assert float(d2) == 0.0
    d2, g2 = tops.delta_norm(torch.ones(300), torch.zeros(300))
    assert float(d2) == 300.0 and float(g2) == 0.0
    with pytest.raises(ValueError):
        tops.delta_norm(torch.ones(3, 4), torch.ones(4))


# -------------------------------------------------------- fedavg_combine
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_fedavg_matches_jax_ref(shape, dtype, k):
    st, a = _normal(5, (k,) + shape), _alphas(6, k)
    out = tops.fedavg_combine(arr_t(st, dtype), a)
    out_r = jref.fedavg_combine_ref(arr_j(st, dtype), jnp.asarray(a))
    assert out.shape == shape and str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(out), f32(out_r), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", INTERPRET_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fedavg_matches_pallas_interpret(shape, dtype):
    k = 3
    st, a = _normal(5, (k,) + shape), _alphas(6, k)
    out = tops.fedavg_combine(arr_t(st, dtype), a)
    out_k = jops.fedavg_combine(arr_j(st, dtype), jnp.asarray(a),
                                interpret=True)
    np.testing.assert_allclose(f32(out), f32(out_k), rtol=1e-5,
                               atol=_atol(dtype))


# -------------------------------------------------------- gather_combine
def _gather_case(seed, shape, S=6, k_pad=4, winners=(4, 1, 3)):
    st, glob = _normal(seed, (S,) + shape), _normal(seed + 1, shape)
    idx = np.zeros(k_pad, np.int32)
    w = np.zeros(k_pad, np.float32)
    idx[:len(winners)] = winners
    w[:len(winners)] = _alphas(seed + 2, len(winners))
    return st, idx, w, glob


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_combine_matches_jax_ref(shape, dtype):
    st, idx, w, glob = _gather_case(7, shape)
    out = tops.gather_combine(arr_t(st, dtype), idx, w, arr_t(glob, dtype))
    out_r = jref.gather_combine_ref(arr_j(st, dtype), jnp.asarray(idx),
                                    jnp.asarray(w), arr_j(glob, dtype))
    assert out.shape == shape and str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(out), f32(out_r), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", INTERPRET_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_combine_matches_pallas_interpret(shape, dtype):
    st, idx, w, glob = _gather_case(7, shape)
    out = tops.gather_combine(arr_t(st, dtype), idx, w, arr_t(glob, dtype))
    out_k = jops.gather_combine(arr_j(st, dtype), idx, w,
                                arr_j(glob, dtype), interpret=True)
    np.testing.assert_allclose(f32(out), f32(out_k), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_zero_weight_masks_nonfinite_row_exactly(dtype, bad):
    """A zero weight contributes EXACT zero even for an inf/NaN row: the
    result is bit-equal to the merge that never saw the row."""
    st, idx, w, glob = _gather_case(10, (2, 129, 5))
    poisoned = st.copy()
    poisoned[0] = bad                       # row 0: pad target, weight 0
    poisoned[5] = bad                       # row 5: not selected at all
    clean = tops.gather_combine(arr_t(st, dtype), idx, w, arr_t(glob, dtype))
    out = tops.gather_combine(arr_t(poisoned, dtype), idx, w,
                              arr_t(glob, dtype))
    assert np.isfinite(f32(out)).all()
    assert np.array_equal(bits(out), bits(clean))
    # the dense masked formulation too
    a = np.zeros(6, np.float32)
    a[list(idx[:3])] = w[:3]
    dense = tops.fedavg_combine(arr_t(poisoned, dtype), a)
    assert np.isfinite(f32(dense)).all()
    assert np.array_equal(
        bits(dense), bits(tops.fedavg_combine(arr_t(st, dtype), a)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_zero_weights_return_glob_bitwise(dtype):
    st, idx, _, glob = _gather_case(11, (127,))
    g = arr_t(glob, dtype)
    out = tops.gather_combine(arr_t(st, dtype), idx,
                              np.zeros(len(idx), np.float32), g)
    assert np.array_equal(bits(out), bits(g))
    assert out.data_ptr() != g.data_ptr()        # a fresh tensor


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_width_does_not_change_the_bits(dtype):
    shape, winners = (784, 20), (4, 1, 3)
    outs = []
    for k_pad in (3, 4, 8, 17):
        st, idx, w, glob = _gather_case(12, shape, k_pad=k_pad,
                                        winners=winners)
        outs.append(tops.gather_combine(arr_t(st, dtype), idx, w,
                                        arr_t(glob, dtype)))
    for o in outs[1:]:
        assert np.array_equal(bits(o), bits(outs[0]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ids_and_compact_positions_agree_bitwise(dtype):
    """S = U with winner ids and S = K with positions into the gathered
    rows give bit-equal output (the dense / sparse merge contract)."""
    st, idx, w, glob = _gather_case(13, (200, 10), S=9, winners=(7, 2, 5))
    dense = tops.gather_combine(arr_t(st, dtype), idx, w, arr_t(glob, dtype))
    compact = st[idx]                            # (k_pad, ...) gathered
    pos = np.arange(len(idx), dtype=np.int32)
    sparse = tops.gather_combine(arr_t(compact, dtype), pos, w,
                                 arr_t(glob, dtype))
    assert np.array_equal(bits(dense), bits(sparse))


def test_gather_combine_sums_in_delivery_order():
    """f32 addition is not associative: the op must add j = 0, 1, 2 in
    order, and the plain version loops exactly so."""
    st = arr_t(np.array([[1e8], [1.0], [-1e8]], np.float32))
    w = np.ones(3, np.float32)
    g = torch.zeros(1)
    a = tops.gather_combine(st, np.array([0, 1, 2], np.int32), w, g)
    b = tops.gather_combine(st, np.array([0, 2, 1], np.int32), w, g)
    assert float(a) == 0.0 and float(b) == 1.0


def test_gather_combine_rejects_out_of_range_index():
    st, idx, w, glob = _gather_case(14, (8,))
    idx[0] = 6
    with pytest.raises(IndexError):
        tops.gather_combine(arr_t(st), idx, w, arr_t(glob))


# ------------------------------------------------------------- fused_sgd
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lr", [0.0, 1e-2, 1.0])
def test_fused_sgd_matches_jax_ref(shape, dtype, lr):
    p, g = _normal(8, shape), _normal(9, shape)
    pt = arr_t(p, dtype)
    out = tops.fused_sgd(pt, arr_t(g, dtype), lr)
    assert out is pt                              # in place
    out_r = jref.fused_sgd_ref(arr_j(p, dtype), arr_j(g, dtype), lr)
    np.testing.assert_allclose(f32(out), f32(out_r), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", INTERPRET_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_sgd_matches_pallas_interpret(shape, dtype):
    p, g = _normal(8, shape), _normal(9, shape)
    out = tops.fused_sgd(arr_t(p, dtype), arr_t(g, dtype), 1e-2)
    out_k = jops.fused_sgd(arr_j(p, dtype), arr_j(g, dtype), 1e-2,
                           interpret=True)
    np.testing.assert_allclose(f32(out), f32(out_k), rtol=1e-5,
                               atol=_atol(dtype))


#: the stacked leaves one local step updates: the paper's MLP and CNN
#: (models/paper_models.py, leaf order) over a 3-user cohort, and a list
#: of sizes that are no multiple of 4 or 8, below 4, and past one chunk
SGD_LEAF_LISTS = {
    "mlp": [(3, 200), (3, 784, 200), (3, 10), (3, 200, 10)],
    "cnn": [(3, 128), (3, 5, 5, 1, 128), (3, 256), (3, 5, 5, 128, 256),
            (3, 10), (3, 12544, 10)],
    "ragged": [(1,), (3,), (7,), (2, 5), (4097,), (3, 129, 5), (8,)],
    "empty": [],
}


@pytest.mark.parametrize("leaves", list(SGD_LEAF_LISTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_sgd_leaves_matches_jax_ref_leaf_by_leaf(leaves, dtype):
    shapes = SGD_LEAF_LISTS[leaves]
    ps = [_normal(30 + i, s) for i, s in enumerate(shapes)]
    gs = [_normal(60 + i, s) for i, s in enumerate(shapes)]
    pt = [arr_t(p, dtype) for p in ps]
    out = tops.fused_sgd_leaves(pt, [arr_t(g, dtype) for g in gs], 1e-2)
    assert len(out) == len(shapes)
    for o, t, p, g in zip(out, pt, ps, gs):
        assert o is t                              # in place
        want = jref.fused_sgd_ref(arr_j(p, dtype), arr_j(g, dtype), 1e-2)
        np.testing.assert_allclose(f32(o), f32(want), rtol=1e-5,
                                   atol=_atol(dtype))
        # and bit for bit the one-leaf op of the port
        assert np.array_equal(bits(o), bits(tops.fused_sgd(
            arr_t(p, dtype), arr_t(g, dtype), 1e-2)))


def test_fused_sgd_leaves_rejects_unequal_lists():
    with pytest.raises(ValueError):
        tops.fused_sgd_leaves([torch.ones(3)], [], 0.1)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_sgd_epoch_scan_bits_equal_the_per_leaf_route(model):
    """The local loop (one ``fused_sgd_leaves`` call a step) gives the
    bits of the same loop stepping leaf by leaf with ``fused_sgd``."""
    from repro_torch.core.client import sgd_epoch_scan
    from repro_torch.models.paper_models import get_paper_model
    from repro_torch.tree import tree_map
    init, apply = get_paper_model(model)
    U, nb, bs = 2, 2, 4
    p0 = init(0, device="cpu")
    stack = tree_map(lambda p: p.unsqueeze(0).expand((U,) + p.shape)
                     .contiguous(), p0)
    rng = np.random.default_rng(5)
    batched = {"x": torch.from_numpy(rng.standard_normal(
        (U, nb, bs, 28, 28, 1)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 10, (U, nb, bs)))}

    def loss_fn(params, batch):
        x = batch["x"] if model == "cnn" else batch["x"].reshape(
            batch["x"].shape[0], -1)
        logp = torch.log_softmax(apply(params, x), -1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()

    got, losses = sgd_epoch_scan(loss_fn, 1e-2)(
        tree_map(torch.clone, stack), batched)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    want = tree_map(torch.clone, stack)
    for i in range(nb):
        grads, _ = grad_fn(want, tree_map(lambda a: a[:, i], batched))
        tree_map(lambda p, g: tops.fused_sgd(p, g.contiguous(), 1e-2),
                 want, grads)
    assert losses.shape == (U, nb)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(bits(a), bits(b))
    assert not np.array_equal(bits(jax.tree.leaves(got)[1]),
                              bits(jax.tree.leaves(stack)[1]))


# ------------------------------------------------------ dispatch contract
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tops.reset_launches()
    x = arr_t(_normal(15, (4, 33)))
    tops.delta_norm(x[0], x[1])
    tops.delta_norm_stacked(x, x[0])
    tops.delta_norm_leaves([x, x[:, :5].contiguous()], [x[0], x[0, :5]])
    tops.fedavg_combine(x, _alphas(16, 4))
    tops.gather_combine(x, np.array([1, 2], np.int32),
                        np.array([0.5, 0.5], np.float32), x[0])
    tops.fused_sgd(x.clone(), x, 0.1)
    tops.fused_sgd_leaves([x.clone(), x[0].clone()], [x, x[0]], 0.1)
    cnt = torch.zeros((4, 33), dtype=torch.int32)
    tops.contention_event(cnt, cnt == 0, cnt, x, x.abs() % 1.0, 5)
    rows = torch.zeros(4, dtype=torch.int32)
    tops.contention_loop(cnt, x, cnt, rows + 1000, rows + 2, k_max=2,
                         tx_slots=5, max_doublings=5, max_sim_slots=10_000,
                         key=7)
    tops.aircomp_combine(x, _alphas(19, 4), np.ones(4), x[0])
    tops.robust_combine(x, _alphas(20, 4), np.ones(4), x[0])
    tops.server_opt_combine(x[0], x[1], x[2], x[3].abs(),
                            [2, 0.9, 0.99, 0.1, 1e-3])
    tops.server_opt_leaves([x[0], x[1]], [x[1], x[2]], [x[2], x[3]],
                           [x[3].abs(), x[0].abs()], [2, 0.9, 0.99, 0.1, 1e-3])
    assert torch.equal(tops.token_sum(x[None]), tref.token_sum_ref(x[None]))
    img, w, b = x[:, :9].reshape(1, 3, 3, 4), x[:, :25].reshape(5, 5, 4, 1) \
        .expand(5, 5, 4, 8), x[0, :8]
    out, codes = tops.conv_pool(img, w, b)
    tops.conv_pool_grad(out, img, w, b, codes)
    assert tops.LAUNCHES == {"fused_sgd": 0, "delta_norm": 0,
                             "gather_combine": 0, "fedavg_combine": 0,
                             "contention_min": 0, "contention_expiry": 0,
                             "contention_transition": 0,
                             "contention_loop": 0,
                             "aircomp_combine": 0, "robust_combine": 0,
                             "server_opt": 0, "token_sum": 0,
                             "conv_pool": 0, "conv_pool_grad": 0}


def test_plain_versions_agree_with_wrappers_on_cpu():
    x = arr_t(_normal(17, (3, 50)))
    a = torch.from_numpy(_alphas(18, 3))
    assert torch.equal(tops.fedavg_combine(x, a),
                       tref.fedavg_combine_ref(x, a))
    d2, g2 = tops.delta_norm(x[0], x[1])
    d2r, g2r = tref.delta_norm_ref(x[0], x[1])
    assert torch.equal(d2, d2r) and torch.equal(g2, g2r)


# ------------------------------------------------------- property tests
from conftest import given, settings, st  # noqa: E402


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 5000), seed=st.integers(0, 2**30))
def test_delta_norm_property_1d(n, seed):
    """Invariants: d2 >= 0; identical models -> d2 == 0; g2 == ||w||^2;
    the stacked entry agrees with the two-operand one."""
    rng = np.random.default_rng(seed)
    wl = rng.standard_normal(n).astype(np.float32)
    wg = rng.standard_normal(n).astype(np.float32)
    d2, g2 = tops.delta_norm(arr_t(wl), arr_t(wg))
    assert float(d2) >= 0 and float(g2) >= 0
    np.testing.assert_allclose(f32(g2), np.sum(wg.astype(np.float64) ** 2),
                               rtol=1e-5)
    d2_same, _ = tops.delta_norm(arr_t(wg), arr_t(wg))
    assert float(d2_same) == 0.0
    d2s, g2s = tops.delta_norm_stacked(arr_t(np.stack([wl, wg])), arr_t(wg))
    np.testing.assert_allclose(f32(d2s), [float(d2), 0.0], rtol=1e-6)
    np.testing.assert_allclose(f32(g2s), f32(g2), rtol=1e-6)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 2000), k=st.integers(1, 6),
       seed=st.integers(0, 2**30))
def test_merge_property_convexity_and_equivalence(n, k, seed):
    """Weighted avg of identical models is the model; the output stays
    within the per-coordinate envelope of the inputs (alphas on the
    simplex); the gather form over all rows in index order IS the dense
    form, bit for bit."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, n)).astype(np.float32)
    a = _alphas(seed + 1, k)
    out = tops.fedavg_combine(arr_t(x), a)
    assert (f32(out) <= x.max(0) + 1e-5).all()
    assert (f32(out) >= x.min(0) - 1e-5).all()
    same = np.broadcast_to(x[:1], x.shape).copy()
    np.testing.assert_allclose(f32(tops.fedavg_combine(arr_t(same), a)),
                               x[0], rtol=1e-5, atol=1e-6)
    gathered = tops.gather_combine(arr_t(x), np.arange(k, dtype=np.int32),
                                   a, torch.zeros(n))
    assert np.array_equal(bits(gathered), bits(out))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 3000), seed=st.integers(0, 2**30))
def test_fused_sgd_property_matches_numpy(n, seed):
    """p - lr * g with the product and the difference each rounded to
    f32 — exactly what numpy computes in float32."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    lr = np.float32(rng.uniform(1e-4, 1.0))
    out = tops.fused_sgd(arr_t(p), arr_t(g), float(lr))
    assert np.array_equal(f32(out), p - lr * g)
    assert np.array_equal(f32(tops.fused_sgd(arr_t(p), arr_t(g), 0.0)), p)
