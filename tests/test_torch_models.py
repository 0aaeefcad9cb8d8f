"""The paper's MLP and CNN in the port against the JAX package, on the
CPU, from the same numpy parameters and inputs (``rtol=1e-5,
atol=1e-5``: f32 matmul / convolution sums run in different orders).
The reference's layouts hold at the port's public functions: dense
weights (in, out), conv weights HWIO, inputs NHWC.
"""
import numpy as np
import pytest
import torch

from repro.models import paper_models as jm
from repro_torch.models import paper_models as tm
from repro_torch.convert import params_from_numpy, params_to_numpy

from torch_port_util import f32, to_jax, to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp_params(rng, d_in, d_hid, n_cls=10):
    return {"fc1": {"w": rng.standard_normal((d_in, d_hid), np.float32) * .1,
                    "b": rng.standard_normal(d_hid, np.float32) * .1},
            "fc2": {"w": rng.standard_normal((d_hid, n_cls), np.float32) * .1,
                    "b": rng.standard_normal(n_cls, np.float32) * .1}}


def _cnn_params(rng, cin, size, n_cls=10):
    d_flat = 256 * (size // 4) ** 2
    return {
        "conv1": {"w": rng.standard_normal((5, 5, cin, 128), np.float32) * .05,
                  "b": rng.standard_normal(128, np.float32) * .05},
        "conv2": {"w": rng.standard_normal((5, 5, 128, 256), np.float32) * .02,
                  "b": rng.standard_normal(256, np.float32) * .05},
        "fc": {"w": rng.standard_normal((d_flat, n_cls), np.float32) * .02,
               "b": rng.standard_normal(n_cls, np.float32) * .05}}


@pytest.mark.parametrize("d_in,d_hid", [(784, 200), (48, 20)])
def test_apply_mlp_matches_jax(d_in, d_hid):
    rng = np.random.default_rng(0)
    p = _mlp_params(rng, d_in, d_hid)
    x = rng.standard_normal((6, d_in), np.float32)
    want = jm.apply_mlp(to_jax(p), x)
    got = tm.apply_mlp(to_torch(p), torch.from_numpy(x))
    assert got.shape == (6, 10)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_apply_mlp_flattens_images():
    rng = np.random.default_rng(1)
    p = _mlp_params(rng, 784, 200)
    x = rng.standard_normal((3, 28, 28, 1), np.float32)
    want = jm.apply_mlp(to_jax(p), x)
    got = tm.apply_mlp(to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("cin,size", [(1, 8), (3, 12), (1, 28)])
def test_apply_cnn_matches_jax_nhwc_hwio(cin, size):
    """Non-square channel counts and a non-symmetric input: a wrong
    permutation of HWIO / NHWC, or a flatten in NCHW order, would not
    agree."""
    rng = np.random.default_rng(2)
    p = _cnn_params(rng, cin, size)
    x = rng.standard_normal((2, size, size, cin), np.float32)
    want = jm.apply_cnn(to_jax(p), x)
    got = tm.apply_cnn(to_torch(p), torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_apply_cnn_takes_flattened_input():
    rng = np.random.default_rng(3)
    p = _cnn_params(rng, 1, 8)
    x = rng.standard_normal((2, 64), np.float32)
    want = jm.apply_cnn(to_jax(p), x)
    got = tm.apply_cnn(to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("name,dataset", [("mlp", "fashion"),
                                          ("mlp", "cifar"),
                                          ("cnn", "fashion"),
                                          ("cnn", "cifar")])
def test_init_has_the_references_tree_shapes_and_dtypes(name, dataset):
    import jax
    jinit, _ = jm.get_paper_model(name, dataset)
    tinit, _ = tm.get_paper_model(name, dataset)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jinit(jax.random.PRNGKey(0)))
    got = tinit(0, device="cpu")
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in want.items()}
    for k in got:
        for n, t in got[k].items():
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == want[k][n]
            if n == "b":
                assert not t.any()               # biases start at zero


def test_init_is_deterministic_in_its_seed_and_bounded():
    a = tm.init_mlp(5, device="cpu")
    b = tm.init_mlp(5, device="cpu")
    c = tm.init_mlp(6, device="cpu")
    assert torch.equal(a["fc1"]["w"], b["fc1"]["w"])
    assert not torch.equal(a["fc1"]["w"], c["fc1"]["w"])
    assert float(a["fc1"]["w"].abs().max()) <= 1.0 / np.sqrt(784)
    g = torch.Generator().manual_seed(5)
    assert torch.equal(tm.init_mlp(g, device="cpu")["fc2"]["w"],
                       a["fc2"]["w"])


def test_init_without_cuda_raises_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_mlp(0)


def test_convert_round_trips_leaf_for_leaf_without_aliasing():
    rng = np.random.default_rng(4)
    p = _mlp_params(rng, 12, 5)
    t = params_from_numpy(p, device="cpu")
    back = params_to_numpy(t)
    for k in p:
        for n in p[k]:
            assert np.array_equal(back[k][n], p[k][n])
            assert t[k][n].shape == p[k][n].shape    # no transposition
    t["fc1"]["w"].zero_()
    assert p["fc1"]["w"].any()                       # a copy, not a view
    bf = params_from_numpy(p, device="cpu", dtype=torch.bfloat16)
    assert bf["fc1"]["w"].dtype == torch.bfloat16
    assert params_to_numpy(bf)["fc1"]["w"].dtype == np.float32


def test_get_paper_model_rejects_unknown_names():
    with pytest.raises(ValueError):
        tm.get_paper_model("resnet")
    with pytest.raises(ValueError):
        tm.get_paper_model("mlp", "imagenet")
