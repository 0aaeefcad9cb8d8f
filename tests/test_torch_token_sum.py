"""The fixed-order token sum of the LLM local step (``kernels/ref.py::
token_sum_ref``, ``kernels/ops.py::token_sum``, ``models/layers.py::
token_sum``) and the norms' affine step whose backward takes the scale
and bias gradients through it, on the CPU.

The contract: a user's sum over its tokens gives the same bits whatever
the number of rows beside it in a launch or a ``vmap`` (a 3-lane sweep
stacks 30 users where its run stacks 10), in the forward and in the
backward. The plain version is one tree of elementwise adds, so it
holds on any device; ``chip_smoke.py`` holds the card's kernel bit-equal
to it, and ``llm_sweep`` a sweep lane to its run. Values against the
float64 sum: rtol 1e-6 (f32 rounding of a tree of at most 2^12 adds).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

ROWS = [1, 3, 10]
SHAPES = [(1, 3), (37, 5), (64, 256), (129, 40), (4096, 2)]


def bits(t):
    return t.detach().contiguous().view(torch.int32).numpy()


def stack(U, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((U,) + shape, generator=g)


@pytest.mark.parametrize("shape", SHAPES)
def test_token_sum_is_the_sum_in_one_tree(shape):
    x = stack(*shape, seed=1)
    got = L.token_sum(x, keep=1)
    want = x.double().sum(dim=0)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(x.abs().sum(0).max()))
    # the tree: adjacent pairs, level by level, zeros padding to 2^k
    N, C = shape
    P = 1 << max(N - 1, 0).bit_length()
    level = [x[n] for n in range(N)] + [torch.zeros(C)] * (P - N)
    while len(level) > 1:
        level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
    assert np.array_equal(bits(level[0]), bits(got))
    assert np.array_equal(bits(L.token_sum(x)), bits(L.token_sum(
        x.reshape(-1, 1), keep=1)[0]))


def test_token_sum_of_no_tokens_is_zero():
    assert torch.equal(L.token_sum(torch.zeros(0, 3), keep=1),
                       torch.zeros(3))
    assert torch.equal(ref.token_sum_ref(torch.zeros(2, 0, 3)),
                       torch.zeros(2, 3))


@pytest.mark.parametrize("U", ROWS)
def test_plain_version_rows_are_the_layers_sums(U):
    """``ref.token_sum_ref`` over a (U, N, C) stack (the CPU route of
    ``ops.token_sum``, the kernel's plain version): each row the bits of
    ``layers.token_sum`` of that row alone."""
    x = stack(U, 129, 40, seed=7)
    got = ref.token_sum_ref(x)
    assert torch.equal(ops.token_sum(x), got)
    for u in range(U):
        assert np.array_equal(bits(got[u]), bits(L.token_sum(x[u], keep=1)))


@pytest.mark.parametrize("U", ROWS)
def test_token_sum_row_bits_do_not_follow_the_row_count(U):
    """A row's sum is the same bits alone, in a stack of U and in a wider
    stack under ``vmap``; ``keep`` leaves the trailing dims."""
    x = stack(10, 16, 24, 7, seed=2)
    wide = L.token_sum(x[0], keep=1)
    assert wide.shape == (7,)
    got = torch.func.vmap(lambda t: L.token_sum(t, keep=1))(x[:U])
    alone = torch.stack([L.token_sum(x[u], keep=1) for u in range(U)])
    full = torch.func.vmap(lambda t: L.token_sum(t, keep=1))(x)
    assert np.array_equal(bits(got), bits(alone))
    assert np.array_equal(bits(got), bits(full[:U]))
    scalar = torch.func.vmap(L.token_sum)(x[:U])
    assert scalar.shape == (U,)
    assert np.array_equal(bits(scalar),
                          bits(torch.stack([L.token_sum(x[u])
                                            for u in range(U)])))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("U", ROWS)
def test_norm_scale_gradient_row_bits_do_not_follow_the_row_count(U, kind):
    """``vmap(grad)`` through ``apply_norm``: each user's scale (and
    LayerNorm bias) gradient and its input gradient are the same bits at
    U rows, at 10 rows and alone, and its loss too (the loss is a token
    sum of the normed output, so no GEMM stands between them)."""
    D = 24
    x = stack(10, 3, 17, D, seed=3)
    w = stack(1, 3, 17, D, seed=4)[0]
    p = {"scale": 0.1 * stack(10, D, seed=5)}
    if kind == "layernorm":
        p["bias"] = 0.1 * stack(10, D, seed=6)

    def loss(params, xu):
        return L.token_sum(L.apply_norm(params, xu, kind) * w)

    fn = torch.func.grad_and_value(loss, argnums=(0, 1))
    (gp, gx), lv = torch.func.vmap(fn)({k: v[:U] for k, v in p.items()},
                                       x[:U])
    (gp10, gx10), lv10 = torch.func.vmap(fn)(p, x)
    for u in range(U):
        (gpu, gxu), lu = fn({k: v[u] for k, v in p.items()}, x[u])
        assert np.array_equal(bits(lv[u]), bits(lu))
        assert np.array_equal(bits(gx[u]), bits(gxu))
        for k in p:
            assert np.array_equal(bits(gp[k][u]), bits(gpu[k]))
            assert np.array_equal(bits(gp[k][u]), bits(gp10[k][u]))
    assert np.array_equal(bits(lv), bits(lv10[:U]))
    # the values: autograd's own reduction of the broadcast product
    xs = x[0].clone().requires_grad_(True)
    sc = p["scale"][0].clone().requires_grad_(True)
    xf = xs - xs.mean(-1, keepdim=True) if kind == "layernorm" else xs
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + sc)
    if kind == "layernorm":
        y = y + p["bias"][0]
    (y * w).sum().backward()
    np.testing.assert_allclose(gp10["scale"][0].numpy(), sc.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx10[0].numpy(), xs.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
