"""The paper CNN's first block as one op (``ops.conv_pool`` /
``ops.conv_pool_grad``, wrapped for autograd and ``vmap`` by
``models/paper_models.py::conv_pool``) on the CPU, where it takes its
plain version.

The plain version is the chain the CNN ran before: ``F.conv2d``, the
bias, ``F.relu``, ``F.max_pool2d``, and autograd's vjp of it, so the
CNN's CPU numbers are those of that chain BIT FOR BIT, under the
``vmap(grad_and_value)`` of a cohort's local step (U = 1 and 3), with
the batch dimension elsewhere than 0, an unbatched weight, a nested
``vmap`` (a sweep's E x U), three input channels, and an unbatched
evaluation with a ragged last batch. The winner codes the card's
backward kernel reads are held to ``max_pool2d``'s rule (the first
maximum of a window in row-major order; none where the maximum is <= 0,
since relu'(0) = 0), on windows with exact ties and windows whose every
value is <= 0, and the kernel's own formulation from those codes
(``ref.conv_pool_grad_codes_ref``) to the chain's vjp. The launch plan
(``kernels/conv_pool.py::conv_pool_plan``) is read at the shapes the
card runs. The kernels themselves run in ``chip_smoke.py``'s
``conv_pool`` phase.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from repro_torch.kernels import conv_pool as kcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.train import classification_loss
from repro_torch.models import paper_models as tm


def _parent_conv(x, w, b):
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return F.relu(y + b.reshape(1, -1, 1, 1))


def _parent_apply_cnn(params, x):
    """``apply_cnn`` as it was before its first block became one op: the
    CPU's yardstick."""
    if x.dim() == 2:
        side = int(np.sqrt(x.shape[-1]))
        x = x.reshape(x.shape[0], side, side, 1)
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(_parent_conv(x, params["conv1"]["w"],
                                  params["conv1"]["b"]), 2)
    x = F.max_pool2d(_parent_conv(x, params["conv2"]["w"],
                                  params["conv2"]["b"]), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return x @ params["fc"]["w"] + params["fc"]["b"]


def _block_inputs(kind, B, H, W, C, O, seed):
    """``random``: normal draws; ``ties``: values on a coarse grid, so
    many windows hold equal maxima exactly; ``nonpositive``: a bias that
    drives half the channels' every pre-activation below 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g)
    w = 0.2 * torch.randn(5, 5, C, O, generator=g)
    b = 0.1 * torch.randn(O, generator=g)
    if kind == "ties":
        x = (torch.rand(x.shape, generator=g) < 0.3).float()
        w = torch.round(w * 4) / 4
        w[:, :, :, : O // 2] = 0.25
        b = torch.round(b * 4) / 4
    elif kind == "nonpositive":
        b[: O // 2] -= 100.0
    return x, w, b


def _codes_by_rule(x, w, b):
    """Each window's winner by ``max_pool2d``'s rule, written out."""
    y = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=2) + b.reshape(1, -1, 1, 1))
    H2, W2 = y.shape[2] // 2, y.shape[3] // 2
    win = y[:, :, :2 * H2, :2 * W2].unflatten(2, (H2, 2)).unflatten(
        4, (W2, 2)).permute(0, 1, 2, 4, 3, 5).reshape(*y.shape[:2], H2, W2, 4)
    best = win.max(dim=-1).values
    first = (win == best[..., None]).int().argmax(dim=-1)
    return torch.where(best <= 0, 4, first).to(torch.uint8)


BLOCK_CASES = [("random", 3, 8, 8, 1, 16), ("random", 2, 9, 7, 3, 24),
               ("ties", 4, 8, 8, 1, 16), ("ties", 2, 6, 10, 2, 8),
               ("nonpositive", 3, 8, 8, 1, 16),
               ("nonpositive", 2, 12, 12, 3, 32)]


@pytest.mark.parametrize("kind,B,H,W,C,O", BLOCK_CASES)
def test_plain_block_is_the_parent_chain_and_its_vjp(kind, B, H, W, C, O):
    x, w, b = _block_inputs(kind, B, H, W, C, O, seed=B * H + O)
    out, codes = tops.conv_pool(x, w, b)
    want = F.max_pool2d(_parent_conv(x.permute(0, 3, 1, 2), w, b), 2)
    assert torch.equal(out, want)
    assert torch.equal(codes, _codes_by_rule(x, w, b))
    if kind == "ties":
        assert (codes[:, : O // 2] != 0).any() and (codes == 0).any()
    if kind == "nonpositive":
        assert (codes[:, : O // 2] == 4).all() and (codes != 4).any()
    gz = torch.randn(out.shape, generator=torch.Generator().manual_seed(O))
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    chain = F.max_pool2d(_parent_conv(x.permute(0, 3, 1, 2), wr, br), 2)
    dw_want, db_want = torch.autograd.grad(chain, (wr, br), gz)
    dw, db = tops.conv_pool_grad(gz, x, w, b, codes)
    assert torch.equal(dw, dw_want) and torch.equal(db, db_want)


@pytest.mark.parametrize("kind,B,H,W,C,O", BLOCK_CASES)
def test_the_kernels_formulation_from_codes_is_the_vjp(kind, B, H, W, C, O):
    """The backward kernel's sums (``conv_pool_grad_codes_ref``: g times
    the input under each winner's taps) are the chain's vjp, in float64,
    stacked over R = 2 users with the cotangent (B, R, O, H/2, W/2)."""
    pairs = [_block_inputs(kind, B, H, W, C, O, seed=s) for s in (1, 2)]
    x, w, b = (torch.stack([p[i] for p in pairs]).double() for i in range(3))
    out, codes = tops.conv_pool(x, w, b)
    assert out.shape == (B, 2, O, H // 2, W // 2) == codes.shape
    gz = torch.randn(out.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(3))
    dw, db = tops.conv_pool_grad(gz, x, w, b, codes)
    dw_c, db_c = tref.conv_pool_grad_codes_ref(gz, x, codes)
    torch.testing.assert_close(dw_c, dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db_c, db, rtol=1e-12, atol=1e-12)


def _params(U, cin, size, seed):
    p = tm.init_cnn(seed, in_channels=cin, image_size=size, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    stack = {k: {kk: v + 0.05 * torch.randn((U,) + v.shape, generator=g)
                 for kk, v in d.items()} for k, d in p.items()}
    return stack


def _same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(
        torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)))


def _cohort(U, cin, size, B, seed):
    params = _params(U, cin, size, seed)
    g = torch.Generator().manual_seed(seed + 2)
    shape = (U, B, size * size) if cin == 1 else (U, B, size, size, cin)
    batch = {"x": torch.randn(shape, generator=g),
             "y": torch.randint(0, 10, (U, B), generator=g)}
    return params, batch


def _step(apply_fn, params, batch, in_dims=(0, 0), nest=1):
    fn = grad_and_value(classification_loss(apply_fn))
    for _ in range(nest):
        fn = vmap(fn, in_dims=in_dims)
        in_dims = (0, 0)
    return fn(params, batch)


@pytest.mark.parametrize("case", ["U1", "U3", "U3_cin3", "batch_dim_1",
                                  "nested_ExU", "unbatched_weight",
                                  "eval_ragged"])
def test_cnn_first_block_bits_equal_the_parent_chain(case):
    """The paper CNN's loss and every gradient through ``conv_pool``
    equal the parent's op chain bit for bit on the CPU."""
    if case in ("U1", "U3", "U3_cin3"):
        U, cin = (1, 1) if case == "U1" else (3, 3 if case == "U3_cin3"
                                               else 1)
        params, batch = _cohort(U, cin, 12, 4, seed=10 + U + cin)
        _same(_step(tm.apply_cnn, params, batch),
              _step(_parent_apply_cnn, params, batch))
    elif case == "batch_dim_1":
        params, batch = _cohort(3, 1, 8, 5, seed=20)
        batch = {"x": batch["x"].movedim(0, 1).contiguous(), "y": batch["y"]}
        dims = (0, {"x": 1, "y": 0})
        _same(_step(tm.apply_cnn, params, batch, dims),
              _step(_parent_apply_cnn, params, batch, dims))
    elif case == "nested_ExU":
        params, batch = _cohort(6, 1, 8, 3, seed=30)
        split = lambda t: t.unflatten(0, (2, 3))  # noqa: E731
        params = torch.utils._pytree.tree_map(split, params)
        batch = torch.utils._pytree.tree_map(split, batch)
        _same(_step(tm.apply_cnn, params, batch, nest=2),
              _step(_parent_apply_cnn, params, batch, nest=2))
    elif case == "unbatched_weight":
        params, batch = _cohort(1, 1, 8, 4, seed=40)
        one = torch.utils._pytree.tree_map(lambda t: t[0], params)
        x = batch["x"][0].reshape(4, 1, 64)  # a vmap over the examples
        _same(vmap(lambda xx: tm.apply_cnn(one, xx))(x),
              vmap(lambda xx: _parent_apply_cnn(one, xx))(x))
        g = grad_and_value(classification_loss(tm.apply_cnn))(
            one, {"x": batch["x"][0], "y": batch["y"][0]})
        _same(g, grad_and_value(classification_loss(_parent_apply_cnn))(
            one, {"x": batch["x"][0], "y": batch["y"][0]}))
    else:  # the evaluation: unbatched, no grad, a ragged last batch
        params, batch = _cohort(1, 1, 28, 11, seed=50)
        one = torch.utils._pytree.tree_map(lambda t: t[0], params)
        with torch.no_grad():
            for lo, hi in ((0, 8), (8, 11)):
                x = batch["x"][0, lo:hi]
                assert torch.equal(tm.apply_cnn(one, x),
                                   _parent_apply_cnn(one, x))


def test_conv_pool_has_no_input_gradient():
    x, w, b = _block_inputs("random", 2, 8, 8, 1, 8, seed=0)
    x.requires_grad_()
    with pytest.raises(NotImplementedError):
        tm.conv_pool(x, w.requires_grad_(), b).sum().backward()


#: the shapes the card runs: the cell's step (32 examples a user) and the
#: evaluation's 256 and last 232, the CIFAR variant, a narrow test CNN
PLAN_SHAPES = [(32, 28, 28, 1, 128), (256, 28, 28, 1, 128),
               (232, 28, 28, 1, 128), (32, 32, 32, 3, 128),
               (4, 8, 8, 1, 8), (9, 36, 34, 5, 8)]


@pytest.mark.parametrize("B,H,W,C,O", PLAN_SHAPES)
def test_conv_pool_plan(B, H, W, C, O):
    p = kcp.conv_pool_plan(B, H, W, C, O)
    assert p.rs >= W + 4 and p.rs % 32 not in (0, 1, 31)
    assert p.plane == (H + 4) * p.rs
    assert max(p.fwd_smem, p.grad_smem) <= kcp.SMEM_MAX
    assert p.cg == (3 if C % 3 == 0 else 1)
    P = (H // 2) * (W // 2)
    assert p.chunk == max(1, kcp.CHUNK_POSITIONS // P)
    assert (p.chunks - 1) * p.chunk < B <= p.chunks * p.chunk
    assert p.slab == min(P, kcp.SLAB) and p.ps % 2 == 1 and p.ps >= p.slab
    # the chunk (the reduction's cut) follows (H, W) alone, never B
    assert kcp.conv_pool_plan(1, H, W, C, O).chunk == p.chunk


@pytest.mark.parametrize("B,H,W,C,O", [(4, 28, 28, 1, 12), (4, 1, 8, 1, 8),
                                       (4, 28, 28, 64, 128)])
def test_conv_pool_plan_refuses_what_the_kernels_do_not_take(B, H, W, C, O):
    with pytest.raises(ValueError):
        kcp.conv_pool_plan(B, H, W, C, O)
