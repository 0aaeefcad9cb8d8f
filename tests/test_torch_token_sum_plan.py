"""The launch plan of the ``token_sum`` kernel (``kernels/token_sum.py::
token_sum_plan``) and the tree it computes, on the CPU.

The kernel cuts the adjacent-pair tree over P (N rounded up to a power
of two) into aligned chunks: each thread sums a run of tokens, a block
pairs its runs into a chunk's sum, and the last block of a row folds the
chunk sums, chunks wholly past N counting as +0.0. ``emulate`` follows
that cut with ``ref.token_sum_ref`` at every level; it must give the
bits of ``ref.token_sum_ref`` over the whole row for every plan, so the
plan may follow R, N and C to fill the card. ``chip_smoke.py`` holds the
kernel bit-equal to ``ref.token_sum_ref`` on the card.
"""
import ast
import os

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.token_sum import (MAX_RUN, SMS, THREADS,
                                           TokenSumPlan, _chunks, _plan,
                                           token_sum_plan)

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke_constant(name):
    """A literal constant of ``chip_smoke.py``, read off its source (the
    script exits without a card, so it is not imported)."""
    with open(os.path.join(HERE, "..", "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return [tuple(s) for s in ast.literal_eval(node.value)]
    raise KeyError(name)


CENSUS = _smoke_constant("TOKEN_SUM_CENSUS")
SHAPES = sorted(set(CENSUS) | set(_smoke_constant("TOKEN_SUM_SHAPES"))
                | set(_smoke_constant("TOKEN_SUM_EDGES")))


def pow2(n):
    return n >= 1 and n & (n - 1) == 0


def emulate(x, p: TokenSumPlan):
    """The kernel's cut of the tree under plan ``p``: runs, chunks of
    ``p.used`` runs, chunks past ``p.live`` as +0.0, the fold."""
    R, N, C = x.shape
    P = p.chunk * p.chunks
    if P != N:
        x = torch.cat([x, x.new_zeros((R, P - N, C))], dim=1)
    runs = ref.token_sum_ref(x.reshape(R * P // p.run, p.run, C))
    sums = ref.token_sum_ref(runs.reshape(R * p.chunks, p.used, C))
    sums = sums.reshape(R, p.chunks, C).clone()
    sums[:, p.live:] = 0.0
    folded = ref.token_sum_ref(sums.reshape(R * p.fold_used, p.fold_run, C))
    return ref.token_sum_ref(folded.reshape(R, p.fold_used, C))


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_tiles_the_tree(shape):
    """Powers of two everywhere, chunks that tile P exactly, a grid of
    R x live x tiles blocks of 256 threads, a fold of one run a thread;
    runs of at most MAX_RUN tokens, unless the fold would need more."""
    R, N, C = shape
    for align in (16, 8, 4):
        p = token_sum_plan(R, N, C, align)
        P = 1 << max(N - 1, 0).bit_length()
        assert all(pow2(v) for v in (p.lanes, p.slices, p.run, p.used,
                                     p.chunk, p.chunks, p.fold_run,
                                     p.fold_used))
        assert p.lanes <= 32 and p.lanes * p.slices == THREADS
        assert C % p.vec == 0 and align % (4 * p.vec) == 0
        assert p.lanes == min(32, 1 << max(C // p.vec - 1, 0).bit_length())
        assert p.tiles == -(-(C // p.vec) // p.lanes)
        assert p.used <= p.slices and p.run * p.used == p.chunk
        assert p.chunk * p.chunks == P
        assert p.live == max(1, -(-N // p.chunk)) <= p.chunks
        assert p.fold_run * p.fold_used == p.chunks
        assert p.fold_used <= p.slices and p.fold_run <= MAX_RUN
        assert p.run <= MAX_RUN or p.chunks == p.slices * MAX_RUN
        assert p.blocks == R * p.live * p.tiles


@pytest.mark.parametrize("shape", [s for s in CENSUS
                                   if 4 * s[0] * s[1] * s[2] >= 8 << 20])
def test_plan_fills_the_card_where_there_are_bytes(shape):
    """At every census shape of 8 MB or more: at least 2 blocks an SM,
    16-byte loads (C is a multiple of 4 there)."""
    p = token_sum_plan(*shape)
    assert p.blocks >= 2 * SMS and p.vec == 4


def test_plan_takes_vectors_only_where_c_and_pointers_allow():
    assert token_sum_plan(10, 4096, 2).vec == 2
    assert token_sum_plan(10, 4096, 256, align=8).vec == 2
    assert token_sum_plan(10, 4096, 256, align=4).vec == 1
    assert token_sum_plan(3, 37, 5).vec == 1
    with pytest.raises(ValueError):
        token_sum_plan(0, 4, 4)
    with pytest.raises(ValueError):
        _plan(10, 4096, 256, 16, chunk=8)


def _edges(x):
    """-0.0 in column 0, an inf in 1, a nan in 2, +inf and -inf in 3."""
    N = x.shape[1]
    x[:, :, 0] = -0.0
    x[:, N // 2, 1] = float("inf")
    x[:, N - 1, 2] = float("nan")
    x[:, 0, 3] = float("inf")
    x[:, N - 1, 3] = float("-inf")
    return x


@pytest.mark.parametrize("shape", [(2, 0, 5), (2, 1, 5), (3, 3, 5),
                                   (2, 37, 6), (2, 4096, 8), (3, 5000, 6),
                                   (2, 131072, 4)])
def test_every_plan_gives_the_trees_bits(shape):
    """The emulated cut equals ``token_sum_ref`` bit for bit under the
    default plan and under other chunks and vector widths, with -0.0,
    inf and nan columns; an all -0.0 column sums to +0.0 where N is not
    a power of two."""
    R, N, C = shape
    g = torch.Generator().manual_seed(N)
    x = torch.randn((R, N, C), generator=g)
    if N:
        x = _edges(x)
    want = ref.token_sum_ref(x)
    plans = set()
    for align in (16, 8, 4):
        p = token_sum_plan(R, N, C, align)
        plans |= {p, *(_plan(R, N, C, align, chunk)
                       for chunk in _chunks(p.chunk * p.chunks,
                                            p.slices)[::4])}
    for p in plans:
        assert torch.equal(bits(emulate(x, p)), bits(want)), p
    if N and N & (N - 1):
        assert bits(want[:, 0]).eq(0).all()      # +0.0, not -0.0
    if N:
        assert torch.isinf(want[:, 1]).all() and torch.isnan(want[:, 2]).all()
    if N > 1:
        assert torch.isnan(want[:, 3]).all()


def test_chunked_trees_are_the_tree_for_every_chunk():
    """The invariant itself: aligned chunks of B tokens, each chunk's
    tree, then the tree over the chunk sums, for B = 1 .. P."""
    g = torch.Generator().manual_seed(3)
    for N in (1, 3, 37, 100, 1000):
        x = _edges(torch.randn((2, N, 4), generator=g)) if N > 1 else \
            torch.randn((2, N, 4), generator=g)
        want = bits(ref.token_sum_ref(x))
        P = 1 << max(N - 1, 0).bit_length()
        pad = torch.cat([x, x.new_zeros((2, P - N, 4))], dim=1)
        B = 1
        while B <= P:
            sums = ref.token_sum_ref(pad.reshape(2 * P // B, B, 4))
            got = ref.token_sum_ref(sums.reshape(2, P // B, 4))
            assert torch.equal(bits(got), want), (N, B)
            B *= 2


def test_scratch_grows_and_keeps_the_buffers_it_replaced():
    """``build.scratch``, the fold's workspace of ``token_sum`` and
    ``delta_norm``: one pair a (device, stream), tickets zero, a larger
    request at least doubles a buffer and keeps the one it replaced (a
    launch captured in a CUDA graph may still point into it)."""
    from repro_torch.kernels import build
    dev, stream = torch.device("cpu"), 12345
    try:
        tk, pt = build.scratch(dev, stream, 10, 0)
        assert tk.numel() >= 1024 and pt.numel() >= 1024
        assert not tk.any() and tk.dtype == torch.int32
        assert build.scratch(dev, stream, 5, 5)[0] is tk
        tk2, pt2 = build.scratch(dev, stream, 1500, 2 * pt.numel() + 1)
        assert tk2.numel() == 2 * tk.numel() and not tk2.any()
        assert pt2.numel() == 2 * pt.numel() + 1
        assert any(t is tk for t in build._RETIRED)
        assert any(t is pt for t in build._RETIRED)
    finally:
        build._SCRATCH.pop((dev.index, stream), None)
        build._RETIRED[:] = [t for t in build._RETIRED if t.device != dev]
