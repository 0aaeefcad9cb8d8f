"""CUDA kernel binding: the fixed-order token sum of the LLM local step.

The kernel is ``csrc/token_sum.cu``; no reference kernel stands behind
it (the reference's sums over a user's tokens are XLA's). It sums a
``(R, N, C)`` f32 tensor over N in the adjacent-pair tree of
``ref.token_sum_ref``, bit for bit, so row r's result follows its N
values alone and not R or C: a user's loss and norm gradients keep
their bits whether the local step stacks 10 users or a sweep's 30.

The tree over P (N rounded up to a power of two) is the same cut into
any aligned power-of-two chunks of B tokens, each chunk's tree first,
then the tree over the P / B chunk sums. ``token_sum_plan`` picks B (and
the block's layout) from (R, N, C) to fill the card; the bits do not
depend on it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import (check_launch, launch_stream, library,
                                       scratch)

#: threads a block (8 warps); the card's SMs
THREADS = 256
SMS = 132
#: a thread's run of tokens, at most (longer only where the fold would
#: otherwise take more than one run a thread); the plan starts there and
#: halves the chunk while the grid has fewer blocks than TARGET_BLOCKS (2
#: an SM) and a block would still read at least MIN_BLOCK_BYTES
MAX_RUN = 16
TARGET_BLOCKS = 2 * SMS
MIN_BLOCK_BYTES = 32 * 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class TokenSumPlan(NamedTuple):
    """One launch's geometry. ``vec`` columns a thread (a 16- or 8-byte
    load, else 1), ``lanes`` lanes a token (a power of two, at most 32),
    ``slices`` runs a block, ``tiles`` column tiles a row; a block sums
    a ``chunk`` of tokens (``used`` runs of ``run`` tokens), ``chunks``
    of them tile P, ``live`` hold a real token (the blocks of a row and
    tile); the last block of a (row, tile) folds the chunk sums as
    ``fold_used`` runs of ``fold_run``."""
    vec: int
    lanes: int
    slices: int
    tiles: int
    run: int
    used: int
    chunk: int
    chunks: int
    live: int
    fold_run: int
    fold_used: int
    blocks: int


def token_sum_plan(R: int, N: int, C: int, align: int = 16) -> TokenSumPlan:
    """The launch geometry for an ``(R, N, C)`` f32 sum whose operand
    pointers are ``align``-byte aligned. A plain function of its
    arguments (no device), so the CPU tests read it."""
    return _plan(R, N, C, align)


def _plan(R: int, N: int, C: int, align: int, chunk: int = None
          ) -> TokenSumPlan:
    """``token_sum_plan``, or the plan with a fixed ``chunk`` (one of
    ``_chunks``: the tests hold every such cut to the tree's bits)."""
    if R < 1 or N < 0 or C < 1:
        raise ValueError(f"token_sum_plan: no plan for ({R}, {N}, {C})")
    P = _pow2_at_least(N)
    vec = next(v for v in (4, 2, 1) if C % v == 0 and align % (4 * v) == 0)
    groups = C // vec
    lanes = min(_pow2_at_least(groups), 32)
    slices = THREADS // lanes
    tiles = -(-groups // lanes)
    width = min(lanes * vec, C) * 4           # bytes of a token in a tile
    chunks_ok = _chunks(P, slices)

    def live(b):
        return max(1, -(-N // b))
    if chunk is None:
        chunk = chunks_ok[-1]
        while (chunk // 2 in chunks_ok
               and R * tiles * live(chunk) < TARGET_BLOCKS
               and chunk // 2 * width >= MIN_BLOCK_BYTES):
            chunk //= 2
    elif chunk not in chunks_ok:
        raise ValueError(f"token_sum_plan: chunk {chunk} not in {chunks_ok}")
    used = min(slices, chunk)
    chunks = P // chunk
    fold_used = min(slices, chunks)
    return TokenSumPlan(
        vec=vec, lanes=lanes, slices=slices, tiles=tiles,
        run=chunk // used, used=used, chunk=chunk, chunks=chunks,
        live=live(chunk), fold_run=chunks // fold_used, fold_used=fold_used,
        blocks=R * tiles * live(chunk))


def _chunks(P: int, slices: int):
    """The chunks a plan may take, smallest first: powers of two from
    ``slices`` tokens (every run busy; P if smaller) to ``slices *
    MAX_RUN`` (runs of at most MAX_RUN; P if smaller), and at least P /
    (slices * MAX_RUN), so the fold takes one run of at most MAX_RUN a
    thread."""
    lo = min(P, max(slices, P // (slices * MAX_RUN)))
    hi = min(P, max(slices * MAX_RUN, P // (slices * MAX_RUN)))
    return [lo << k for k in range((hi // lo).bit_length())]


def _align(x: torch.Tensor) -> int:
    """The largest of 16, 8, 4 bytes that divides ``x``'s pointer."""
    return next(a for a in (16, 8, 4) if x.data_ptr() % a == 0)


def token_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """ONE launch: ``x`` (R, N, C) contiguous CUDA f32 -> ``(R, C)`` f32,
    each column's N values summed in the fixed tree."""
    if x.dim() != 3 or not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"token_sum: takes a (R, N, C) CUDA float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("token_sum: the operand must be contiguous")
    R, N, C = x.shape
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    if R == 0 or C == 0:
        return out
    p = token_sum_plan(R, N, C, _align(x))
    stream = launch_stream(x)
    tk, pt = scratch(x.device, stream, R * p.tiles,
                     R * p.live * C if p.chunks > 1 else 0)
    rc = library("token_sum").repro_token_sum(
        x.data_ptr(), out.data_ptr(), pt.data_ptr(), pt.numel(),
        tk.data_ptr(), tk.numel(), R, N, C, p.vec, p.lanes.bit_length() - 1,
        p.run.bit_length() - 1, p.used.bit_length() - 1,
        p.chunks.bit_length() - 1, p.fold_run.bit_length() - 1,
        p.fold_used.bit_length() - 1, stream)
    check_launch(rc, "token_sum")
    return out
