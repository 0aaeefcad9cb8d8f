"""Byte counts of the port's kernels on the FL round, from shapes: each
input byte read once, each output byte written once (the least any
kernel could move); ``item`` is the bytes of one parameter in the
configuration's ``param_dtype``. Over ``peaks.HBM_BW`` they give a
launch's bound."""
from __future__ import annotations


def fused_sgd_bytes(rows: int, params: int, item: int = 4) -> int:
    """One ``sgd_leaves_kernel`` launch over a (rows, params) stack: every
    parameter and gradient read once, every parameter written once."""
    return 3 * rows * params * item


def delta_norm_bytes(rows: int, params: int, leaves: int,
                     item: int = 4) -> int:
    """One ``delta_norm_kernel`` launch (Eq. 2's sums): the (rows,
    params) stack and the global read once, the (leaves, rows) distances
    and (leaves,) global norms written once, f32."""
    return (rows + 1) * params * item + 4 * leaves * (rows + 1)


def combine_bytes(k: int, params: int, item: int = 4) -> int:
    """One Eq. 1 ``combine_kernel`` launch per leaf of ``params``
    elements: the k merged rows read once, the new global written once."""
    return (k + 1) * params * item
