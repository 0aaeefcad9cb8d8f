"""Minimal pytree helpers over nested ``dict``s of tensors / arrays.

Leaves are visited in SORTED key order at every level — the order
``jax.tree.leaves`` gives the reference's parameter dicts — so the
Eq. 2 per-layer product and every leaf-wise op walk the same sequence
of layers in both packages.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """Flat list of leaves (sorted-key depth-first order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of structurally equal trees;
    returns a new tree of the same dict structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                raise ValueError("tree_map: pytree structures differ")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s dict structure holding ``leaves`` (in
    ``tree_leaves`` order) — the inverse of ``tree_leaves``."""
    leaves = list(leaves)
    if len(leaves) != len(tree_leaves(tree)):
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves for a tree "
                         f"of {len(tree_leaves(tree))}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
