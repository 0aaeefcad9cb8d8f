"""Logical-axis -> partition-spec rules (megatron-style FSDP x tensor).

Port of ``repro/sharding/rules.py`` over the port's parameter trees
(nested dicts, leaves in sorted-key order, the reference's paths) and
its ``device.Mesh``. A spec is a tuple with one entry per leading dim of
the leaf: a mesh axis name, a tuple of axis names (a dim split over
several axes), or None; the empty tuple replicates. It is the tuple of
the reference's ``PartitionSpec``.

Mesh axes:
  data  — FSDP/batch axis: parameters are *sharded* over it (fully
          sharded data parallel) and all-gathered per layer.
  model — tensor-parallel axis: attention heads / FFN hidden / experts /
          vocab.
  pod   — (multi-pod mesh only) the federation axis: one FL silo per
          pod. Parameters are conceptually per-silo, hence REPLICATED
          over 'pod'; batch shards over it.

Every rule is divisibility-guarded: if a dim doesn't divide by the mesh
axis size the axis is dropped for that dim (e.g. hymba's 25 heads or
whisper's 12 heads stay unsharded on a 16-way tensor axis while their
FFNs still shard). ``local_shape`` / ``local_bytes`` give a leaf's
per-device shape and bytes under its spec: what the dry run sizes. The
reference's ``to_shardings`` (its ``NamedSharding``s) has no counterpart:
nothing in the port places a tensor by a spec.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import Mesh

# name -> spec template for the *trailing* dims of the leaf
_RULES = {
    # embeddings / unembeddings
    "embedding": ("model", "data"),
    "w_out": ("data", "model"),
    # GQA attention
    "wq": ("data", "model", None),
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),
    # MLA
    "w_dkv": ("data", None),
    "w_krope": ("data", None),
    "w_uk": (None, "model", None),
    "w_uv": (None, "model", None),
    "w_dq": ("data", None),
    "w_uq": (None, "model", None),
    # dense MLP; the MoE-expert variants (leading E dim) are special-cased
    # by path in _leaf_spec
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "router": (None, "model"),
    # mamba2
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "A_log": ("model",),
    "dt_bias": ("model",),
    "D_skip": ("model",),
    # MTP projector
    "proj": ("data", None),
}

_MOE_EXPERT_RULES = {
    # (E, D, F): experts over model (expert parallelism), D over data
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}

_MOE_EXPERT_RULES_F = {
    # megatron-style: the ffn hidden dim F over 'data' instead
    "w_gate": ("model", None, "data"),
    "w_up": ("model", None, "data"),
    "w_down": ("model", "data", None),
}


def _guard(spec_dims, shape, mesh: Mesh):
    """Drop axes whose size doesn't divide the dim."""
    out = []
    for dim, ax in zip(shape, spec_dims):
        if ax is None:
            out.append(None)
        else:
            size = mesh.shape[ax]
            out.append(ax if dim % size == 0 else None)
    return tuple(out)


def _leaf_spec(path, leaf, mesh: Mesh, moe_ff_shard: str = "d"):
    """The spec of one leaf at ``path`` (its dict keys, root first)."""
    names = [str(p) for p in path]
    name = names[-1] if names else None
    if "moe" in names and name in _MOE_EXPERT_RULES and "shared" not in names:
        rules = (_MOE_EXPERT_RULES_F if moe_ff_shard == "f"
                 else _MOE_EXPERT_RULES)
        rule = rules[name]
    else:
        rule = _RULES.get(name)
    if rule is None:
        return ()  # replicate (norm scales, biases, small scalars)
    lead = leaf.dim() - len(rule)
    if lead < 0:  # smaller than the rule -> replicate
        return ()
    return (None,) * lead + _guard(rule, leaf.shape[lead:], mesh)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def param_specs(params, mesh: Mesh, moe_ff_shard: str = "d"):
    """Spec tree for a param tree (leading layer-stack dims map to None
    automatically)."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf, mesh, moe_ff_shard),
        params)


# --------------------------------------------------------------- batches
def batch_axes(mesh: Mesh):
    """The (composite) batch axis: ('pod','data') on the multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _dim_ok(dim, axes, mesh):
    return dim % math.prod(mesh.shape[a] for a in axes) == 0


def batch_specs(cfg, shape_cfg, mesh: Mesh, family: str):
    """Specs for the input batch of each step kind."""
    ba = batch_axes(mesh)
    B = shape_cfg.global_batch

    def bdim(dim):
        return ba if _dim_ok(dim, ba, mesh) else (
            ("data",) if dim % mesh.shape["data"] == 0 else None)

    b = bdim(B)
    # one axis stands alone, as a PartitionSpec normalises ('data',)
    bspec = b if b is None or len(b) > 1 else b[0]
    tok_spec = (bspec, None) if bspec else (None, None)

    specs = {"tokens": tok_spec}
    if family == "vlm":
        specs["patches"] = (bspec, None, None) if bspec else ()
    if family == "audio":
        specs["frames"] = (bspec, None, None) if bspec else ()
    return specs


def cache_specs(caches, cfg, mesh: Mesh, seq_sharded: bool,
                shard_head_dim: bool = False):
    """Specs for layer-stacked decode caches.

    seq_sharded=True (long_500k, batch=1): the cache *sequence* dim
    shards over 'data' (flash-decode style). Otherwise batch shards over
    'data' and kv-heads over 'model' when divisible.

    shard_head_dim=True (beyond-paper lever): when kv-heads don't divide
    the tensor axis (GQA with few kv heads), shard the *head_dim* over
    'model' instead of replicating the whole cache per device.
    """
    data = mesh.shape["data"]
    model = mesh.shape["model"]

    def spec(path, leaf):
        name = str(path[-1]) if path else None
        # leaves: k/v (L,B,C,Kv,Dh) | pos (L,C) | cross_k/v (L,B,T,Kv,Dh)
        # conv (L,B,W-1,C) | state (L,B,H,P,N)
        if name in ("k", "v", "cross_k", "cross_v"):
            L, B, C, Kv, Dh = leaf.shape
            bax = "data" if (B % data == 0 and not seq_sharded) else None
            sax = "data" if (seq_sharded and C % data == 0) else None
            hax = "model" if Kv % model == 0 else None
            dax = None
            if shard_head_dim and hax is None and Dh % model == 0:
                dax = "model"
            return (None, bax, sax, hax, dax)
        if name == "pos":
            return ()
        if name == "conv":
            L, B, W, Cc = leaf.shape
            bax = "data" if B % data == 0 else None
            cax = "model" if Cc % model == 0 else None
            return (None, bax, None, cax)
        if name == "state":
            L, B, H, Pd, N = leaf.shape
            bax = "data" if B % data == 0 else None
            hax = "model" if H % model == 0 else None
            return (None, bax, hax, None, None)
        return ()

    return _map_with_path(spec, caches)


# -------------------------------------------------------- per-device sizes
def _axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh: Mesh):
    """A leaf's per-device shape under ``spec`` on ``mesh``: each dim
    divided by the sizes of the axes its entry names, rounded up (a dim
    that does not divide pads its last shard, as XLA does)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes_of(entry))
        out[d] = -(-out[d] // n)
    return tuple(out)


def local_bytes(leaf: torch.Tensor, spec, mesh: Mesh) -> int:
    """A leaf's per-device bytes under ``spec`` on ``mesh``."""
    return (math.prod(local_shape(leaf.shape, spec, mesh))
            * leaf.element_size())
