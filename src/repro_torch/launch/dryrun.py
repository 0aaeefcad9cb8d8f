"""Dry run: count every (arch x shape x mesh) step on the meta device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each step on 512 placeholder TPU host devices and reads XLA's cost and
memory analyses. Here "lower and compile" is: run the step once on the
``meta`` device (shapes and dtypes, no allocation, no arithmetic) under
``torch.utils.flop_counter.FlopCounterMode`` and a byte counter. Sets no
environment variable and touches no accelerator, so it runs on any
CPU:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch yi-9b --shape train_4k --mesh single

What each figure is:
  * ``counted_flops``: the matmul / attention FLOPs ``FlopCounterMode``
    counts for the whole step, forward and backward (elementwise ops are
    not counted; XLA's ``flops`` counts them). The port loops over
    layers in Python, so the count has no scan-once undercount;
    ``corrected_costs`` still fits the depth-2 / depth-4 variants, and
    ``linearity_rel_gap`` holds its extrapolation against the direct
    count, FLOPs and bytes apart (the reference's linearity claim,
    checked in the port: a training step's bytes are not linear in
    depth, as the backward of a layer-stacked leaf's per-layer slice
    writes the whole stack).
  * ``counted_bytes``: the bytes every aten op reads and writes (inputs
    plus outputs; views and allocations move none): the eager program's
    traffic, the analogue of XLA's ``bytes accessed`` without fusion.
  * per-device figures divide the global counts by the mesh's chips (an
    even split: one process has no SPMD partitioner), and the memory
    figures size each argument and output under its sharding spec on
    the chosen mesh (``sharding/rules.py``), as the reference's
    ``NamedSharding``s place them. Temporaries and collectives are not
    counted (``None``, each with a reason).
  * the roofline uses the H100's constants (``launch/mesh.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import (ARCH_IDS, LONG_CONTEXT_VARIANT,
                                          SKIPS, get_config, get_shape)
from repro_torch.device import Mesh
from repro_torch.launch import steps as S
from repro_torch.launch.hlo_analysis import roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.rules import (batch_axes, batch_specs, cache_specs,
                                        local_bytes, param_specs)
from repro_torch.tree import tree_leaves

#: one card: every argument whole on it
ONE_CARD = Mesh(None, ("data", "model"), shape=(1, 1))

NOT_COUNTED = {
    "temp": "meta tensors have no allocator: the step's temporaries are "
            "not sized",
    "collectives": "one process runs the whole step: no SPMD partitioner "
                   "inserts collectives to count",
}


def _with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_path(tree[k], path + (k,))
    else:
        yield path, tree


def count_params(struct_tree):
    return int(sum(l.numel() for l in tree_leaves(struct_tree)))


def active_params(cfg, struct_tree):
    """MoE: total minus the inactive routed-expert fraction."""
    if not cfg.num_experts:
        return count_params(struct_tree)
    total = 0
    expert = 0
    for names, leaf in _with_path(struct_tree):
        n = leaf.numel()
        total += n
        if "moe" in names and any(
                nm in ("w_gate", "w_up", "w_down") for nm in names):
            expert += n
    inactive_frac = 1.0 - cfg.experts_per_token / cfg.num_experts
    return int(total - expert * inactive_frac)


def model_flops(cfg, shape, n_active):
    """6*N*D (train) / 2*N*D (prefill/decode) useful-FLOPs yardstick."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token


#: ops that allocate or describe and move no data
_FREE = {torch.ops.aten.empty.memory_format,
         torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default}


class ByteCounter(TorchDispatchMode):
    """Bytes every aten op reads and writes: its tensor inputs and
    outputs, once each; view ops and allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _FREE:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _pt_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(fn, *args):
    """``fn(*args)`` under the counters: ``(outputs, flops, bytes)``."""
    flops = FlopCounterMode(display=False)
    traffic = ByteCounter()
    with flops, traffic:
        out = fn(*args)
    return out, float(flops.get_total_flops()), float(traffic.bytes)


def param_bytes(cfg, mesh=ONE_CARD, long_context=False,
                moe_ff_shard="d"):
    """Per-device bytes of the params under their specs on ``mesh`` (on
    one card: every param's bytes)."""
    pstruct = S.params_struct(cfg, long_context)
    return int(_bytes_under(pstruct, param_specs(
        pstruct, mesh, moe_ff_shard=moe_ff_shard), mesh))


def build_step(cfg, shape, mesh, cache_shard_head_dim=False,
               bounded_cache=False, moe_ff_shard="d"):
    """The step of ``shape``'s kind on meta inputs: ``(fn, args,
    arg_specs, out_specs, pstruct)``, the specs a tuple parallel to the
    args and to the outputs (the reference's in / out shardings)."""
    long_context = shape.long_context
    pstruct = S.params_struct(cfg, long_context)
    pspecs = param_specs(pstruct, mesh, moe_ff_shard=moe_ff_shard)
    bspecs = batch_specs(cfg, shape, mesh, cfg.family)
    ba = batch_axes(mesh)
    B = shape.global_batch
    if shape.kind == "train":
        batch = S.input_specs(cfg, shape)
        fn = S.make_train_step(cfg, long_context=long_context)
        return (fn, (pstruct, batch),
                (pspecs, {k: bspecs.get(k, ()) for k in batch}),
                ((), pspecs), pstruct)
    if shape.kind == "prefill":
        batch = S.input_specs(cfg, shape)
        cstruct = S.caches_struct(cfg, shape, long_context)
        cspecs = cache_specs(cstruct, cfg, mesh, seq_sharded=False,
                             shard_head_dim=cache_shard_head_dim)
        lead = ba if B % math.prod(mesh.shape[a] for a in ba) == 0 else None
        fn = S.make_prefill_step(cfg, long_context=long_context)
        return (fn, (pstruct, cstruct, batch),
                (pspecs, cspecs, {k: bspecs.get(k, ()) for k in batch}),
                ((lead, "model"), cspecs), pstruct)
    cstruct = S.caches_struct(cfg, shape, long_context, bounded=bounded_cache)
    seq_sharded = B < mesh.shape["data"]
    cspecs = cache_specs(cstruct, cfg, mesh, seq_sharded=seq_sharded,
                         shard_head_dim=cache_shard_head_dim)
    dec = S.input_specs(cfg, shape)
    bdata = "data" if B % mesh.shape["data"] == 0 else None
    fn = S.make_serve_step(cfg, long_context=long_context)
    return (fn, (pstruct, cstruct, dec["token"], dec["index"]),
            (pspecs, cspecs, (bdata,), ()), ((bdata, "model"), cspecs),
            pstruct)


def _bytes_under(tree, specs, mesh):
    """Per-device bytes of a tree of tensors under its parallel specs."""
    if isinstance(tree, dict):
        return sum(_bytes_under(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (tuple, list)):
        return sum(_bytes_under(t, s, mesh) for t, s in zip(tree, specs))
    return local_bytes(tree, specs, mesh)


def measure_step(cfg, shape, mesh, cache_shard_head_dim=False,
                 bounded_cache=False, moe_ff_shard="d", run=True):
    """Build the step, size its arguments and outputs under their specs
    on ``mesh`` (and on one card), and (``run``) count it once on meta
    under ``mesh`` in context. Returns a dict."""
    fn, args, arg_specs, out_specs, pstruct = build_step(
        cfg, shape, mesh, cache_shard_head_dim, bounded_cache, moe_ff_shard)
    _, one_args, one_specs, _, _ = build_step(
        cfg, shape, ONE_CARD, cache_shard_head_dim, bounded_cache,
        moe_ff_shard)
    res = {"pstruct": pstruct,
           "args_bytes": int(_bytes_under(list(args), list(arg_specs), mesh)),
           "param_bytes": int(_bytes_under(args[0], arg_specs[0], mesh)),
           "one_card_args_bytes": int(_bytes_under(
               list(one_args), list(one_specs), ONE_CARD))}
    if not run:
        return res
    with mesh:
        with (contextlib.nullcontext() if shape.kind == "train"
              else torch.no_grad()):
            outs, flops, nbytes = count(fn, *args)
    res.update(flops=flops, bytes=nbytes,
               out_bytes=int(_bytes_under(list(outs), list(out_specs), mesh)))
    return res


# --------------------------------------------------------------- correction
# The reference's XLA counts a lax.scan body ONCE, so it fits small
# unrolled depth variants and extrapolates. The port counts every layer;
# the same fit is kept, and its extrapolation held against the direct
# count (``linearity_rel_gap``).

def depth_variants(cfg):
    """(full_counts, build_fn) for the arch's layer groups."""
    if cfg.is_encdec:
        full = {"dec": cfg.num_layers, "enc": cfg.encoder_layers}

        def build(d):
            return dataclasses.replace(
                cfg, num_layers=d["dec"], encoder_layers=d["enc"],
                scan_unroll=4)
    elif cfg.num_experts and cfg.first_dense_layers:
        full = {"dense": cfg.first_dense_layers,
                "moe": cfg.num_layers - cfg.first_dense_layers}

        def build(d):
            return dataclasses.replace(
                cfg, first_dense_layers=d["dense"],
                num_layers=d["dense"] + d["moe"], scan_unroll=4)
    else:
        full = {"layers": cfg.num_layers}

        def build(d):
            return dataclasses.replace(cfg, num_layers=d["layers"],
                                       scan_unroll=4)
    return full, build


def _measure(cfg_v, shape, mesh, cache_shard_head_dim=False,
             bounded_cache=False, moe_ff_shard="d"):
    m = measure_step(cfg_v, shape, mesh, cache_shard_head_dim,
                     bounded_cache, moe_ff_shard)
    return np.array([m["flops"], m["bytes"]])


def corrected_costs(cfg, shape, mesh, cache_shard_head_dim=False,
                    bounded_cache=False, moe_ff_shard="d"):
    # base depth 2 per group, bumping one group to 4 at a time (the
    # reference's variants)
    full, build = depth_variants(cfg)
    base_depths = {g: 2 for g in full}
    c0 = _measure(build(base_depths), shape, mesh, cache_shard_head_dim,
                  bounded_cache, moe_ff_shard)
    slopes = {}
    for g in full:
        d = dict(base_depths)
        d[g] = 4
        slopes[g] = (_measure(build(d), shape, mesh, cache_shard_head_dim,
                              bounded_cache, moe_ff_shard) - c0) / 2.0
    intercept = c0 - 2.0 * sum(slopes.values())
    corrected = intercept + sum(full[g] * slopes[g] for g in full)
    corrected = np.maximum(corrected, 0.0)
    return {
        "flops": float(corrected[0]),
        "bytes": float(corrected[1]),
        "coll_bytes": None,
        "per_layer_slopes": {g: s.tolist() for g, s in slopes.items()},
    }


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            lower_only: bool = False, correct: bool = True, cfg=None):
    """Count one (arch, shape, mesh). Returns a result dict. ``cfg``
    overrides the published config (a reduced one, in tests)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = get_shape(shape_name)
    mesh_name = "multi" if multi_pod else "single"
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    variant = (shape.long_context and arch in LONG_CONTEXT_VARIANT)

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.perf_counter()
    m = measure_step(cfg, shape, mesh, run=not lower_only)
    n_total = count_params(m["pstruct"])
    n_active = active_params(cfg, m["pstruct"])
    memory = {"per_device_args_bytes": m["args_bytes"],
              "per_device_param_bytes": m["param_bytes"],
              "one_card_args_bytes": m["one_card_args_bytes"]}
    if lower_only:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "lowered", "params_total": n_total,
                "params_active": n_active, "memory": memory,
                "lower_s": round(time.perf_counter() - t0, 1)}
    t_count = time.perf_counter() - t0
    memory.update(per_device_output_bytes=m["out_bytes"],
                  per_device_temp_bytes=None,
                  temp_reason=NOT_COUNTED["temp"])
    mf = model_flops(cfg, shape, n_active)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "variant_window": bool(variant),
        "chips": chips,
        "params_total": n_total, "params_active": n_active,
        "count_s": round(t_count, 1),
        "memory": memory,
        "counted_flops": m["flops"], "counted_bytes": m["bytes"],
        "flops_per_device": m["flops"] / chips,
        "bytes_per_device": m["bytes"] / chips,
        "collective_bytes_per_device": None,
        "collectives_reason": NOT_COUNTED["collectives"],
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(m["flops"], 1.0),
        "roofline": roofline_terms(m["flops"] / chips, m["bytes"] / chips,
                                   None),
        "roofline_one_card": roofline_terms(m["flops"], m["bytes"], None),
    }
    if correct:
        corr = corrected_costs(cfg, shape, mesh)
        result["corrected"] = corr
        result["linearity_rel_gap"] = {
            "flops": _rel(corr["flops"], m["flops"]),
            "bytes": _rel(corr["bytes"], m["bytes"])}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="examples/out/dryrun_torch.json")
    ap.add_argument("--lower-only", action="store_true",
                    help="build and size the step's arguments; count "
                         "nothing")
    ap.add_argument("--no-correct", action="store_true",
                    help="skip the depth-variant fit")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.shape == "all" else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "multi" if mp else "single")
                if key in done:
                    print(f"[skip-done] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    r = run_one(arch, shape, mp, args.lower_only,
                                correct=not args.no_correct)
                except Exception as e:
                    r = {"arch": arch, "shape": shape,
                         "mesh": "multi" if mp else "single",
                         "status": "error",
                         "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                print(json.dumps({k: v for k, v in r.items()
                                  if k not in ("trace", "corrected",
                                               "memory")}),
                      flush=True)
                results = [x for x in results
                           if (x["arch"], x["shape"], x["mesh"]) != key]
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    bad = [r for r in results if r.get("status") == "error"]
    print(f"\n{len(results)} results, {len(bad)} errors")
    for r in bad:
        print("ERROR:", r["arch"], r["shape"], r["mesh"], r["error"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
