"""Perf hill-climbing tool, counted on the meta device.

Port of ``repro/launch/hillclimb.py``: measures an (arch x shape) pair
under a combination of beyond-paper levers and reports the roofline
terms and per-device bytes, so each hypothesis -> change -> measure
cycle is one CLI call:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch gemma2-27b \\
      --shape train_4k --levers act_shard,flash_remat,chunked_loss:16

The counts are ``launch/dryrun.py``'s (one run of the full-depth step on
``meta`` under ``FlopCounterMode`` and a byte counter, the specs sized on
the production mesh's shape), with the mesh in context, so the mesh
levers take effect as in the reference. The port loops over layers, so
the direct count needs no depth fit (the dry run keeps the fit only as a
linearity check). Sets no environment variable.

Levers:
  act_shard           constrain block activations to (('data',), ...)
  flash_remat         recompute flash softmax chunks in backward
  chunked_loss:N      vocab-chunked CE with N chunks
  cache_hd_shard      shard decode-cache head_dim over 'model' when kv
                      heads don't divide it
  bounded_cache       ring caches of the window size (windowed archs)
  moe_ff_shard        MoE expert weights' F dim over 'data'
  moe_gather_weights  gather the expert weights whole over 'data'
  moe_buf_shard       constrain the (E, cap, D) buffer to (model, data)
  no_remat            disable layer-level remat (trade memory for flops)

The reference also accepts ``chunk:N`` and ignores it (the flash kv-chunk
size keeps its default of 1024); the port refuses it rather than ignore a
lever.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs.registry import get_config, get_shape
from repro_torch.launch.dryrun import (ByteCounter, count, count_params,
                                       measure_step)
from repro_torch.launch.hlo_analysis import roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import tree_leaves, tree_map


def apply_levers(cfg, levers):
    kw = {}
    cache_hd = False
    bounded = False
    moe_ff = "d"
    for lever in levers:
        if not lever:
            continue
        if lever == "act_shard":
            kw["shard_activations"] = ("data",)
        elif lever == "flash_remat":
            kw["flash_chunk_remat"] = True
        elif lever.startswith("chunked_loss"):
            n = int(lever.split(":")[1]) if ":" in lever else 16
            kw["loss_vocab_chunks"] = n
        elif lever == "cache_hd_shard":
            cache_hd = True
        elif lever == "bounded_cache":
            bounded = True
        elif lever == "moe_ff_shard":
            moe_ff = "f"
        elif lever == "moe_gather_weights":
            kw["moe_gather_weights"] = True
        elif lever == "moe_buf_shard":
            kw["moe_buf_shard"] = True
        elif lever == "no_remat":
            kw["remat"] = False
        elif lever.startswith("chunk:"):
            raise ValueError(
                f"lever {lever!r}: the flash kv-chunk size is fixed at "
                "1024 in this port (the reference ignores the lever)")
        else:
            raise ValueError(f"unknown lever {lever!r}")
    return dataclasses.replace(cfg, **kw), cache_hd, bounded, moe_ff


def measure(arch, shape_name, levers, multi_pod=False, cfg=None):
    """One (arch, shape) under ``levers``: the full-depth step's counts
    per device (an even split over the mesh's chips), the roofline and the
    per-device bytes of the arguments and outputs under their specs.
    ``cfg`` overrides the published config (a reduced one, in tests)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = get_shape(shape_name)
    cfg, cache_hd, bounded, moe_ff = apply_levers(cfg, levers)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size

    t0 = time.perf_counter()
    m = measure_step(cfg, shape, mesh, cache_shard_head_dim=cache_hd,
                     bounded_cache=bounded, moe_ff_shard=moe_ff)
    per_dev_bytes = m["args_bytes"] + m["out_bytes"]
    return {
        "arch": arch, "shape": shape_name, "levers": sorted(levers),
        "roofline": roofline_terms(m["flops"] / chips, m["bytes"] / chips,
                                   None),
        "flops_per_device": m["flops"] / chips,
        "bytes_per_device": m["bytes"] / chips,
        "collective_bytes_per_device": None,
        "per_device_bytes_total": int(per_dev_bytes),
        "per_device_gib": round(per_dev_bytes / 2**30, 2),
        "temp_gib": None,
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def measure_fl_silo(arch, variant="merge", extra_levers=(), cfg=None):
    """One FL round of ``core/silo.py::make_fl_round_step`` over 2
    stacked silo replicas (the multi-pod mesh's pod axis), train_4k's
    batch split between them, counted on meta under the mesh: local
    train + Eq. 2 priority (+ the gated merge). ``variant``: ``merge``
    (f32 deltas), ``local_only`` (a non-selected round: no merge),
    ``merge_bf16`` (bf16 delta transfer). ``merge_bytes``: the bytes of
    the deltas the silos hand the merge (every silo's, in the merge
    dtype), and ``merge_bytes_accessed`` what the merge reads and
    writes."""
    from repro_torch.core.silo import (make_fl_round_step, make_silo_merge,
                                       silo_batch_struct, stack_for_silos)
    from repro_torch.launch import steps as S

    cfg = get_config(arch) if cfg is None else cfg
    cfg, _, _, _ = apply_levers(cfg, extra_levers)
    shape = get_shape("train_4k")
    mesh = make_production_mesh(multi_pod=True)
    n_silos = mesh.shape["pod"]
    per_silo_batch = shape.global_batch // n_silos
    merge_dtype = "bfloat16" if variant == "merge_bf16" else "float32"

    step = make_fl_round_step(cfg, do_merge=False)
    pstruct = S.params_struct(cfg)
    stacked = stack_for_silos(pstruct, n_silos)
    batch = silo_batch_struct(cfg, n_silos, per_silo_batch, shape.seq_len)
    alphas = torch.empty((n_silos,), dtype=torch.float32, device="meta")

    t0 = time.perf_counter()
    with mesh:
        (_, local, _), flops, nbytes = count(step, stacked, batch, alphas)
        merge_bytes = merge_accessed = 0
        if variant != "local_only":
            merge = make_silo_merge(merge_dtype)
            traffic = ByteCounter()
            with torch.no_grad(), traffic:
                merge(local, tree_map(lambda p: p[0], stacked), alphas)
            merge_accessed = traffic.bytes
            item = torch.empty((), dtype=getattr(torch, merge_dtype)
                               ).element_size()
            merge_bytes = n_silos * count_params(pstruct) * item
    return {
        "arch": arch, "shape": "fl_round/train_4k", "levers": [variant],
        "n_silos": n_silos,
        "flops": flops, "bytes": nbytes,
        "merge_bytes": int(merge_bytes),
        "merge_bytes_accessed": int(merge_accessed),
        "params_bytes": int(sum(l.numel() * l.element_size()
                                for l in tree_leaves(pstruct))),
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--levers", default="", help="comma-separated")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fl-silo", default=None,
                    choices=["merge", "local_only", "merge_bf16"])
    ap.add_argument("--out", default=None, help="append JSON here")
    args = ap.parse_args(argv)

    levers = [l for l in args.levers.split(",") if l]
    if args.fl_silo:
        r = measure_fl_silo(args.arch, args.fl_silo, levers)
    else:
        r = measure(args.arch, args.shape, levers, args.multi_pod)
    print(json.dumps(r, indent=1))
    if args.out:
        rows = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                rows = json.load(f)
        rows.append(r)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return r


if __name__ == "__main__":
    main()
