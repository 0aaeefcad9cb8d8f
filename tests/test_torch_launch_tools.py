"""The port's analysis tools (``launch/{hlo_analysis,dryrun,hillclimb}.py``)
on the CPU, counted on the meta device.

The reference's ``dryrun.py`` and ``hillclimb.py`` set ``XLA_FLAGS`` (512
host devices) when imported, which would change every later test of a
worker, so they are never imported: their pure functions
(``count_params``, ``active_params``, ``model_flops``, ``apply_levers``)
are compiled here from the reference's own source, alone. The dry run
and the hill climb run on reduced configs; the parameter counts and
model FLOPs are held to the reference's for every published arch x
shape.
"""
import ast
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs.base import INPUT_SHAPES as JS
from repro.configs.registry import ARCH_IDS, get_config as jget
from repro.launch import steps as jsteps
from repro_torch.configs.base import INPUT_SHAPES as TS
from repro_torch.configs.registry import get_config as tget
from repro_torch.launch import dryrun, hillclimb, hlo_analysis
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

REF_DIR = os.path.dirname(jsteps.__file__)


def _ref_functions(module, names):
    """The reference module's top-level functions ``names``, compiled from
    its source without running the module (no environment change)."""
    with open(os.path.join(REF_DIR, module)) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"jax": jax, "np": np, "dataclasses": dataclasses}
    exec(compile(ast.Module(body=body, type_ignores=[]), module, "exec"), ns)
    return {n: ns[n] for n in names}


REF = _ref_functions("dryrun.py", ("count_params", "active_params",
                                   "model_flops"))
REF_LEVERS = _ref_functions("hillclimb.py", ("apply_levers",))["apply_levers"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_match_the_reference(arch):
    """``count_params``, ``active_params`` and ``model_flops`` for every
    shape, the reference's on its struct and the port's on meta; both
    long-context structs too."""
    jc, tc = jget(arch), tget(arch)
    for lc in (False, True):
        js = jsteps.params_struct(jc, lc)
        ts = tsteps.params_struct(tc, lc)
        assert dryrun.count_params(ts) == REF["count_params"](js)
        n = dryrun.active_params(tc, ts)
        assert n == REF["active_params"](jc, js)
        for shape in JS:
            assert dryrun.model_flops(tc, TS[shape], n) == \
                REF["model_flops"](jc, JS[shape], n)


def test_roofline_and_collectives():
    """The H100 constants, the reference's formula, and the collective
    term, which the port does not measure (None, never dominant)."""
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    t = hlo_analysis.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == \
        (1.0, 2.0, 0.5) and t["dominant"] == "memory_s"
    t = hlo_analysis.roofline_terms(989e12 * 3, 3.35e12, None)
    assert t["collective_s"] is None and t["dominant"] == "compute_s"


def test_dry_run_counts_on_meta():
    """Reduced yi-9b: the depth fit equals the direct FLOP count; its
    per-device bytes on the 16 x 16 shape are the one-card bytes split;
    the decode and a MoE prefill count; nothing is set in the
    environment."""
    env = dict(os.environ)
    cfg = tget("yi-9b").reduced()
    r = dryrun.run_one("yi-9b", "train_4k", False, cfg=cfg)
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["linearity_rel_gap"]["flops"] < 1e-3
    assert r["params_total"] == dryrun.count_params(
        tsteps.params_struct(cfg))
    assert 0 < r["memory"]["per_device_args_bytes"] < \
        r["memory"]["one_card_args_bytes"]
    assert r["memory"]["per_device_temp_bytes"] is None
    assert r["collective_bytes_per_device"] is None
    assert r["counted_flops"] >= r["model_flops_global"] > 0
    d = dryrun.run_one("deepseek-v3-671b", "decode_32k", True,
                       cfg=tget("deepseek-v3-671b").reduced(), correct=False)
    assert d["status"] == "ok" and d["chips"] == 512 and d["counted_flops"] > 0
    # torch's meta decompositions import its compiler stack, which names
    # its own cache directory; nothing else may change
    assert {k: v for k, v in os.environ.items()
            if k != "TORCHINDUCTOR_CACHE_DIR"} == \
        {k: v for k, v in env.items() if k != "TORCHINDUCTOR_CACHE_DIR"}
    for mod in (dryrun, hillclimb):
        with open(mod.__file__) as f:
            assert "os.environ" not in f.read()


def test_dry_run_cli_sizes_every_arch(tmp_path):
    """``main`` with ``--lower-only``: every arch at decode_32k and
    long_500k on both meshes, whisper's long_500k skipped, the
    per-device bytes under the 16 x 16 and 2 x 16 x 16 specs below the
    one-card bytes; results written to ``--out`` and resumed from it."""
    out = tmp_path / "dry.json"
    argv = ["--shape", "long_500k", "--mesh", "both", "--lower-only",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 2 * len(ARCH_IDS)
    for r in rows:
        if r["arch"] == "whisper-small":
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "lowered"
        m = r["memory"]
        assert 0 < m["per_device_args_bytes"] < m["one_card_args_bytes"]
    assert dryrun.main(argv) == 0
    assert len(json.loads(out.read_text())) == 2 * len(ARCH_IDS)


def test_hill_climb_levers_and_silo_round():
    """The levers set the reference's fields and ``chunk:N``, which the
    reference ignores, is refused; the mesh levers run under the
    production mesh and leave the counted FLOPs as they are; the count
    is the full-depth step's own; the silo round's merge bytes: none
    locally, half in bf16."""
    cfg = tget("yi-9b").reduced()
    levers = ["act_shard", "flash_remat", "chunked_loss:4", "cache_hd_shard",
              "bounded_cache", "moe_ff_shard", "moe_gather_weights",
              "moe_buf_shard", "no_remat"]
    got = hillclimb.apply_levers(cfg, levers)
    want = REF_LEVERS(jget("yi-9b").reduced(), levers)
    for f in ("shard_activations", "flash_chunk_remat", "loss_vocab_chunks",
              "moe_gather_weights", "moe_buf_shard", "remat"):
        assert getattr(got[0], f) == getattr(want[0], f), f
    assert got[1:] == want[1:]
    with pytest.raises(ValueError, match="unknown lever"):
        hillclimb.apply_levers(cfg, ["bogus"])
    with pytest.raises(ValueError, match="kv-chunk size is fixed"):
        hillclimb.apply_levers(cfg, levers + ["chunk:512"])
    off = hillclimb.measure("yi-9b", "prefill_32k", [], cfg=cfg)
    on = hillclimb.measure("yi-9b", "prefill_32k", ["act_shard"], cfg=cfg)
    assert on["flops_per_device"] == off["flops_per_device"] > 0
    direct = dryrun.measure_step(cfg, TS["prefill_32k"],
                                 tmesh.make_production_mesh())
    assert off["flops_per_device"] == direct["flops"] / 256
    assert off["bytes_per_device"] == direct["bytes"] / 256
    pcfg = tget("phi3-mini-3.8b").reduced()
    silo = {v: hillclimb.measure_fl_silo("phi3-mini-3.8b", v, cfg=pcfg)
            for v in ("merge", "local_only", "merge_bf16")}
    assert silo["local_only"]["merge_bytes"] == 0
    assert silo["merge"]["merge_bytes"] == 2 * silo["merge_bf16"][
        "merge_bytes"] == 2 * 4 * dryrun.count_params(
            tsteps.params_struct(pcfg))
    assert silo["merge"]["flops"] == silo["local_only"]["flops"] > 0
