"""The port's sharding rules, cohort predicates, mesh and mesh levers
(``repro_torch.sharding``, ``device.Mesh``, ``launch/mesh.py``) against
the JAX package's, on the CPU.

Specs are compared leaf by leaf as tuples (the reference's
``PartitionSpec`` read as a tuple) over the duck-typed mesh the
reference's own tests use (``FakeMesh``: the rules read only
``mesh.shape``), at the single-pod 16 x 16 and multi-pod 2 x 16 x 16
shapes, for every arch at its published dims. The mesh levers run both
packages on the same numpy params (reduced configs): without a mesh in
context both raise, under a 1-device mesh both give the lever-off loss,
bit for bit within each package and rtol 1e-5 across.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import INPUT_SHAPES as JS
from repro.configs.registry import ARCH_IDS, get_config as jget
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import model as jm
from repro.sharding import cohort as jc
from repro.sharding import rules as jr
from repro_torch.configs.base import INPUT_SHAPES as TS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.device import Mesh, current_mesh, with_sharding_constraint
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as tm
from repro_torch.sharding import cohort as tc
from repro_torch.sharding import rules as tr


class FakeMesh:
    """Duck-typed mesh: the rules read only ``mesh.shape[axis]``."""
    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_specs(spec_tree):
    """path -> tuple for a reference spec tree (a ``P`` is a leaf)."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in flat[0]}


def _port_specs(spec_tree):
    return dict(_paths(spec_tree))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh):
    """Every leaf's spec, with the baseline and the F-sharded MoE expert
    rules; the batch specs of every shape."""
    m = FakeMesh(MESHES[mesh])
    jstruct = jsteps.params_struct(jget(arch))
    tstruct = tsteps.params_struct(tget(arch))
    for ff in ("d", "f"):
        want = _ref_specs(jr.param_specs(jstruct, m, moe_ff_shard=ff))
        got = _port_specs(tr.param_specs(tstruct, m, moe_ff_shard=ff))
        assert got == want
    assert tr.batch_axes(m) == jr.batch_axes(m)
    for shape in JS:
        want = jr.batch_specs(jget(arch), JS[shape], m, jget(arch).family)
        got = tr.batch_specs(tget(arch), TS[shape], m, tget(arch).family)
        assert {k: tuple(v) for k, v in want.items()} == got


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch):
    """decode_32k (batch over data) and long_500k (the sequence over
    data), with and without the head-dim lever, on both mesh shapes."""
    for mesh in MESHES.values():
        m = FakeMesh(mesh)
        for shape in ("decode_32k", "long_500k"):
            lc = JS[shape].long_context
            jcs = jsteps.caches_struct(jget(arch), JS[shape], lc)
            tcs = tsteps.caches_struct(tget(arch), TS[shape], lc)
            seq = JS[shape].global_batch < mesh["data"]
            for hd in (False, True):
                want = _ref_specs(jr.cache_specs(jcs, jget(arch), m, seq,
                                                 shard_head_dim=hd))
                got = _port_specs(tr.cache_specs(tcs, tget(arch), m, seq,
                                                 shard_head_dim=hd))
                assert got == want


def test_guard_and_placements():
    """The divisibility guard; per device shapes and bytes (a padded
    last shard when a dim does not divide, as XLA pads)."""
    m = make_production_mesh()
    assert tr._guard(("data", "model"), (32, 25), m) == ("data", None)
    assert tr._guard(("data", "model"), (32, 25), FakeMesh(
        {"data": 16, "model": 16})) == jr._guard(("data", "model"), (32, 25),
                                                 FakeMesh({"data": 16,
                                                           "model": 16}))
    mm = make_production_mesh(multi_pod=True)
    t = torch.empty((64, 4096), dtype=torch.bfloat16, device="meta")
    assert tr.local_shape(t.shape, ("model", "data"), m) == (4, 256)
    assert tr.local_bytes(t, ("model", "data"), m) == 4 * 256 * 2
    assert tr.local_shape((4, 64), (None, ("pod", "data")), mm) == (4, 2)
    assert tr.local_shape((32, 64), ("model", "data"), mm) == (2, 4)
    assert tr.local_shape((32, 64), (), mm) == (32, 64)
    assert tr.local_shape((51865, 8), ("model",), m) == (3242, 8)


GRID = [(U, K, E, D) for U in (1, 2, 3, 8, 10, 12) for K in (1, 2, 4, 6)
        for E in (1, 2, 3, 4) for D in (1, 2, 3, 4)]


def test_cohort_predicates_match_the_reference():
    """Every predicate over a (U, K, E, axis size) grid, and the sweep's
    split dim against the reference's spec; no mesh and a mesh without a
    cohort axis shard nothing."""
    for U, K, E, D in GRID:
        jm_ = AbstractMesh((D,), ("cohort",))
        tm_ = Mesh(None, ("cohort",), shape=(D,))
        assert tc.shardable(U, tm_) == jc.shardable(U, jm_)
        assert tc.winner_shardable(K, tm_) == jc.winner_shardable(K, jm_)
        assert tc.sweep_shardable(E, U, tm_) == jc.sweep_shardable(E, U, jm_)
        spec = tuple(jc.sweep_sharding(jm_, E, U).spec)
        assert spec.index("cohort") == tc.sweep_sharding(tm_, E, U)
    other = Mesh(["cpu"], ("data",))
    for pred in (lambda m: tc.shardable(4, m),
                 lambda m: tc.winner_shardable(2, m),
                 lambda m: tc.sweep_shardable(2, 4, m)):
        assert not pred(None) and not pred(other)


def test_mesh_shape_context_and_constraint():
    """``Mesh``: ordered shape, size, devices (a device may repeat),
    shape-only meshes; ``with mesh:`` nests and restores; the constraint
    raises without a mesh, names unknown axes, and is the identity."""
    m = tc.cohort_mesh(["cpu", "cpu", "cpu"])
    assert list(m.shape.items()) == [("cohort", 3)] and m.size == 3
    assert m.device_list() == [torch.device("cpu")] * 3
    prod = make_production_mesh(multi_pod=True)
    assert list(prod.shape.items()) == [("pod", 2), ("data", 16),
                                        ("model", 16)]
    assert prod.devices is None and prod.size == 512
    host = make_host_mesh(device="cpu")
    assert list(host.shape.items()) == [("data", 1), ("model", 1)]
    x = torch.arange(6.0).reshape(2, 3)
    assert current_mesh() is None
    with pytest.raises(RuntimeError, match="non-empty mesh in context"):
        with_sharding_constraint(x, (("data",), None))
    with host:
        with prod:
            assert current_mesh() is prod
            assert with_sharding_constraint(x, (("pod", "data"), None)) is x
        assert current_mesh() is host
        with pytest.raises(ValueError, match="cohort"):
            with_sharding_constraint(x, ("cohort",))
        with pytest.raises(ValueError, match="rank"):
            with_sharding_constraint(x, ("data", None, None))
    assert current_mesh() is None
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if not torch.cuda.is_available():
            tc.cohort_mesh()
        else:
            raise RuntimeError("torch.cuda.is_available")


LEVERS = [("yi-9b", dict(shard_activations=("data",))),
          ("deepseek-v3-671b", dict(moe_gather_weights=True,
                                    moe_buf_shard=True))]


@pytest.mark.parametrize("arch,levers", LEVERS)
def test_mesh_levers_follow_the_reference(arch, levers):
    """Both packages on the same numpy params, 2 x 17 tokens: without a
    mesh in context each lever raises ``RuntimeError`` in both; under a
    1-device mesh each is a value no-op, the lever-off loss bit for bit
    within a package and rtol 1e-5 across the two (the reference's loss
    jitted, as its steps are). The port's MoE levers are also checked
    one at a time."""
    jbase, tbase = jget(arch).reduced(), tget(arch).reduced()
    # the port's draw (JAX's eager init of the MoE arch takes ~10 s),
    # as numpy, handed to both packages
    host = params_to_numpy(tm.init_params(0, tbase, device="cpu"))
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_numpy(host, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, jbase.vocab_size, (2, 17)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jloss = jax.jit(jm.compute_loss, static_argnums=2)
    j_off = float(jloss(jp, jb, jbase))
    t_off = float(tm.compute_loss(tp, tb, tbase))
    np.testing.assert_allclose(t_off, j_off, rtol=1e-5)
    jcfg = dataclasses.replace(jbase, **levers)
    with pytest.raises(RuntimeError, match="non-empty mesh"):
        jloss(jp, jb, jcfg)
    with j_host_mesh():
        j_on = float(jloss(jp, jb, jcfg))
    assert j_on == j_off
    # the port: the levers together and each alone
    for kw in [levers] + ([{k: v} for k, v in levers.items()]
                          if len(levers) > 1 else []):
        tcfg = dataclasses.replace(tbase, **kw)
        with pytest.raises(RuntimeError, match="non-empty mesh"):
            tm.compute_loss(tp, tb, tcfg)
        with make_host_mesh(device="cpu"):
            t_on = float(tm.compute_loss(tp, tb, tcfg))
        assert t_on == t_off
        np.testing.assert_allclose(t_on, j_on, rtol=1e-5)
