"""The port's optimisers and Eq. 3 backoff (``repro_torch.optim``,
``repro_torch.core.priority.backoff_time``) against the JAX package's,
on the CPU, from the same numpy trees.

Bars: the cases of ``tests/test_optim.py`` through both packages at
``rtol=1e-6``; AdamW over three steps (f32 and bf16 params, with and
without weight decay) at ``rtol=1e-6``; the schedules at every step of a
short horizon, exactly. ``server_opt`` kind 1 (FedAvgM) on the
pseudo-gradient ``d = old - avg`` is ``sgd_momentum_update`` bit for bit
(the reference holds it at rtol 1e-6, ``tests/test_objectives.py``).
The backoff draw matches the reference in law only: the mean of
``R * W`` over many draws is ``W / 2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core.priority import backoff_time as j_backoff
from repro_torch import optim as topt
from repro_torch.core.priority import backoff_time, contention_window
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map
from torch_port_util import bits


def _tree(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(dtype),
            "b": rng.normal(size=(3,)).astype(dtype),
            "outer": {"k": rng.normal(size=(2, 5)).astype(dtype)}}


def _t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _close(t, j, rtol=1e-6):
    tl, jl = tree_leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=1e-7)


def test_exports_match_the_reference():
    names = [n for n in dir(jopt) if not n.startswith("_")
             and callable(getattr(jopt, n))]
    assert sorted(names) == sorted(
        n for n in dir(topt) if not n.startswith("_")
        and callable(getattr(topt, n)))


def test_sgd_update_law():
    p, g = _tree(0), _tree(1)
    want = jopt.sgd_update(_j(p), _j(g), lr=0.1, use_kernel=False)
    _close(topt.sgd_update(_t(p), _t(g), 0.1), want)


def test_momentum_init_zeros_like():
    p = _t(_tree(0))
    m = topt.sgd_momentum_init(p)
    jm = jopt.sgd_momentum_init(_j(_tree(0)))
    for a, b, q in zip(tree_leaves(m), jax.tree.leaves(jm), tree_leaves(p)):
        assert a.shape == q.shape == b.shape and a.dtype == q.dtype
        assert not a.any() and a.data_ptr() != q.data_ptr()


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_momentum_update_law(momentum):
    """new_m = momentum * m + g; new_p = p - lr * new_m; momentum 0 is
    plain SGD with m' = g exactly. The inputs are left as they were."""
    p, g, m = _tree(0), _tree(1), _tree(2)
    tp, tm_ = _t(p), _t(m)
    new_p, new_m = topt.sgd_momentum_update(tp, _t(g), tm_, lr=0.05,
                                            momentum=momentum)
    jp, jm = jopt.sgd_momentum_update(_j(p), _j(g), _j(m), lr=0.05,
                                      momentum=momentum)
    _close(new_p, jp)
    _close(new_m, jm)
    _close(tp, _j(p), rtol=0)
    _close(tm_, _j(m), rtol=0)
    if momentum == 0.0:
        for a, b in zip(tree_leaves(new_m), tree_leaves(_t(g))):
            assert torch.equal(a, b)
        plain = topt.sgd_update(_t(p), _t(g), 0.05)
        _close(new_p, jax.tree.map(np.asarray, tree_map(
            lambda a: a.numpy(), plain)))


def test_momentum_accumulates_across_steps():
    """Two steps with a constant gradient: m_2 = (1 + beta) g, in both
    packages."""
    p, g = _tree(0), _tree(1)
    tp, tm_ = _t(p), topt.sgd_momentum_init(_t(p))
    jp, jm = _j(p), jopt.sgd_momentum_init(_j(p))
    for _ in range(2):
        tp, tm_ = topt.sgd_momentum_update(tp, _t(g), tm_, lr=0.1)
        jp, jm = jopt.sgd_momentum_update(jp, _j(g), jm, lr=0.1)
    _close(tp, jp)
    _close(tm_, jm)
    for a, b in zip(tree_leaves(tm_), tree_leaves(_t(g))):
        np.testing.assert_allclose(a.numpy(), 1.9 * b.numpy(), rtol=1e-6)


def test_momentum_preserves_tree_structure():
    p = {"outer": {"w": torch.ones((2, 2))}, "b": torch.zeros((2,))}
    g = tree_map(torch.ones_like, p)
    new_p, new_m = topt.sgd_momentum_update(p, g, topt.sgd_momentum_init(p),
                                            lr=0.1)
    for t in (new_p, new_m):
        assert sorted(t) == ["b", "outer"] and sorted(t["outer"]) == ["w"]


@pytest.mark.parametrize("dtype,wd", [("float32", 0.0), ("float32", 0.01),
                                      ("bfloat16", 0.01)])
def test_adamw_matches_the_reference(dtype, wd):
    """Three AdamW steps from the same params and gradients: params,
    f32 moments and the int32 count."""
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tp, jp = _t(_tree(0), td), _j(_tree(0), jd)
    ts, js = topt.adamw_init(tp), jopt.adamw_init(jp)
    assert ts["count"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts["mu"]))
    for step in range(3):
        g = _tree(10 + step)
        tp, ts = topt.adamw_update(tp, _t(g, td), ts, 1e-2, weight_decay=wd)
        jp, js = jopt.adamw_update(jp, _j(g, jd), js, 1e-2, weight_decay=wd)
        assert all(p.dtype == td for p in tree_leaves(tp))
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
        _close(ts["nu"], js["nu"])
        assert int(ts["count"]) == int(js["count"]) == step + 1


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (3e-2,)),
    ("cosine_lr", (3e-2, 10)),
    ("cosine_lr", (1e-3, 7, 0.0)),
    ("warmup_cosine_lr", (3e-2, 3, 12)),
    ("warmup_cosine_lr", (1e-2, 0, 5, 0.2))])
def test_schedules_equal_the_reference_at_every_step(name, args):
    """Every step of the horizon and past it (the int step, and the step
    as a 0-dim int32 tensor / array): the same f32 bits."""
    ts, js = getattr(topt, name)(*args), getattr(jopt, name)(*args)
    for step in range(16):
        got = ts(step)
        assert got.dtype == torch.float32 and got.shape == ()
        want = np.array(js(step), np.float32)
        assert bits(got) == bits(torch.from_numpy(want)), (step, got, want)
        arr = ts(torch.tensor(step, dtype=torch.int32))
        jarr = np.array(js(jnp.asarray(step, jnp.int32)), np.float32)
        assert bits(arr) == bits(torch.from_numpy(jarr)), step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_opt_momentum_is_sgd_momentum_update_bitwise(dtype):
    """``server_opt`` kind 1 (FedAvgM: beta1 0.9, server_lr 0.5) on the
    pseudo-gradient ``d = old - avg`` gives ``sgd_momentum_update``'s
    bits: ``m' = 0.9 m + d``, ``p' = old - 0.5 m'``; ``v`` passes
    through. The plain version here; the kernel on the card in
    ``chip_smoke.py``."""
    rng = np.random.default_rng(3)
    avg, old, m = (torch.from_numpy(rng.normal(size=(8, 3, 5)).astype(
        np.float32)).to(dtype) for _ in range(3))
    v = torch.zeros_like(m)
    consts = np.asarray([1, 0.9, 0.0, 0.5, 1e-3], np.float32)
    out, nm, nv = ops.server_opt_combine(avg, old, m, v, consts)
    d = old - avg
    want_p, want_m = topt.sgd_momentum_update({"p": old}, {"p": d},
                                              {"p": m}, lr=0.5, momentum=0.9)
    if dtype == torch.float32:
        assert np.array_equal(bits(out), bits(want_p["p"]))
        assert np.array_equal(bits(nm), bits(want_m["p"]))
    else:
        # bf16 leaves: the kernel's law is f32 arithmetic cast back, the
        # momentum law's the same ops on the f32 copies
        f = {k: x.float() for k, x in dict(avg=avg, old=old, m=m).items()}
        wp, wm = topt.sgd_momentum_update(
            {"p": f["old"]}, {"p": f["old"] - f["avg"]}, {"p": f["m"]},
            lr=0.5, momentum=0.9)
        assert np.array_equal(bits(out), bits(wp["p"].to(dtype)))
        assert np.array_equal(bits(nm), bits(wm["p"].to(dtype)))
    assert torch.equal(nv, v)


def test_backoff_time_law():
    """``R * W`` with ``R ~ U(0, 1)``: every draw in [0, W); over 20 000
    draws the mean is W / 2 within 4 standard errors, in both packages
    (threefry and a ``torch.Generator`` agree in law, not in draws); a
    seeded generator repeats its draws."""
    prio, N, n = torch.tensor(1.1), 1024.0, 20_000
    W = float(contention_window(prio, N))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([backoff_time(prio, N, gen) for _ in range(n)])
    assert draws.dtype == torch.float32
    assert float(draws.min()) >= 0.0 and float(draws.max()) < W
    se = W * (1 / 12) ** 0.5 / n ** 0.5
    assert abs(float(draws.double().mean()) - W / 2) < 4 * se
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jdraws = np.asarray(jax.vmap(lambda k: j_backoff(
        jnp.float32(1.1), N, k))(keys))
    assert abs(float(jdraws.astype(np.float64).mean()) - W / 2) < 4 * se
    again = torch.Generator().manual_seed(0)
    assert torch.equal(draws[:5], torch.stack(
        [backoff_time(prio, N, again) for _ in range(5)]))
