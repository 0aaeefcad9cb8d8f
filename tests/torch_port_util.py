"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Inputs are made with numpy from a seed and handed to both packages:
``to_jax`` / ``to_torch`` turn one nested dict of arrays into each
side's parameter pytree (the port always on the CPU here). ``pin_*``
build the scenario of ``tools/check_winner_pins.py`` (8 users, a 16 -> 4
linear model) in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import engine as jeng
from repro_torch import engine as teng
from repro_torch.convert import params_from_numpy

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_jax(tree, dtype="float32"):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(JAX_DTYPES[dtype]),
                        tree)


def to_torch(tree, dtype="float32"):
    return params_from_numpy(tree, device="cpu", dtype=TORCH_DTYPES[dtype])


def arr_j(a, dtype="float32"):
    """One numpy array as a JAX array of ``dtype`` (f32 -> bf16 rounds to
    nearest even, exactly as ``arr_t`` does)."""
    return jnp.asarray(a).astype(JAX_DTYPES[dtype])


def arr_t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, copy=True)).to(TORCH_DTYPES[dtype])


def f32(x):
    """Any framework's array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tree_f32(tree):
    """Nested dict of either framework's arrays -> nested dict of f32
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_f32(v) for k, v in tree.items()}
    return f32(tree)


def assert_trees_close(a, b, **tol):
    a, b = tree_f32(a), tree_f32(b)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, **tol)


def bits(t):
    """A tensor's bit pattern as integers, for bitwise comparisons."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


def jax_xent(apply_fn, n_classes):
    """The reference's one-hot cross-entropy loss over ``apply_fn``."""
    def loss_fn(params, batch):
        logits = apply_fn(params, batch["x"])
        oh = jax.nn.one_hot(batch["y"], n_classes)
        return -jnp.mean(jnp.sum(oh * jax.nn.log_softmax(logits), -1))
    return loss_fn


# ------------------------------------------------- the pin scenario
PIN_USERS = 8


def pin_user_data():
    rng = np.random.default_rng(7)
    user_data = []
    for u in range(PIN_USERS):
        probs = np.ones(4) / 4
        probs[u % 4] += 1.0
        probs /= probs.sum()
        user_data.append({
            "x": rng.normal(size=(64, 16)).astype(np.float32),
            "y": rng.choice(4, 64, p=probs)})
    return user_data


def pin_init():
    return {"w": np.zeros((16, 4), np.float32),
            "b": np.zeros((4,), np.float32)}


def pin_jax_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    oh = jax.nn.one_hot(batch["y"], 4)
    return -jnp.mean(jnp.sum(oh * jax.nn.log_softmax(logits), -1))


def pin_torch_loss(params, batch):
    logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], -1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()


def pin_torch_engine(spec_kw, **kw):
    spec = teng.ExperimentSpec(**spec_kw)
    return teng.build_host_engine(spec, to_torch(pin_init()), pin_torch_loss,
                                  pin_user_data(), device="cpu", **kw)


def pin_jax_engine(spec_kw):
    spec = jeng.ExperimentSpec(**spec_kw)
    return jeng.build_host_engine(spec, to_jax(pin_init()), pin_jax_loss,
                                  pin_user_data())


#: the pin scenario's seeds, and a channel that loses uploads there:
#: waterfall PER with Rayleigh fading, the threshold raised (the default
#: loses none of these users' uploads)
SEEDS = (0, 1)
LOSSY = dict(fading="rayleigh", per_snr_threshold_db=20.0)

#: history fields an engine run of the port must equal the reference's in
HISTORY_COUNTS = ("winners", "delivered", "upload_failures", "collisions",
                  "contention_slots", "uploads_total", "round_seconds",
                  "cumulative_seconds", "round_energy_j", "retries",
                  "dropped_clients", "stale_merges", "quarantined_updates")


def threefry_noise(key, leaf_index, shape, device):
    """The reference's AirComp noise plane of one leaf (before the sigma
    scale), for the port's ``HostBackend._noise_draw`` hook:
    ``normal(fold_in(fold_in(PRNGKey(entropy), t), leaf_index))``."""
    entropy, t = key
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(entropy), t), leaf_index)
    plane = np.array(jax.random.normal(k, tuple(shape), jnp.float32))
    return torch.from_numpy(plane).to(device)


def run_pair(spec_kw, rounds=4, noise_draw=None):
    """The JAX engine's ``run()`` and the port's on the pin scenario,
    with the same spec built from each package's own classes: a value
    of ``spec_kw`` is used by both, a ``(jax value, port value)`` pair
    one each. ``noise_draw`` replaces the port backend's AirComp noise
    draw. Returns ``(jax history, port history, jax engine, port
    engine)``."""
    jkw = {k: (v[0] if isinstance(v, tuple) else v)
           for k, v in spec_kw.items()}
    tkw = {k: (v[1] if isinstance(v, tuple) else v)
           for k, v in spec_kw.items()}
    je = pin_jax_engine(dict(rounds=rounds, **jkw))
    te = pin_torch_engine(dict(rounds=rounds, **tkw))
    if noise_draw is not None:
        te.backend._noise_draw = noise_draw
    return je.run(), te.run(), je, te


def assert_runs_agree(want, got, je, te):
    """Every count of the history exactly; losses and globals to
    ``rtol=1e-5``."""
    for name in HISTORY_COUNTS:
        assert getattr(got, name) == getattr(want, name), name
    assert np.array_equal(got.selections, want.selections)
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-5)
    assert_trees_close(te.global_params, je.global_params, rtol=1e-5,
                       atol=1e-6)


def run_port(rounds=4, **spec_kw):
    """The port alone on the pin scenario, seed 0."""
    eng = pin_torch_engine(dict(rounds=rounds, seed=0, **spec_kw))
    return eng.run(), eng


def bitwise_equal(a, b):
    """Two nested dicts of tensors hold the same bits, leaf for leaf."""
    la, lb = jax.tree.leaves(tree_f32(a)), jax.tree.leaves(tree_f32(b))
    return len(la) == len(lb) and all(
        np.array_equal(x.view(np.int32), y.view(np.int32))
        for x, y in zip(la, lb))
