"""Plain-JAX models of rl/mlp.py: flax.linen's parameter tree and
initialisers, and forward passes against NumPy."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gym_anm_tpu.rl.mlp import Actor, ActorCritic, TwinQ

OBS, ACT, HID = 18, 6, (8, 4)

# The parameter trees flax.linen builds for these modules (names in
# creation order), pinned so no flax is needed to check them.
FLAX_LAYOUT = {
    "ActorCritic": {
        "Dense_0": {"kernel": (OBS, 8), "bias": (8,)},
        "Dense_1": {"kernel": (8, 4), "bias": (4,)},
        "Dense_2": {"kernel": (4, ACT), "bias": (ACT,)},
        "Dense_3": {"kernel": (4, 1), "bias": (1,)},
        "log_std": (ACT,),
    },
    "Actor": {
        "Dense_0": {"kernel": (OBS, 8), "bias": (8,)},
        "Dense_1": {"kernel": (8, 4), "bias": (4,)},
        "Dense_2": {"kernel": (4, ACT), "bias": (ACT,)},
        "Dense_3": {"kernel": (4, ACT), "bias": (ACT,)},
    },
    "TwinQ": {
        "Dense_0": {"kernel": (OBS + ACT, 8), "bias": (8,)},
        "Dense_1": {"kernel": (8, 4), "bias": (4,)},
        "Dense_2": {"kernel": (4, 1), "bias": (1,)},
        "Dense_3": {"kernel": (OBS + ACT, 8), "bias": (8,)},
        "Dense_4": {"kernel": (8, 4), "bias": (4,)},
        "Dense_5": {"kernel": (4, 1), "bias": (1,)},
    },
}


def _model(name):
    obs = jnp.zeros((3, OBS), jnp.float32)
    act = jnp.zeros((3, ACT), jnp.float32)
    if name == "ActorCritic":
        m = ActorCritic(ACT, HID)
        return m, m.init(jax.random.PRNGKey(0), obs), (obs,)
    if name == "Actor":
        m = Actor(ACT, HID)
        return m, m.init(jax.random.PRNGKey(0), obs), (obs,)
    m = TwinQ(HID)
    return m, m.init(jax.random.PRNGKey(0), obs, act), (obs, act)


@pytest.mark.parametrize("name", list(FLAX_LAYOUT))
def test_param_tree_matches_flax_layout(name):
    _, variables, _ = _model(name)
    assert list(variables) == ["params"]
    shapes = jax.tree.map(lambda x: tuple(x.shape), variables["params"])
    assert shapes == FLAX_LAYOUT[name]
    for layer in variables["params"].values():
        if isinstance(layer, dict):
            assert layer["kernel"].dtype == layer["bias"].dtype == jnp.float32
            assert not np.any(np.asarray(layer["bias"]))
    if name == "ActorCritic":
        # flax's constant initialiser: the default float dtype.
        log_std = variables["params"]["log_std"]
        assert log_std.dtype == jax.dtypes.canonicalize_dtype(jnp.float64)
        np.testing.assert_array_equal(np.asarray(log_std), -0.5)


def test_init_values_match_flax():
    """flax.linen's own init of the same module and key gave these values
    (pinned here so the test needs no flax): the per-layer key derivation
    is flax's, so learning runs reproduce."""
    v = ActorCritic(ACT, HID).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS), jnp.float32))["params"]
    np.testing.assert_array_equal(
        np.asarray(v["Dense_0"]["kernel"][0, :3]),
        np.asarray([-0.3893328607082367, 0.17784947156906128, -0.3247388005256653], np.float32),
    )
    np.testing.assert_array_equal(
        np.asarray(v["Dense_3"]["kernel"][:2, 0]), np.asarray([0.5926066040992737, -0.8714351654052734], np.float32)
    )


def _np_dense(layer, x):
    return x @ np.asarray(layer["kernel"], np.float64) + np.asarray(layer["bias"], np.float64)


@pytest.mark.parametrize("name", list(FLAX_LAYOUT))
def test_forward_matches_numpy(name):
    model, variables, args = _model(name)
    rng = np.random.default_rng(0)
    # Non-zero biases so their wiring is checked too.
    variables = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.1, x.dtype), variables)
    args = tuple(jnp.asarray(rng.normal(size=a.shape), jnp.float32) for a in args)
    p = variables["params"]
    x = [np.asarray(a, np.float64) for a in args]
    with jax.default_matmul_precision("highest"):
        out = model.apply(variables, *args)
    if name == "ActorCritic":
        h = np.tanh(_np_dense(p["Dense_1"], np.tanh(_np_dense(p["Dense_0"], x[0]))))
        want = (_np_dense(p["Dense_2"], h), np.asarray(p["log_std"]), _np_dense(p["Dense_3"], h)[:, 0])
    elif name == "Actor":
        relu = lambda v: np.maximum(v, 0)
        h = relu(_np_dense(p["Dense_1"], relu(_np_dense(p["Dense_0"], x[0]))))
        want = (_np_dense(p["Dense_2"], h), np.clip(_np_dense(p["Dense_3"], h), -5.0, 2.0))
    else:
        relu = lambda v: np.maximum(v, 0)
        x0 = np.concatenate(x, axis=-1)
        want = tuple(
            _np_dense(p["Dense_%d" % (f + 2)], relu(_np_dense(p["Dense_%d" % (f + 1)], relu(_np_dense(p["Dense_%d" % f], x0)))))[:, 0]
            for f in (0, 3)
        )
    for o, w in zip(out, want):
        np.testing.assert_allclose(np.asarray(o, np.float64), w, rtol=1e-5, atol=1e-5)


def test_kernel_init_is_lecun_normal():
    """flax's default kernel init: truncated normal with variance 1/fan_in."""
    m = ActorCritic(2, (512,))
    w = np.asarray(m.init(jax.random.PRNGKey(1), jnp.zeros((1, 400), jnp.float32))["params"]["Dense_0"]["kernel"])
    assert abs(w.std() * np.sqrt(400) - 1.0) < 0.02
    assert np.abs(w).max() <= 2.0 / np.sqrt(400) / 0.87962566103423978 + 1e-6
