"""Plain-JAX multilayer perceptrons for the PPO and SAC models.

The parameters are the ones flax.linen would build, bit for bit, so
checkpoints, sharding rules and learning runs written against the flax
models carry over: a model's variables are ``{"params": {"Dense_<i>":
{"kernel": [in, out], "bias": [out]}, ...}}`` with layers numbered in
creation order, kernels drawn lecun-normal in float32 from flax's per-layer
key, biases zero.

:data:`MATMUL_PRECISION` is the precision of every learner matmul.  XLA's
default lets float32 products run in TF32 on Hopper tensor cores (about
three decimal digits in the products, float32 accumulation), which is what
RL training usually runs in; the physics step pins ``HIGHEST`` on its own
products instead (``core/transition.py``).
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp

MATMUL_PRECISION = jax.lax.Precision.DEFAULT
PARAM_DTYPE = jnp.float32


def layer_key(key, name: str, draw: int = 1):
    """The key flax.linen's ``init(key, ...)`` hands the ``draw``-th
    parameter of submodule ``name``: the SHA-1 of (name, draw) folded into
    the init key."""
    digest = hashlib.sha1(name.encode() + draw.to_bytes((draw.bit_length() + 7) // 8, "big")).digest()
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(digest[:4], "big")))


def init_dense(key, name: str, n_in: int, n_out: int) -> dict:
    """Layer ``name``: lecun-normal kernel [n_in, n_out], zero bias."""
    kernel = jax.nn.initializers.lecun_normal()(layer_key(key, name), (n_in, n_out), PARAM_DTYPE)
    return {"kernel": kernel, "bias": jnp.zeros((n_out,), PARAM_DTYPE)}


def dense(layer: dict, x):
    return jnp.dot(x, layer["kernel"], precision=MATMUL_PRECISION) + layer["bias"]


def init_mlp(key, sizes, first: int = 0) -> dict:
    """Layers ``Dense_<first>`` ... mapping ``sizes[0] -> ... -> sizes[-1]``."""
    return {
        "Dense_%d" % (first + i): init_dense(key, "Dense_%d" % (first + i), a, b)
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
    }


def mlp(params: dict, x, n_layers: int, act, first: int = 0):
    """Apply ``n_layers`` hidden layers ``Dense_<first>...`` with ``act``."""
    for i in range(n_layers):
        x = act(dense(params["Dense_%d" % (first + i)], x))
    return x


class ActorCritic:
    """MLP actor-critic with a Gaussian policy head: tanh torso
    ``Dense_0..Dense_{L-1}``, mean head ``Dense_L``, value head
    ``Dense_{L+1}`` and a state-independent ``log_std`` (initial -0.5)."""

    def __init__(self, action_n: int, hidden=(256, 256)):
        self.action_n = int(action_n)
        self.hidden = tuple(hidden)

    def init(self, key, obs) -> dict:
        L = len(self.hidden)
        sizes = (obs.shape[-1],) + self.hidden
        params = init_mlp(key, sizes)
        params["Dense_%d" % L] = init_dense(key, "Dense_%d" % L, sizes[-1], self.action_n)
        # flax's constant initialiser uses the default float dtype.
        params["log_std"] = jnp.full((self.action_n,), -0.5, jax.dtypes.canonicalize_dtype(jnp.float64))
        params["Dense_%d" % (L + 1)] = init_dense(key, "Dense_%d" % (L + 1), sizes[-1], 1)
        return {"params": params}

    def apply(self, variables, obs):
        p = variables["params"]
        L = len(self.hidden)
        x = mlp(p, obs, L, jnp.tanh)
        mean = dense(p["Dense_%d" % L], x)
        value = dense(p["Dense_%d" % (L + 1)], x)[..., 0]
        return mean, p["log_std"], value


class Actor:
    """MLP producing a tanh-squashed diagonal-Gaussian policy: relu torso,
    mean head ``Dense_L`` and log-std head ``Dense_{L+1}`` (clipped to
    [-5, 2])."""

    def __init__(self, action_n: int, hidden=(256, 256)):
        self.action_n = int(action_n)
        self.hidden = tuple(hidden)

    def init(self, key, obs) -> dict:
        sizes = (obs.shape[-1],) + self.hidden + (self.action_n,)
        params = init_mlp(key, sizes)
        L = len(self.hidden)
        params["Dense_%d" % (L + 1)] = init_dense(key, "Dense_%d" % (L + 1), sizes[-2], self.action_n)
        return {"params": params}

    def apply(self, variables, obs):
        p = variables["params"]
        L = len(self.hidden)
        x = mlp(p, obs, L, jax.nn.relu)
        mean = dense(p["Dense_%d" % L], x)
        log_std = jnp.clip(dense(p["Dense_%d" % (L + 1)], x), -5.0, 2.0)
        return mean, log_std


class TwinQ:
    """Two independent Q(s, a) MLPs (clipped double-Q): the first uses
    ``Dense_0..Dense_L``, the second ``Dense_{L+1}..Dense_{2L+1}``."""

    def __init__(self, hidden=(256, 256)):
        self.hidden = tuple(hidden)

    def init(self, key, obs, act) -> dict:
        n = len(self.hidden) + 1
        sizes = (obs.shape[-1] + act.shape[-1],) + self.hidden + (1,)
        return {"params": {**init_mlp(key, sizes), **init_mlp(key, sizes, first=n)}}

    def apply(self, variables, obs, act):
        p = variables["params"]
        L = len(self.hidden)
        x0 = jnp.concatenate([obs, act], axis=-1)
        qs = []
        for first in (0, L + 1):
            x = mlp(p, x0, L, jax.nn.relu, first=first)
            qs.append(dense(p["Dense_%d" % (first + L)], x)[..., 0])
        return qs[0], qs[1]
