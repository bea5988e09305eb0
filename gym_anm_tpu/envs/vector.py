"""Gymnasium ``VectorEnv`` adapter over the batched functional core.

The reference exposes only a single-env Gymnasium API; vectorized training
loops (Stable-Baselines3, CleanRL, ...) expect the standard
``gymnasium.vector.VectorEnv`` interface.  :class:`ANMVectorEnv` provides it
on top of :class:`~gym_anm_tpu.core.env_core.EnvCore`: all ``num_envs``
environments step in lockstep inside one jitted program on the accelerator,
so this is simultaneously the drop-in vector API *and* the batched fast path
(unlike ``gymnasium.vector.SyncVectorEnv``, which loops envs in Python).

Autoreset follows Gymnasium >= 1.0 **next-step** semantics
(``AutoresetMode.NEXT_STEP``): when lane *i* terminates at step *t*, the
``step`` call at *t+1* ignores its action, re-samples an initial state via
the task's ``init_state_fn``, and returns the reset observation with
``reward 0, terminated False, truncated False``.

Requires the pure-JAX task hooks (``init_state_fn`` / ``next_vars_fn``),
i.e. a core built by ``make_core`` -- the same requirement as
:class:`~gym_anm_tpu.envs.batched.BatchedEnv`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
import gymnasium
from gymnasium.vector import VectorEnv
from gymnasium.vector.utils import batch_space

from ..core.env_core import EnvCore, EnvState


class ANMVectorEnv(VectorEnv):
    """Lockstep-on-accelerator ``gymnasium.vector.VectorEnv``.

    Parameters
    ----------
    core : EnvCore
        Functional environment with pure-JAX hooks (e.g.
        ``gym_anm_tpu.envs.anm6.anm6_easy.make_core()``).
    num_envs : int
        Number of lockstep environments.
    seed : int, optional
        Initial PRNG seed (can also be passed to :meth:`reset`).
    reset_attempts : int | None
        Rejection-sampling rounds for full resets (the reference budget is
        100; None uses the task's calibrated ``core.reset_attempts``;
        autoreset of individual lanes uses a single attempt to keep
        the batch lockstep).
    """

    metadata = {"autoreset_mode": gymnasium.vector.AutoresetMode.NEXT_STEP}

    def __init__(
        self, core: EnvCore, num_envs: int, seed: Optional[int] = None, reset_attempts: Optional[int] = None
    ):
        super().__init__()
        if core.init_state_fn is None or core.next_vars_fn is None:
            raise ValueError("ANMVectorEnv needs an EnvCore with pure-JAX init_state_fn/next_vars_fn hooks")
        if core.obs_gather is None:
            raise ValueError("ANMVectorEnv needs an EnvCore with an explicit observation spec")
        self.core = core
        self.num_envs = int(num_envs)
        self.render_mode = None
        f32 = np.float32 if core.spec.dtype == jnp.float32 else np.float64

        self.single_action_space = gymnasium.spaces.Box(
            low=np.asarray(core.action_low, dtype=f32),
            high=np.asarray(core.action_high, dtype=f32),
            dtype=f32,
        )
        self.single_observation_space = gymnasium.spaces.Box(
            low=np.asarray(core.obs_gather.low, dtype=f32),
            high=np.asarray(core.obs_gather.high, dtype=f32),
            dtype=f32,
        )
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)

        self._reset_attempts = int(core.reset_attempts if reset_attempts is None else reset_attempts)
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._es: Optional[EnvState] = None
        self._needs_reset = None  # [B] bool: lanes to autoreset on the next step

        B = self.num_envs

        def _full_reset(key):
            return core.reset(key, batch_shape=(B,), attempts=self._reset_attempts)

        def _step(es, needs_reset, actions, key):
            k_vars, k_reset = jax.random.split(key)
            if core.stochastic_vars:
                vars_keys = jax.random.split(k_vars, B)
                vars = jax.vmap(core.next_vars_fn)(core.state_vec(es), vars_keys)
            else:
                vars = jax.vmap(core.next_vars_fn, in_axes=(0, None))(core.state_vec(es), k_vars)
            es_new, out = core.step(es, actions, vars)

            # Next-step autoreset: lanes flagged by the previous step ignore
            # the action and re-initialize instead (single attempt).
            reset_keys = jax.random.split(k_reset, B)
            s0 = jax.vmap(core.init_state_fn)(reset_keys)
            es_fresh = core.env_state_from_s0(s0)
            sel = lambda a, b: jax.tree.map(
                lambda x, y: jnp.where(
                    needs_reset.reshape(needs_reset.shape + (1,) * (x.ndim - 1)), x, y
                ),
                a,
                b,
            )
            es_out = sel(es_fresh, es_new)
            obs = jnp.where(needs_reset[:, None], core.observation(es_fresh), out.obs)
            reward = jnp.where(needs_reset, 0.0, out.reward)
            terminated = jnp.where(needs_reset, False, out.terminated)
            return es_out, obs, reward, terminated, terminated

        self._jit_reset = jax.jit(_full_reset)
        self._jit_step = jax.jit(_step)

    # ------------------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, k = jax.random.split(self._key)
        es, out = self._jit_reset(k)
        self._es = es
        # A lane that exhausted the rejection-sampling budget is terminated
        # (absorbing zero state/obs) and flagged for autoreset: it retries a
        # fresh initial state on the next step instead of entering the
        # rollout with a diverged sim state.
        self._needs_reset = out.failed
        return np.asarray(out.obs), {"reset_failed": np.asarray(out.failed)}

    def step(self, actions):
        if self._es is None:
            raise RuntimeError("call reset() before step()")
        actions = jnp.asarray(actions, dtype=self.core.spec.dtype)
        self._key, k = jax.random.split(self._key)
        self._es, obs, reward, terminated, needs_reset = self._jit_step(
            self._es, self._needs_reset, actions, k
        )
        self._needs_reset = needs_reset
        truncated = np.zeros((self.num_envs,), dtype=bool)
        return (
            np.asarray(obs),
            np.asarray(reward),
            np.asarray(terminated),
            truncated,
            {},
        )

    def close_extras(self, **kwargs):
        self._es = None
