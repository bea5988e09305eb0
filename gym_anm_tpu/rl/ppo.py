"""On-device PPO trainer over batched ANM environments.

The reference has no trainer at all (users bring their own); this module is
the on-device learning stack the baseline configs call for: rollouts are
generated by ``lax.scan`` over batched environment steps, advantages by a
scanned GAE pass, and updates by minibatched clipped-PPO epochs -- all one
jitted program per iteration.  Scaling is data-parallel: the environment
batch (and therefore rollout tensors) shard over the ``env`` mesh axis,
parameters are replicated, and XLA inserts the gradient all-reduce (see
gym_anm_tpu/parallel/sharding.py).

Model: a tanh-squashed diagonal-Gaussian actor + value critic on a shared
MLP torso (:mod:`gym_anm_tpu.rl.mlp`), with observations normalized by the observation-
space bounds and actions affinely mapped onto [action_low, action_high].
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..core.env_core import EnvCore
from ..envs.batched import BatchedEnv
from .mlp import ActorCritic


@dataclasses.dataclass
class PPOConfig:
    rollout_steps: int = 64
    minibatches: int = 8
    epochs: int = 4
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    # Rewards are scaled before GAE/returns: ANM terminal rewards are
    # -c2/(1-gamma) (e.g. -20000), which otherwise dominates the value loss.
    reward_scale: float = 0.05


class Transition(NamedTuple):
    obs: Any
    action_u: Any  # pre-squash action in [-1, 1] space
    log_prob: Any
    value: Any
    reward: Any
    terminated: Any


class PPOTrainer:
    """Clipped-PPO over a :class:`BatchedEnv` (auto-reset recommended)."""

    def __init__(self, core: EnvCore, batch_size: int, config: PPOConfig | None = None, seed: int = 0, env=None):
        """``env`` (optional) overrides the default single-grid
        ``BatchedEnv``: any object with ``reset(key)`` / ``step_fn(es,
        actions [B, A], key)`` returning flat ``[B, ...]`` outputs works —
        e.g. a domain-randomized fleet (see
        :func:`gym_anm_tpu.envs.randomized.ppo_trainer_for_fleet`), in which
        case ``core`` is the fleet facade providing observations/bounds and
        ``batch_size`` is the total lane count."""
        self.cfg = config or PPOConfig()
        self.core = core
        self.env = env if env is not None else BatchedEnv(core, batch_size, auto_reset=True)
        self.B = batch_size

        dtype = core.spec.dtype
        # numpy constants (closed over by jitted train/collect steps): fold
        # into programs without a device->host copy at lowering time.
        self.lo = np.asarray(core.action_low, dtype=dtype)
        self.hi = np.asarray(core.action_high, dtype=dtype)
        # Observation normalization from the (finite parts of the) obs bounds.
        low = np.asarray(core.obs_gather.low, dtype=np.float64)
        high = np.asarray(core.obs_gather.high, dtype=np.float64)
        centre = np.where(np.isfinite(low) & np.isfinite(high), (low + high) / 2, 0.0)
        scale = np.where(np.isfinite(low) & np.isfinite(high), np.maximum((high - low) / 2, 1e-3), 1.0)
        self.obs_centre = np.asarray(centre, dtype=dtype)
        self.obs_scale = np.asarray(scale, dtype=dtype)

        self.model = ActorCritic(action_n=core.action_n, hidden=tuple(self.cfg.hidden))
        key = jax.random.PRNGKey(seed)
        self.params = self.model.init(key, jnp.zeros((1, core.obs_gather.n), dtype=dtype))
        self.tx = optax.chain(
            optax.clip_by_global_norm(self.cfg.max_grad_norm), optax.adam(self.cfg.lr)
        )
        self.opt_state = self.tx.init(self.params)
        self._train_step = jax.jit(self.make_train_step())

    # ------------------------------------------------------------------
    def _norm_obs(self, obs):
        return (obs - self.obs_centre) / self.obs_scale

    def _to_env_action(self, u):
        """Map a squashed action u in [-1, 1] to the env's MW/MVAr box."""
        return self.lo + (u + 1.0) * 0.5 * (self.hi - self.lo)

    def _policy_sample(self, params, obs, key):
        mean, log_std, value = self.model.apply(params, self._norm_obs(obs))
        std = jnp.exp(log_std)
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        pre = mean + std * eps
        u = jnp.tanh(pre)
        # log-prob with tanh correction.
        logp = jnp.sum(
            -0.5 * (eps**2) - log_std - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(1 - u**2 + 1e-6),
            axis=-1,
        )
        return u, logp, value

    def _policy_logp(self, params, obs, u):
        mean, log_std, value = self.model.apply(params, self._norm_obs(obs))
        std = jnp.exp(log_std)
        pre = jnp.arctanh(jnp.clip(u, -1 + 1e-6, 1 - 1e-6))
        eps = (pre - mean) / std
        logp = jnp.sum(
            -0.5 * (eps**2) - log_std - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(1 - u**2 + 1e-6),
            axis=-1,
        )
        entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1)
        return logp, entropy, value

    # ------------------------------------------------------------------
    def make_train_step(self):
        cfg = self.cfg
        env = self.env
        B = self.B

        # Lean scan carry (see core/env_core.py LeanEnvState): valid because
        # the policy's observations come from the canonical state vector, so
        # XLA drops the diagnostic SimState fields from the rollout loop.
        lean = self.core.obs_from_state_vec

        # Segment-amortized auto-reset: sample one pool of fresh states per
        # rollout instead of a full reset-transition every step (halves the
        # per-step physics cost in the training configuration).
        use_pool = (
            getattr(env, "auto_reset", False)
            and getattr(env, "auto_reset_mode", "step") == "pool"
            and hasattr(env, "fresh_states")
        )

        def rollout(params, es, key):
            if use_pool:
                key, k_pool = jax.random.split(key)
                fresh = env.fresh_states(k_pool)

            def body(carry, key):
                es = self.core.unlean(carry) if lean else carry
                k_act, k_step = jax.random.split(key)
                obs = self.core.observation(es)
                u, logp, value = self._policy_sample(params, obs, jax.random.fold_in(k_act, 0))
                actions = self._to_env_action(u)
                if use_pool:
                    es, out = env.step_fn(es, actions, k_step, fresh=fresh)
                else:
                    es, out = env.step_fn(es, actions, k_step)
                tr = Transition(obs, u, logp, value, out.reward, out.terminated)
                return (self.core.lean(es) if lean else es), tr

            keys = jax.random.split(key, cfg.rollout_steps)
            es0 = self.core.lean(es) if lean else es
            es, traj = jax.lax.scan(body, es0, keys)
            es = self.core.unlean(es) if lean else es
            last_obs = self.core.observation(es)
            _, _, last_value = self.model.apply(params, self._norm_obs(last_obs))
            return es, traj, last_value

        def gae(traj: Transition, last_value):
            def body(carry, tr):
                adv_next, v_next = carry
                nonterm = 1.0 - tr.terminated.astype(tr.value.dtype)
                delta = cfg.reward_scale * tr.reward + cfg.gamma * v_next * nonterm - tr.value
                adv = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
                return (adv, tr.value), adv

            (_, _), advs = jax.lax.scan(
                body, (jnp.zeros_like(last_value), last_value), traj, reverse=True
            )
            returns = advs + traj.value
            return advs, returns

        def loss_fn(params, batch):
            obs, u, logp_old, adv, ret = batch
            logp, entropy, value = self._policy_logp(params, obs, u)
            ratio = jnp.exp(logp - logp_old)
            adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
            pg = -jnp.minimum(
                ratio * adv_n, jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
            ).mean()
            vf = 0.5 * jnp.mean((value - ret) ** 2)
            ent = entropy.mean()
            loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
            return loss, (pg, vf, ent)

        def train_step(params, opt_state, es, key):
            k_roll, k_perm = jax.random.split(key)
            es, traj, last_value = rollout(params, es, k_roll)
            advs, rets = gae(traj, last_value)

            T = cfg.rollout_steps
            flat = lambda x: x.reshape((T * B,) + x.shape[2:])
            data = (flat(traj.obs), flat(traj.action_u), flat(traj.log_prob), flat(advs), flat(rets))
            n = T * B
            mb = n // cfg.minibatches

            def epoch(carry, key):
                params, opt_state = carry
                perm = jax.random.permutation(key, n)

                def mb_step(carry, idx):
                    params, opt_state = carry
                    batch = tuple(d[idx] for d in data)
                    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
                    updates, opt_state = self.tx.update(grads, opt_state, params)
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                idxs = perm[: mb * cfg.minibatches].reshape(cfg.minibatches, mb)
                (params, opt_state), losses = jax.lax.scan(mb_step, (params, opt_state), idxs)
                return (params, opt_state), losses.mean()

            keys = jax.random.split(k_perm, cfg.epochs)
            (params, opt_state), losses = jax.lax.scan(epoch, (params, opt_state), keys)
            metrics = {
                "loss": losses.mean(),
                "mean_reward": traj.reward.mean(),
                "terminated_frac": traj.terminated.astype(jnp.float32).mean(),
            }
            return params, opt_state, es, metrics

        return train_step

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint parameters + optimizer state to ``path`` (.npz)."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump(
                {
                    "params": jax.tree.map(np.asarray, self.params),
                    "opt_state": jax.tree.map(
                        lambda x: np.asarray(x) if hasattr(x, "shape") else x, self.opt_state
                    ),
                    "config": dataclasses.asdict(self.cfg),
                },
                f,
            )

    def load(self, path: str):
        """Restore a checkpoint written by :meth:`save`."""
        import pickle

        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        self.params = jax.tree.map(jnp.asarray, ckpt["params"])
        self.opt_state = jax.tree.map(
            lambda x: jnp.asarray(x) if hasattr(x, "shape") else x, ckpt["opt_state"]
        )

    def init_envs(self, key):
        es, _ = self.env.reset(key)
        return es

    def train(self, iterations: int, key=None, log_every: int = 1):
        key = key if key is not None else jax.random.PRNGKey(1)
        key, k0 = jax.random.split(key)
        es = self.init_envs(k0)
        history = []
        for it in range(iterations):
            key, k = jax.random.split(key)
            self.params, self.opt_state, es, metrics = self._train_step(
                self.params, self.opt_state, es, k
            )
            if it % log_every == 0:
                m = {k_: float(np.asarray(v)) for k_, v in metrics.items()}
                history.append(m)
        return history
