"""On-device Soft Actor-Critic over batched ANM environments.

Off-policy complement to :mod:`gym_anm_tpu.rl.ppo`: a device-resident ring
replay buffer (pure pytree, written with ``lax.dynamic_update_slice`` inside
the jitted program — no host round-trips), a tanh-squashed Gaussian actor,
twin Q critics with polyak-averaged targets, and auto-tuned entropy
temperature.  One call to the jitted ``train_step`` performs
``collect_steps`` vectorized environment steps (storing ``B`` transitions
each) followed by ``grad_steps`` critic/actor/alpha updates — the whole
iteration is a single XLA program.

The reference has no trainer (users bring their own, README.md:60-75); this
is part of the on-device learning stack alongside PPO.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..core.env_core import EnvCore
from ..envs.batched import BatchedEnv
from .mlp import Actor, TwinQ


@dataclasses.dataclass
class SACConfig:
    buffer_capacity: int = 2**17
    collect_steps: int = 32  # env steps per iteration (B transitions each)
    grad_steps: int = 32  # gradient updates per iteration
    train_batch: int = 256
    gamma: float = 0.995
    tau: float = 0.005  # polyak coefficient for target critics
    lr: float = 3e-4
    hidden: tuple = (256, 256)
    # Same scaling rationale as PPOConfig.reward_scale: ANM terminal rewards
    # are -c2/(1-gamma) and would otherwise dominate the Bellman targets.
    reward_scale: float = 0.05
    init_log_alpha: float = -1.6  # alpha ~ 0.2


class Replay(NamedTuple):
    """Ring buffer of transitions, resident on device.

    ``action_u`` is the pre-environment squashed action in [-1, 1]; next
    observations for lanes that terminated are the auto-reset observations,
    which is safe because the Bellman target masks them with (1 - done).
    """

    obs: Any  # [C, obs_n]
    action_u: Any  # [C, action_n]
    reward: Any  # [C]
    next_obs: Any  # [C, obs_n]
    terminated: Any  # [C] bool
    ptr: Any  # int32 scalar: next write offset (monotonic)
    size: Any  # int32 scalar: filled entries, <= C


class SACTrainer:
    """Soft Actor-Critic over a :class:`BatchedEnv` (auto-reset)."""

    def __init__(
        self, core: EnvCore, batch_size: int, config: SACConfig | None = None, seed: int = 0, env=None
    ):
        """``env`` (optional) overrides the default single-grid
        ``BatchedEnv`` with any object exposing ``reset(key)`` /
        ``step_fn(es, actions [B, A], key)`` over flat ``[B, ...]`` outputs
        — e.g. a domain-randomized fleet facade (see
        :func:`gym_anm_tpu.envs.randomized.sac_trainer_for_fleet`), in which
        case ``core`` supplies observations/bounds and ``batch_size`` is the
        total lane count."""
        self.cfg = cfg = config or SACConfig()
        self.core = core
        self.env = env if env is not None else BatchedEnv(core, batch_size, auto_reset=True)
        self.B = batch_size
        if cfg.buffer_capacity % batch_size:
            raise ValueError("buffer_capacity must be a multiple of batch_size (aligned ring writes)")

        dtype = core.spec.dtype
        # numpy constants (closed over by jitted collect/update steps): fold
        # into programs without a device->host copy at lowering time.
        self.lo = np.asarray(core.action_low, dtype=dtype)
        self.hi = np.asarray(core.action_high, dtype=dtype)
        low = np.asarray(core.obs_gather.low, dtype=np.float64)
        high = np.asarray(core.obs_gather.high, dtype=np.float64)
        centre = np.where(np.isfinite(low) & np.isfinite(high), (low + high) / 2, 0.0)
        scale = np.where(np.isfinite(low) & np.isfinite(high), np.maximum((high - low) / 2, 1e-3), 1.0)
        self.obs_centre = np.asarray(centre, dtype=dtype)
        self.obs_scale = np.asarray(scale, dtype=dtype)

        obs_n, act_n = core.obs_gather.n, core.action_n
        self.actor = Actor(action_n=act_n, hidden=tuple(cfg.hidden))
        self.critic = TwinQ(hidden=tuple(cfg.hidden))

        key = jax.random.PRNGKey(seed)
        k_a, k_c = jax.random.split(key)
        z_obs = jnp.zeros((1, obs_n), dtype=dtype)
        z_act = jnp.zeros((1, act_n), dtype=dtype)
        critic_params = self.critic.init(k_c, z_obs, z_act)
        self.tx_actor = optax.adam(cfg.lr)
        self.tx_critic = optax.adam(cfg.lr)
        self.tx_alpha = optax.adam(cfg.lr)
        actor_params = self.actor.init(k_a, z_obs)
        log_alpha = jnp.asarray(cfg.init_log_alpha, dtype=dtype)
        self.state = {
            "actor": actor_params,
            "critic": critic_params,
            "target": jax.tree.map(lambda x: x, critic_params),
            "log_alpha": log_alpha,
            "opt_actor": self.tx_actor.init(actor_params),
            "opt_critic": self.tx_critic.init(critic_params),
            "opt_alpha": self.tx_alpha.init(log_alpha),
        }
        self.target_entropy = -float(act_n)

        C = cfg.buffer_capacity
        self._empty_replay = Replay(
            obs=jnp.zeros((C, obs_n), dtype=dtype),
            action_u=jnp.zeros((C, act_n), dtype=dtype),
            reward=jnp.zeros((C,), dtype=dtype),
            next_obs=jnp.zeros((C, obs_n), dtype=dtype),
            terminated=jnp.zeros((C,), dtype=bool),
            ptr=jnp.zeros((), dtype=jnp.int32),
            size=jnp.zeros((), dtype=jnp.int32),
        )

        self._train_step = jax.jit(self.make_train_step())
        self._warmup = jax.jit(self.make_collect(uniform=True))

    # ------------------------------------------------------------------
    def _norm_obs(self, obs):
        return (obs - self.obs_centre) / self.obs_scale

    def _to_env_action(self, u):
        return self.lo + (u + 1.0) * 0.5 * (self.hi - self.lo)

    def _sample_u(self, actor_params, obs, key):
        mean, log_std = self.actor.apply(actor_params, self._norm_obs(obs))
        std = jnp.exp(log_std)
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        pre = mean + std * eps
        u = jnp.tanh(pre)
        logp = jnp.sum(
            -0.5 * (eps**2) - log_std - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(1 - u**2 + 1e-6),
            axis=-1,
        )
        return u, logp

    # ------------------------------------------------------------------
    def _store_chunk(self, rb: Replay, obs, u, reward, next_obs, terminated) -> Replay:
        """Append a [B, ...] chunk at the ring position (capacity % B == 0,
        so a chunk never straddles the wrap point)."""
        C = self.cfg.buffer_capacity
        at = rb.ptr % C
        zero = jnp.zeros_like(at)
        upd = lambda buf, x: jax.lax.dynamic_update_slice(buf, x, (at,) + (zero,) * (x.ndim - 1))
        return Replay(
            obs=upd(rb.obs, obs),
            action_u=upd(rb.action_u, u),
            reward=upd(rb.reward, reward),
            next_obs=upd(rb.next_obs, next_obs),
            terminated=upd(rb.terminated, terminated),
            ptr=rb.ptr + self.B,
            size=jnp.minimum(rb.size + self.B, C),
        )

    def make_collect(self, uniform: bool):
        """Build ``collect(state, es, rb, obs, key, n_steps)`` scanning env
        steps and storing transitions (uniform random actions if requested)."""
        env = self.env
        core = self.core
        # Segment-amortized auto-reset (one fresh-state pool per collect
        # segment instead of a reset-transition every step).
        use_pool = (
            getattr(env, "auto_reset", False)
            and getattr(env, "auto_reset_mode", "step") == "pool"
            and hasattr(env, "fresh_states")
        )

        def make_body(fresh):
            def body(carry, key):
                state, es, rb, obs = carry
                k_act, k_step = jax.random.split(key)
                if uniform:
                    u = jax.random.uniform(k_act, (self.B, core.action_n), core.spec.dtype) * 2.0 - 1.0
                else:
                    u, _ = self._sample_u(state["actor"], obs, k_act)
                if use_pool:
                    es, out = env.step_fn(es, self._to_env_action(u), k_step, fresh=fresh)
                else:
                    es, out = env.step_fn(es, self._to_env_action(u), k_step)
                rb = self._store_chunk(rb, obs, u, out.reward, out.obs, out.terminated)
                return (state, es, rb, out.obs), (out.reward, out.terminated)

            return body

        def collect(state, es, rb, obs, key, n_steps):
            if use_pool:
                key, k_pool = jax.random.split(key)
                fresh = env.fresh_states(k_pool)
            else:
                fresh = None
            keys = jax.random.split(key, n_steps)
            (state, es, rb, obs), traj = jax.lax.scan(make_body(fresh), (state, es, rb, obs), keys)
            return es, rb, obs, traj

        return lambda state, es, rb, obs, key: collect(state, es, rb, obs, key, self.cfg.collect_steps)

    # ------------------------------------------------------------------
    def make_train_step(self):
        cfg = self.cfg
        collect = self.make_collect(uniform=False)

        def critic_loss_fn(critic_params, state, batch, key):
            obs, u, reward, next_obs, done = batch
            # Critics take the squashed action u in [-1, 1] (same scale as the
            # normalized observations), not the MW/MVAr env action.
            u_next, logp_next = self._sample_u(state["actor"], next_obs, key)
            q1t, q2t = self.critic.apply(state["target"], self._norm_obs(next_obs), u_next)
            alpha = jnp.exp(state["log_alpha"])
            nonterm = 1.0 - done.astype(reward.dtype)
            target = cfg.reward_scale * reward + cfg.gamma * nonterm * (
                jnp.minimum(q1t, q2t) - alpha * logp_next
            )
            target = jax.lax.stop_gradient(target)
            q1, q2 = self.critic.apply(critic_params, self._norm_obs(obs), u)
            return 0.5 * jnp.mean((q1 - target) ** 2 + (q2 - target) ** 2), (q1.mean(),)

        def actor_loss_fn(actor_params, state, obs, key):
            u, logp = self._sample_u(actor_params, obs, key)
            q1, q2 = self.critic.apply(state["critic"], self._norm_obs(obs), u)
            alpha = jnp.exp(state["log_alpha"])
            return jnp.mean(alpha * logp - jnp.minimum(q1, q2)), logp

        def grad_update(state, rb: Replay, key):
            k_idx, k_c, k_a = jax.random.split(key, 3)
            idx = jax.random.randint(k_idx, (cfg.train_batch,), 0, jnp.maximum(rb.size, 1))
            batch = (rb.obs[idx], rb.action_u[idx], rb.reward[idx], rb.next_obs[idx], rb.terminated[idx])

            (c_loss, (q_mean,)), c_grads = jax.value_and_grad(critic_loss_fn, has_aux=True)(
                state["critic"], state, batch, k_c
            )
            upd, opt_critic = self.tx_critic.update(c_grads, state["opt_critic"], state["critic"])
            critic = optax.apply_updates(state["critic"], upd)
            state = {**state, "critic": critic, "opt_critic": opt_critic}

            (a_loss, logp), a_grads = jax.value_and_grad(actor_loss_fn, has_aux=True)(
                state["actor"], state, batch[0], k_a
            )
            upd, opt_actor = self.tx_actor.update(a_grads, state["opt_actor"], state["actor"])
            actor = optax.apply_updates(state["actor"], upd)

            # d/d(log_alpha) of  -log_alpha * stop_grad(mean logp + H_target).
            ent_err = jax.lax.stop_gradient(jnp.mean(logp) + self.target_entropy)
            al_grad = jnp.asarray(-ent_err, state["log_alpha"].dtype)
            upd, opt_alpha = self.tx_alpha.update(al_grad, state["opt_alpha"], state["log_alpha"])
            log_alpha = optax.apply_updates(state["log_alpha"], upd)

            target = jax.tree.map(
                lambda t, c: (1 - cfg.tau) * t + cfg.tau * c, state["target"], critic
            )
            state = {
                **state,
                "actor": actor,
                "opt_actor": opt_actor,
                "log_alpha": log_alpha,
                "opt_alpha": opt_alpha,
                "target": target,
            }
            return state, (c_loss, a_loss, q_mean)

        def train_step(state, es, rb, obs, key):
            k_collect, k_grad = jax.random.split(key)
            es, rb, obs, (rewards, terms) = collect(state, es, rb, obs, k_collect)

            def body(state, key):
                return grad_update(state, rb, key)

            state, (c_losses, a_losses, q_means) = jax.lax.scan(
                body, state, jax.random.split(k_grad, cfg.grad_steps)
            )
            metrics = {
                "critic_loss": c_losses.mean(),
                "actor_loss": a_losses.mean(),
                "q_mean": q_means.mean(),
                "alpha": jnp.exp(state["log_alpha"]),
                "mean_reward": rewards.mean(),
                "terminated_frac": terms.astype(jnp.float32).mean(),
            }
            return state, es, rb, obs, metrics

        return train_step

    # ------------------------------------------------------------------
    def init_envs(self, key):
        es, first = self.env.reset(key)
        return es, self._empty_replay, first.obs

    def warmup(self, es, rb, obs, key):
        """Prefill the buffer with one collect phase of uniform actions."""
        es, rb, obs, _ = self._warmup(self.state, es, rb, obs, key)
        return es, rb, obs

    def train(self, iterations: int, key=None, warmup_rounds: int = 2, log_every: int = 1):
        key = key if key is not None else jax.random.PRNGKey(1)
        key, k0 = jax.random.split(key)
        es, rb, obs = self.init_envs(k0)
        for _ in range(warmup_rounds):
            key, k = jax.random.split(key)
            es, rb, obs = self.warmup(es, rb, obs, k)
        history = []
        for it in range(iterations):
            key, k = jax.random.split(key)
            self.state, es, rb, obs, metrics = self._train_step(self.state, es, rb, obs, k)
            if it % log_every == 0:
                history.append({k_: float(np.asarray(v)) for k_, v in metrics.items()})
        return history

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint all learner state (params, targets, opts, alpha)."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump(
                {
                    "state": jax.tree.map(
                        lambda x: np.asarray(x) if hasattr(x, "shape") else x, self.state
                    ),
                    "config": dataclasses.asdict(self.cfg),
                },
                f,
            )

    def load(self, path: str):
        import pickle

        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        self.state = jax.tree.map(
            lambda x: jnp.asarray(x) if hasattr(x, "shape") else x, ckpt["state"]
        )
