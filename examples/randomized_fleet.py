"""Step a domain-randomized fleet: G grid variants x L lanes, one program.

Each variant is the 6-bus ANM6Easy grid with lognormal jitter on branch
impedances; a single policy (here: uniform random) drives the whole
heterogeneous fleet inside one jitted rollout -- the setup for training
policies robust to grid-parameter uncertainty.
"""
import jax
import numpy as np

from gym_anm_tpu.envs import MultiBatchedEnv, randomized_anm6easy_cores


def run(n_variants=4, lanes=256, steps=32):
    cores = randomized_anm6easy_cores(n_variants, seed=0, r_sigma=0.2, x_sigma=0.2)
    fleet = MultiBatchedEnv(cores, lanes_per_variant=lanes)
    states, _ = fleet.reset(jax.random.PRNGKey(0))

    rollout = jax.jit(fleet.rollout_fn(policy_fn=None, n_steps=steps))
    states, (rew, term) = rollout(states, jax.random.PRNGKey(1))

    rew = np.asarray(rew)  # [T, G, L]
    for g in range(n_variants):
        tag = "nominal " if g == 0 else f"variant {g}"
        print(f"{tag}: mean reward {rew[:, g].mean():+.3f}")


def train_robust(n_variants=4, lanes=64, iterations=10):
    """Train one PPO policy against the whole fleet (robust to grid
    parameters)."""
    from gym_anm_tpu.envs import ppo_trainer_for_fleet
    from gym_anm_tpu.rl import PPOConfig

    cores = randomized_anm6easy_cores(n_variants, seed=0, r_sigma=0.2, x_sigma=0.2)
    trainer = ppo_trainer_for_fleet(cores, lanes, config=PPOConfig(rollout_steps=32))
    for i, m in enumerate(trainer.train(iterations, key=jax.random.PRNGKey(0))):
        print(f"iter {i}: loss={m['loss']:.3f} mean_reward={m['mean_reward']:.3f}")


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
    train_robust()
