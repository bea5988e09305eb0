"""Train a PPO agent on batched ANM6Easy environments, fully on device."""
import jax

from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.rl import PPOConfig, PPOTrainer


def run(iterations=20, batch=256):
    trainer = PPOTrainer(make_core(), batch_size=batch, config=PPOConfig(rollout_steps=64))
    history = trainer.train(iterations, key=jax.random.PRNGKey(0))
    for i, m in enumerate(history):
        print(f"iter {i}: loss={m['loss']:.3f} mean_reward={m['mean_reward']:.3f}")


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
