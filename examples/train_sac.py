"""Train a SAC agent on batched ANM6Easy environments, fully on device.

Off-policy counterpart to ``train_ppo.py``: the replay buffer lives on the
device and each iteration (environment collection + gradient updates) is one
jitted program.
"""
import jax

from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.rl import SACConfig, SACTrainer


def run(iterations=20, batch=256):
    cfg = SACConfig(collect_steps=32, grad_steps=64, train_batch=512)
    trainer = SACTrainer(make_core(), batch_size=batch, config=cfg)
    history = trainer.train(iterations, key=jax.random.PRNGKey(0))
    for i, m in enumerate(history):
        print(
            f"iter {i}: critic={m['critic_loss']:.3f} actor={m['actor_loss']:.3f} "
            f"alpha={m['alpha']:.3f} mean_reward={m['mean_reward']:.3f}"
        )


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
