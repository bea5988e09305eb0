"""Standard gymnasium.vector.VectorEnv training-loop interface.

All num_envs environments step in lockstep inside one jitted XLA program
(unlike SyncVectorEnv's Python loop), with Gymnasium >= 1.0 next-step
autoreset -- plug into SB3 / CleanRL style vectorized trainers directly.
"""
import numpy as np

from gym_anm_tpu.envs import ANMVectorEnv
from gym_anm_tpu.envs.anm6.anm6_easy import make_core


def run(num_envs=256, steps=200):
    venv = ANMVectorEnv(make_core(), num_envs=num_envs, seed=0)
    obs, _ = venv.reset()
    total, episodes = 0.0, 0
    for t in range(steps):
        actions = venv.action_space.sample()
        obs, rewards, terminated, truncated, _ = venv.step(actions)
        total += rewards.sum()
        episodes += int(terminated.sum())
    print(
        f"{num_envs} envs x {steps} steps: mean reward {total / (num_envs * steps):.3f}, "
        f"{episodes} episode terminations (autoreset)"
    )


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
