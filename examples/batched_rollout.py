"""The batched fast path: thousands of lockstep environments.

Runs 4096 ANM6Easy environments for 128 steps as a single jitted program
and reports throughput on the default JAX device.
"""
import time

import jax

from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.envs.batched import BatchedEnv


def run(batch=4096, steps=128):
    core = make_core()
    env = BatchedEnv(core, batch_size=batch)

    key = jax.random.PRNGKey(0)
    es, first = env.reset(key)
    rollout = jax.jit(env.rollout_fn(n_steps=steps))

    es, (rew, term) = rollout(es, key)  # compile + warm up
    jax.block_until_ready(rew)

    t0 = time.time()
    es, (rew, term) = rollout(es, jax.random.fold_in(key, 1))
    jax.block_until_ready(rew)
    dt = time.time() - t0
    print(f"{batch * steps / dt:,.0f} env-steps/s on {jax.default_backend()}")


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
