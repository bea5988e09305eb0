"""Control a batched ANM6Easy fleet with the constant-forecast MPC policy.

Demonstrates the batched agent surface: ``agent.act_batch(state_vecs)``
solves one multi-stage DC-OPF per environment lane in a single on-device
ADMM program (per-lane adaptive rho) and returns the [B, action_n] action
matrix for ``BatchedEnv.step``.
"""
import jax
import numpy as np

from gym_anm_tpu import MPCAgentConstant
from gym_anm_tpu.envs import ANM6Easy
from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.envs.batched import BatchedEnv


def run(batch_size=16, horizon=3, steps=10):
    core = make_core(pf_max_iter=100)
    env = BatchedEnv(core, batch_size=batch_size)
    key = jax.random.PRNGKey(0)
    es, out = env.reset(key)

    # The agent is built from any host env over the same network.
    host_env = ANM6Easy()
    host_env.reset(seed=0)
    agent = MPCAgentConstant(
        host_env.simulator, host_env.action_space, host_env.gamma, planning_steps=horizon
    )

    state_vecs = np.asarray(out.state_vec)
    for t in range(steps):
        # warm_start: each solve resumes from the previous step's ADMM
        # iterate (receding-horizon warm start) -- same actions to solver
        # tolerance, a fraction of the cold-start iteration budget.
        actions = agent.act_batch(state_vecs, warm_start=True)
        es, out = env.step(es, actions, jax.random.fold_in(key, t))
        r = np.asarray(out.reward)
        term = np.asarray(out.terminated)
        print(f"t={t}: mean r={r.mean():+.4f}  worst r={r.min():+.4f}  collapsed={int(term.sum())}/{batch_size}")
        state_vecs = np.asarray(out.state_vec)


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    run()
