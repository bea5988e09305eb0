"""MPC DC-OPF agent integration tests (ports tests/test_dcopf_agent.py).

Runs the MPC policies on real ANM6Easy episodes and verifies, at every
step, that the ADMM+polish solution satisfies every constraint of the
N-stage DC-OPF -- DC flow balance, load pinning, generation bounds and
potential caps, SoC dynamics and bounds, angle bounds, slack angle -- and
that its objective matches an independent scipy HiGHS solve (optimality).
"""

import numpy as np
import pytest
from scipy.optimize import linprog

import gym_anm_tpu
from gym_anm_tpu.agents import MPCAgentConstant, MPCAgentPerfect

TOL = 1e-6


def _oracle_objective(agent):
    sol = agent.last_solution
    lv, uv = sol["lv"], sol["uv"]
    eq = (lv == uv) & np.isfinite(lv)
    ub = np.isfinite(uv) & ~eq
    lb = np.isfinite(lv) & ~eq
    res = linprog(
        agent.q,
        A_ub=np.vstack([agent.A[ub], -agent.A[lb]]),
        b_ub=np.concatenate([uv[ub], -lv[lb]]),
        A_eq=agent.A[eq],
        b_eq=lv[eq],
        bounds=[(None, None)] * agent.nz,
        method="highs",
    )
    return res.fun


def _check_solution(agent, check_optimal=False):
    sol = agent.last_solution
    x, lv, uv = sol["x"], sol["lv"], sol["uv"]
    Ax = agent.A @ x
    # Feasibility of every constraint row (flow balance, load pinning,
    # bounds, caps, SoC recursion, angles, slack angle, branch slacks).
    assert np.max(np.maximum(0.0, lv - Ax)) < TOL
    assert np.max(np.maximum(0.0, Ax - uv)) < TOL
    if check_optimal:
        f_star = _oracle_objective(agent)
        # A TOL-feasible point can undercut f* by ~TOL * ||dual||, and the
        # penalty coefficients are O(lamb)=100.
        assert abs(agent.q @ x - f_star) < 1e-3


@pytest.mark.parametrize("planning_steps", [1, 3, 10])
def test_mpc_constant_constraints(planning_steps):
    env = gym_anm_tpu.envs.ANM6Easy()
    env.reset(seed=11)
    agent = MPCAgentConstant(
        env.simulator, env.action_space, env.gamma, safety_margin=0.96, planning_steps=planning_steps
    )
    for t in range(25):
        a = agent.act(env)
        assert env.action_space.contains(a.astype(np.float64))
        _check_solution(agent, check_optimal=(t % 10 == 0))
        obs, r, terminated, _, _ = env.step(a)
        assert not terminated
        # A sane controller keeps the cost small on this task.
        assert r > -10


def test_mpc_perfect_runs_and_beats_random():
    env = gym_anm_tpu.envs.ANM6Easy()
    env.reset(seed=3)
    agent = MPCAgentPerfect(
        env.simulator, env.action_space, env.gamma, safety_margin=0.96, planning_steps=5
    )
    mpc_rewards = []
    for _ in range(25):
        a = agent.act(env)
        _, r, term, _, _ = env.step(a)
        assert not term
        mpc_rewards.append(r)

    env2 = gym_anm_tpu.envs.ANM6Easy()
    env2.reset(seed=3)
    env2.action_space.seed(0)
    rand_rewards = []
    for _ in range(25):
        _, r, term, _, _ = env2.step(env2.action_space.sample())
        rand_rewards.append(r)
        if term:
            break
    assert np.mean(mpc_rewards) > np.mean(rand_rewards)


def test_mpc_soc_dynamics_consistency():
    """SoC trajectory in the plan follows the split-variable dynamics."""
    env = gym_anm_tpu.envs.ANM6Easy()
    env.reset(seed=21)
    agent = MPCAgentConstant(env.simulator, env.action_space, env.gamma, planning_steps=4)
    agent.act(env)
    sol = agent.last_solution
    soc_min = np.asarray(env.simulator.spec.des_soc_min)
    soc_max = np.asarray(env.simulator.spec.des_soc_max)
    for s in range(agent.planning_steps):
        soc = sol["soc"][s]
        assert np.all(soc >= soc_min - TOL) and np.all(soc <= soc_max + TOL)


def test_batched_mpc_matches_single_and_controls_batched_envs():
    """solve_batch over B lanes matches the per-env ADMM+polish actions to
    solver tolerance and keeps a batched env fleet stable."""
    import jax

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    core = make_core(pf_max_iter=100)
    B = 8
    env = BatchedEnv(core, batch_size=B)
    key = jax.random.PRNGKey(0)
    es, first = env.reset(key)

    # A host env for the single-path comparison + agent construction.
    host_env = gym_anm_tpu.envs.ANM6Easy()
    host_env.reset(seed=0)
    agent = MPCAgentConstant(host_env.simulator, host_env.action_space, 0.995, planning_steps=3)

    state_vecs = np.asarray(first.state_vec)
    acts = agent.act_batch(state_vecs)
    assert acts.shape == (B, core.action_n)

    # Single-path oracle for one lane: feed the same forecasts through _solve.
    spec = core.spec
    d = spec.n_dev
    lane = 0
    loads = state_vecs[lane, np.asarray(spec.load_pos)] / 100.0
    p_pot = state_vecs[lane, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / 100.0
    soc = state_vecs[lane, 2 * d : 2 * d + spec.n_des] / 100.0

    class _FakeSim:
        state = {"des_soc": {"pu": dict(zip(spec.des_ids, soc))}}

    single = agent._solve(
        _FakeSim,
        np.repeat(loads[:, None], 3, axis=1),
        np.repeat(p_pot[:, None], 3, axis=1),
    )
    single = np.clip(single, host_env.action_space.low, host_env.action_space.high)
    np.testing.assert_allclose(acts[lane], single, atol=2e-2)

    # Drive the batched fleet with the batched policy: no collapses, small costs.
    for t in range(5):
        es, out = env.step(es, acts, jax.random.fold_in(key, t))
        assert not bool(np.asarray(out.terminated).any())
        assert float(np.asarray(out.reward).mean()) > -5
        acts = agent.act_batch(np.asarray(out.state_vec))


def test_batched_mpc_warm_start_matches_cold():
    """Receding-horizon warm starting (``act_batch(..., warm_start=True)``)
    reuses the previous solve's ADMM iterate and must return the same
    actions as independent cold-start solves to solver tolerance, across a
    real controlled episode (including the automatic full-budget fallback
    when the warm residual check fails)."""
    import jax

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    core = make_core(pf_max_iter=100)
    B = 4
    env = BatchedEnv(core, batch_size=B)
    key = jax.random.PRNGKey(0)
    es, first = env.reset(key)

    host_env = gym_anm_tpu.envs.ANM6Easy()
    host_env.reset(seed=0)
    warm_agent = MPCAgentConstant(host_env.simulator, host_env.action_space, 0.995, planning_steps=3)
    cold_agent = MPCAgentConstant(host_env.simulator, host_env.action_space, 0.995, planning_steps=3)

    sv = np.asarray(first.state_vec)
    acts = cold_agent.act_batch(sv)
    np.testing.assert_allclose(warm_agent.act_batch(sv, warm_start=True), acts, atol=1e-6)
    assert warm_agent._warm_carry is not None
    for t in range(3):
        es, out = env.step(es, acts, jax.random.fold_in(key, t))
        assert not bool(np.asarray(out.terminated).any())
        sv = np.asarray(out.state_vec)
        acts = cold_agent.act_batch(sv)
        warm = warm_agent.act_batch(sv, warm_start=True)
        np.testing.assert_allclose(warm, acts, atol=2e-2)

    # A batch-size change invalidates the carry instead of crashing.
    sv2 = np.repeat(sv, 2, axis=0)
    acts2 = warm_agent.act_batch(sv2, warm_start=True)
    assert acts2.shape[0] == 2 * B


def test_mpc_on_feeder33():
    """The agent generalizes to other networks: on the 33-bus feeder the
    DC-OPF stays feasible and keeps the grid alive (no collapse) for a
    short controlled episode."""
    from gym_anm_tpu.envs import Feeder33Env

    env = Feeder33Env(seed=3)
    env.reset(seed=3)
    agent = MPCAgentConstant(env.simulator, env.action_space, env.gamma, planning_steps=2)
    for t in range(5):
        a = agent.act(env)
        assert env.action_space.contains(a.astype(np.float64))
        _check_solution(agent, check_optimal=(t == 0))
        obs, r, terminated, _, _ = env.step(a)
        assert not terminated


def test_batched_mpc_warm_shift_matches_cold():
    """The receding-horizon stage shift (``warm_shift=True``) realigns the
    carried ADMM iterate by one stage; actions must still match independent
    cold solves to solver tolerance across a controlled episode."""
    import jax

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    core = make_core(pf_max_iter=100)
    B = 4
    env = BatchedEnv(core, batch_size=B)
    key = jax.random.PRNGKey(1)
    es, first = env.reset(key)

    host_env = gym_anm_tpu.envs.ANM6Easy()
    host_env.reset(seed=0)
    warm_agent = MPCAgentConstant(host_env.simulator, host_env.action_space, 0.995, planning_steps=3)
    cold_agent = MPCAgentConstant(host_env.simulator, host_env.action_space, 0.995, planning_steps=3)

    sv = np.asarray(first.state_vec)
    acts = cold_agent.act_batch(sv)
    np.testing.assert_allclose(
        warm_agent.act_batch(sv, warm_start=True, warm_shift=True), acts, atol=1e-6
    )
    for t in range(3):
        es, out = env.step(es, acts, jax.random.fold_in(key, t))
        sv = np.asarray(out.state_vec)
        acts = cold_agent.act_batch(sv)
        warm = warm_agent.act_batch(sv, warm_start=True, warm_shift=True)
        np.testing.assert_allclose(warm, acts, atol=2e-2)


def test_single_env_act_warm_start_matches_cold():
    """``MPCAgent(warm_start=True)`` carries the scaled ADMM iterate across
    consecutive ``act()`` calls (with the stage shift); the actions must
    match a cold agent's to the polish/solver tolerance over a real
    receding-horizon episode."""
    env = gym_anm_tpu.envs.ANM6Easy()
    env.reset(seed=7)
    warm_agent = MPCAgentConstant(
        env.simulator, env.action_space, 0.995, planning_steps=3, warm_start=True
    )
    cold_agent = MPCAgentConstant(env.simulator, env.action_space, 0.995, planning_steps=3)
    for _ in range(4):
        a_w = warm_agent.act(env)
        a_c = cold_agent.act(env)
        np.testing.assert_allclose(a_w, a_c, atol=2e-2)
        env.step(a_c)
    assert warm_agent._act_carry is not None
