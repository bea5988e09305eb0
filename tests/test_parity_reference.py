"""Trajectory parity against the actual reference implementation.

The reference runs from /root/reference with an exact-QP cvxpy stub (see
``tests/cvxpy_stub.py``), so its only numerical difference from our stack is
the NR linear solver (scipy sparse LU vs. batched dense solve) -- float64
round-off.  Both environments are seeded identically; both use Gymnasium's
PCG64 ``np_random`` with the same call order, so initial states are
bit-identical and whole trajectories must agree to ~1e-8 over 100 steps.
"""

import numpy as np
import pytest

import gym_anm_tpu


def _rollout(env, n_steps, action_seed=123):
    env.action_space.seed(action_seed)
    obs, _ = env.reset(seed=7)
    traj = {"obs": [obs], "r": [], "state": [], "term": []}
    for _ in range(n_steps):
        a = env.action_space.sample()
        obs, r, term, trunc, _ = env.step(a)
        traj["obs"].append(obs)
        traj["r"].append(r)
        traj["state"].append(np.array(env.unwrapped.state, copy=True))
        traj["term"].append(term)
        if term:
            break
    return traj


@pytest.mark.parametrize("n_steps", [100])
def test_anm6easy_trajectory_parity(reference, n_steps):
    ref_env = reference.envs.ANM6Easy()
    jax_env = gym_anm_tpu.envs.ANM6Easy()

    # Identical spaces.
    np.testing.assert_allclose(ref_env.action_space.low, jax_env.action_space.low)
    np.testing.assert_allclose(ref_env.action_space.high, jax_env.action_space.high)
    np.testing.assert_allclose(ref_env.observation_space.low, jax_env.observation_space.low)
    np.testing.assert_allclose(ref_env.observation_space.high, jax_env.observation_space.high)

    ref = _rollout(ref_env, n_steps)
    ours = _rollout(jax_env, n_steps)

    assert len(ref["r"]) == len(ours["r"])
    np.testing.assert_allclose(ours["obs"][0], ref["obs"][0], atol=1e-8, rtol=1e-8)
    for t, (ro, to) in enumerate(zip(ref["obs"], ours["obs"])):
        np.testing.assert_allclose(to, ro, atol=1e-7, rtol=1e-7, err_msg=f"obs diverged at t={t}")
    np.testing.assert_allclose(ours["r"], ref["r"], atol=1e-7, rtol=1e-7)
    assert ref["term"] == ours["term"]


def test_simulator_transition_parity(reference):
    """Direct Simulator.transition parity on the 6-bus grid over a sweep of
    injections (exercises projections, NR, branch flows, reward)."""
    from gym_anm_tpu.envs.anm6.network import network as net_jax
    from gym_anm.envs.anm6_env.network import network as net_ref

    ref_sim = reference.simulator.Simulator(net_ref, delta_t=0.25, lamb=100)
    jax_sim = gym_anm_tpu.Simulator(net_jax, delta_t=0.25, lamb=100)

    rng = np.random.default_rng(0)
    s0 = np.zeros(2 * 7 + 1 + 2)
    s0[:7] = [0, -2, 20, -5, 30, -10, 10]
    s0[7:14] = [0, -0.4, 5, -1, -5, -2, 0]
    s0[14] = 50.0
    s0[15:17] = [25, 40]
    assert ref_sim.reset(s0) == jax_sim.reset(s0) == True  # noqa: E712

    for _ in range(25):
        P_load = {1: -10 * rng.random(), 3: -30 * rng.random(), 5: -30 * rng.random()}
        P_pot = {2: 30 * rng.random(), 4: 50 * rng.random()}
        P_set = {2: 30 * rng.random(), 4: 50 * rng.random(), 6: -50 + 100 * rng.random()}
        Q_set = {2: -30 + 60 * rng.random(), 4: -50 + 100 * rng.random(), 6: -50 + 100 * rng.random()}

        ref_state, ref_r, ref_e, ref_pen, ref_conv = ref_sim.transition(P_load, P_pot, P_set, Q_set)
        jax_state, jax_r, jax_e, jax_pen, jax_conv = jax_sim.transition(P_load, P_pot, P_set, Q_set)

        assert ref_conv == jax_conv
        np.testing.assert_allclose(jax_r, ref_r, atol=1e-8, rtol=1e-8)
        np.testing.assert_allclose(jax_e, ref_e, atol=1e-9, rtol=1e-8)
        np.testing.assert_allclose(jax_pen, ref_pen, atol=1e-8, rtol=1e-8)

        for key in ref_state:
            # Both solvers stop at the shared mismatch criterion xtol=1e-5,
            # so their iterates agree only to ~xtol; angles of near-zero
            # currents amplify that absolute difference.  Power/voltage
            # quantities agree to float64-level tolerances.
            atol, rtol = (1e-4, 1e-4) if key.endswith("_ang") or key.endswith("i_magn") else (1e-6, 1e-6)
            for unit in ref_state[key]:
                for i in ref_state[key][unit]:
                    np.testing.assert_allclose(
                        jax_state[key][unit][i],
                        ref_state[key][unit][i],
                        atol=atol,
                        rtol=rtol,
                        err_msg=f"{key}[{unit}][{i}]",
                    )


def test_state_and_action_space_parity(reference):
    ref_env = reference.envs.ANM6Easy()
    jax_env = gym_anm_tpu.envs.ANM6Easy()

    ref_b = ref_env.simulator.state_bounds
    jax_b = jax_env.simulator.state_bounds
    assert set(ref_b.keys()) == set(jax_b.keys())
    for key in ref_b:
        assert set(ref_b[key].keys()) == set(jax_b[key].keys()), key
        for i in ref_b[key]:
            for unit in ref_b[key][i]:
                np.testing.assert_allclose(
                    np.asarray(jax_b[key][i][unit], dtype=float),
                    np.asarray(ref_b[key][i][unit], dtype=float),
                    err_msg=f"{key}[{i}][{unit}]",
                )

    ref_specs = ref_env.simulator.get_rendering_specs()
    jax_specs = jax_env.simulator.get_rendering_specs()
    for key in ref_specs:
        for i in ref_specs[key]:
            ref_v = ref_specs[key][i]
            jax_v = jax_specs[key][i]
            if isinstance(ref_v, dict):
                for unit in ref_v:
                    np.testing.assert_allclose(
                        np.asarray(jax_v[unit], dtype=float), np.asarray(ref_v[unit], dtype=float)
                    )
            else:
                assert ref_v == jax_v
