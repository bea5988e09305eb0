"""The stage-banded MPC solver backend (agents/mpc_banded.py).

The banded backend must be *indistinguishable* from the dense one where
both apply (same LP, same ADMM math, same polish), while scaling to the
horizons/networks the dense assembly cannot reach (horizon 20, feeder141).
"""

import numpy as np
import pytest

import gym_anm_tpu
from gym_anm_tpu.agents import (
    MPCAgentConstant,
    MPCAgentConstantBanded,
    MPCAgentPerfect,
    MPCAgentPerfectBanded,
)

TOL = 1e-6


def _stepped_env(n_warm=3, seed=42):
    env = gym_anm_tpu.envs.ANM6Easy()
    env.reset(seed=seed)
    for _ in range(n_warm):
        env.step(np.zeros(env.action_space.shape, dtype=np.float64))
    return env


def test_banded_dense_lp_mirror_identical():
    """The banded builder's dense mirror reproduces the dense builder's
    (A, l, u, q) rows exactly (up to row order within a stage)."""
    env = _stepped_env()
    for N in (1, 3):
        dense = MPCAgentConstant(env.simulator, env.action_space, env.gamma, planning_steps=N)
        banded = MPCAgentConstantBanded(env.simulator, env.action_space, env.gamma, planning_steps=N)
        assert banded.nz == dense.nz
        assert banded.A.shape == dense.A.shape
        np.testing.assert_allclose(np.sort(banded.q), np.sort(dense.q))
        # Row-set equality: every dense row (with its bounds) appears in the
        # banded mirror and vice versa.
        def rowset(A, l, u):
            rows = np.concatenate([A, l[:, None], np.where(np.isfinite(u), u, 1e30)[:, None]], axis=1)
            return np.array(sorted(map(tuple, np.round(rows, 9))))

        np.testing.assert_allclose(
            rowset(banded.A, banded.l, banded.u), rowset(dense.A, dense.l, dense.u), atol=1e-9
        )


@pytest.mark.parametrize("planning_steps", [1, 3])
def test_banded_matches_dense_actions(planning_steps):
    env = _stepped_env()
    dense = MPCAgentConstant(env.simulator, env.action_space, env.gamma, planning_steps=planning_steps)
    banded = MPCAgentConstantBanded(env.simulator, env.action_space, env.gamma, planning_steps=planning_steps)
    for _ in range(3):
        ad, ab = dense.act(env), banded.act(env)
        np.testing.assert_allclose(ab, ad, atol=1e-5)
        env.step(ad)


def test_banded_feeder33():
    """Banded backend on a bigger network: optimal to the same HiGHS oracle
    as the dense backend (the LP is degenerate, so the two backends may
    return different optimal vertices -- actions agree to ~MW-negligible
    1e-2, objectives to 1e-3) and keeps the feeder alive."""
    from scipy.optimize import linprog

    from gym_anm_tpu.envs import Feeder33Env

    env = Feeder33Env(seed=3)
    env.reset(seed=3)
    dense = MPCAgentConstant(env.simulator, env.action_space, env.gamma, planning_steps=2)
    banded = MPCAgentConstantBanded(env.simulator, env.action_space, env.gamma, planning_steps=2)
    for t in range(3):
        ad, ab = dense.act(env), banded.act(env)
        assert env.action_space.contains(ab.astype(np.float64))
        # Renewable dispatch is cost-free, so its split across PV units is a
        # degenerate direction: compare *objectives* (both must match the
        # HiGHS optimum), not per-entry actions.
        sol = banded.last_solution
        lv, uv = sol["lv"], sol["uv"]
        eq = (lv == uv) & np.isfinite(lv)
        ub = np.isfinite(uv) & ~eq
        lb = np.isfinite(lv) & ~eq
        res = linprog(
            banded.q,
            A_ub=np.vstack([banded.A[ub], -banded.A[lb]]),
            b_ub=np.concatenate([uv[ub], -lv[lb]]),
            A_eq=banded.A[eq],
            b_eq=lv[eq],
            bounds=[(None, None)] * banded.nz,
            method="highs",
        )
        assert abs(banded.q @ sol["x"] - res.fun) < 1e-3
        assert abs(dense.q @ dense.last_solution["x"] - res.fun) < 1e-3
        _, r, terminated, _, _ = env.step(ab)
        assert not terminated


@pytest.mark.slow
def test_banded_feeder141_horizon5():
    """The dense assembly is infeasible here (S=455/stage); the banded
    backend plans at horizon 5 on the 141-bus network, its solution is
    feasible to ADMM tolerance, and the grid survives under its control."""
    from gym_anm_tpu.envs import Feeder141Env

    env = Feeder141Env()
    env.reset(seed=7)
    agent = MPCAgentConstantBanded(
        env.simulator, env.action_space, env.gamma, safety_margin=0.96, planning_steps=5
    )
    assert agent.nz > agent.POLISH_MAX_NZ  # genuinely past the dense-polish regime
    for t in range(3):
        a = agent.act(env)
        assert env.action_space.contains(a.astype(np.float64))
        sol = agent.last_solution
        Ax = agent.A @ sol["x"]  # dense mirror exists below MIRROR_MAX_NZ
        # No polish at this size: feasibility to ADMM residual tolerance.
        assert np.max(np.maximum(0.0, sol["lv"] - Ax)) < 1e-4
        assert np.max(np.maximum(0.0, Ax - sol["uv"])) < 1e-4
        _, r, terminated, _, _ = env.step(a)
        assert not terminated


@pytest.mark.slow
def test_banded_feeder141_horizon20():
    """Production scale: horizon 20 on the 141-bus network (nz = 9100, past
    the dense-mirror limit).  Feasibility is checked through the banded
    ``apply_A_host`` (no dense A exists at this size) and the objective is
    cross-checked against the HiGHS optimum on the sparse assembly --
    the scale anchor of the reference CI
    (/root/reference/tests/test_dcopf_agent.py:57, horizon 20)."""
    from scipy.optimize import linprog
    from scipy import sparse

    from gym_anm_tpu.envs import Feeder141Env

    env = Feeder141Env()
    env.reset(seed=11)
    agent = MPCAgentConstantBanded(
        env.simulator, env.action_space, env.gamma, safety_margin=0.96, planning_steps=20
    )
    assert agent.A is None and agent.nz > agent.MIRROR_MAX_NZ  # genuinely past the mirror
    a = agent.act(env)
    assert env.action_space.contains(a.astype(np.float64))
    sol = agent.last_solution
    Ax = agent.apply_A_host(sol["x"])
    assert np.max(np.maximum(0.0, sol["lv"] - Ax)) < 1e-4
    assert np.max(np.maximum(0.0, Ax - sol["uv"])) < 1e-4

    # Objective parity vs the HiGHS oracle on the sparse assembly.
    A = agent.sparse_A()
    lv, uv = sol["lv"], sol["uv"]
    eq = (lv == uv) & np.isfinite(lv)
    ub = np.isfinite(uv) & ~eq
    lb = np.isfinite(lv) & ~eq
    res = linprog(
        agent.q,
        A_ub=sparse.vstack([A[ub], -A[lb]]),
        b_ub=np.concatenate([uv[ub], -lv[lb]]),
        A_eq=A[eq],
        b_eq=lv[eq],
        bounds=[(None, None)] * agent.nz,
        method="highs",
    )
    assert res.status == 0
    assert abs(agent.q @ sol["x"] - res.fun) < 1e-2 + 1e-3 * abs(res.fun)

    _, r, terminated, _, _ = env.step(a)
    assert not terminated


def test_banded_apply_A_host_matches_dense_mirror():
    """apply_A_host (the scale-independent banded A @ x) equals the dense
    mirror's product where the mirror exists."""
    env = _stepped_env()
    agent = MPCAgentConstantBanded(env.simulator, env.action_space, env.gamma, planning_steps=3)
    assert agent.A is not None
    rng = np.random.default_rng(0)
    x = rng.normal(size=agent.nz)
    np.testing.assert_allclose(agent.apply_A_host(x), agent.A @ x, atol=1e-12)
    np.testing.assert_allclose(agent.sparse_A().toarray(), agent.A, atol=0)


def test_banded_batched_matches_single():
    env = _stepped_env()
    agent = MPCAgentConstantBanded(env.simulator, env.action_space, env.gamma, planning_steps=4)
    single = agent.act(env)
    sv = np.asarray(env.state)[None, :].repeat(4, axis=0)
    acts = agent.act_batch(sv)
    assert acts.shape == (4, env.action_space.shape[0])
    np.testing.assert_allclose(acts, single[None, :].repeat(4, axis=0), atol=2e-4)

    # Warm receding-horizon reuse works and matches cold solves.
    warm = agent.act_batch(sv, warm_start=True)
    np.testing.assert_allclose(warm, acts, atol=1e-5)
    warm2 = agent.act_batch(sv, warm_start=True)
    np.testing.assert_allclose(warm2, acts, atol=2e-4)


def test_perfect_act_batch_matches_single():
    """MPCAgentPerfect.act_batch (new in r2) reproduces the host-path
    per-env actions from canonical state vectors."""
    env = _stepped_env(n_warm=2, seed=5)
    single_agent = MPCAgentPerfect(
        env.simulator, env.action_space, env.gamma, safety_margin=0.96, planning_steps=4
    )
    batch_agent = MPCAgentPerfect(
        env.simulator,
        env.action_space,
        env.gamma,
        safety_margin=0.96,
        planning_steps=4,
        P_loads=env.P_loads,
        P_maxs=env.P_maxs,
    )
    a_single = single_agent.act(env)
    sv = np.asarray(env.state)[None, :]
    a_batch = batch_agent.act_batch(sv)
    np.testing.assert_allclose(a_batch[0], a_single, atol=2e-2)

    # Banded combo class drives the same forecasts.
    banded = MPCAgentPerfectBanded(
        env.simulator,
        env.action_space,
        env.gamma,
        safety_margin=0.96,
        planning_steps=4,
        P_loads=env.P_loads,
        P_maxs=env.P_maxs,
    )
    a_banded = banded.act_batch(sv)
    np.testing.assert_allclose(a_banded[0], a_single, atol=2e-2)


def test_perfect_act_batch_requires_tables():
    env = _stepped_env(n_warm=0)
    agent = MPCAgentPerfect(env.simulator, env.action_space, env.gamma, planning_steps=2)
    with pytest.raises(ValueError, match="daily tables"):
        agent.act_batch(np.asarray(env.state)[None, :])


@pytest.mark.slow
def test_banded_sparse_polish_batch_feeder141():
    """The mixed-precision accuracy mode (solve_batch(polish=True)): the
    host-side f64 sparse-KKT active-set polish recovers LP-optimal
    objectives at feeder141 scale, where no dense mirror/polish can exist.
    Each polished lane must be primal-feasible and match the HiGHS optimum
    of its own LP to solver precision."""
    from scipy import sparse
    from scipy.optimize import linprog

    from gym_anm_tpu.envs import Feeder141Env
    from gym_anm_tpu.envs.feeder141 import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    host = Feeder141Env()
    host.reset(seed=3)
    agent = MPCAgentConstantBanded(
        host.simulator, host.action_space, host.gamma, safety_margin=0.96, planning_steps=5
    )
    assert agent.nz > agent.POLISH_MAX_NZ  # genuinely past the dense polish

    core = make_core()
    env = BatchedEnv(core, batch_size=2)
    import jax

    es, first = env.reset(jax.random.PRNGKey(5))
    sv = np.asarray(first.state_vec)
    agent.act_batch(sv, polish=True)
    sol = agent.last_batch_solution
    A = agent.sparse_A()
    for b in range(2):
        x, lv, uv = sol["x"][b], sol["lv"][b], sol["uv"][b]
        Ax = agent.apply_A_host(x)
        assert np.max(np.maximum(0.0, np.maximum(lv - Ax, Ax - uv))) < 2e-6
        eq = (lv == uv) & np.isfinite(lv)
        ub = np.isfinite(uv) & ~eq
        lb = np.isfinite(lv) & ~eq
        res = linprog(
            agent.q,
            A_ub=sparse.vstack([A[ub], -A[lb]]),
            b_ub=np.concatenate([uv[ub], -lv[lb]]),
            A_eq=A[eq],
            b_eq=lv[eq],
            bounds=[(None, None)] * agent.nz,
            method="highs",
        )
        assert res.status == 0
        gap = abs(float(agent.q @ x) - res.fun) / max(1.0, abs(res.fun))
        assert gap < 1e-6, f"lane {b}: polished objective gap {gap:.2e}"


def test_sparse_polish_recovers_exact_optimum_from_f32_seed():
    """The add/drop sparse-KKT polish reaches the HiGHS optimum to solver
    precision from a committed f32 ADMM seed batch (feeder141 h5, captured
    on the round-5 calibration run with its HiGHS objectives).

    Pins the three round-5 polish defect fixes: iterative refinement of
    the delta-regularized KKT (leak undercut the optimum by up to 0.7%),
    best-feasible acceptance (never objective-compare against the
    infeasible ADMM point), and one-at-a-time dual-sign drops (bulk drops
    diverged on lane 5 of this very batch).  No ADMM runs here -- the
    fixture replays only the host polish, so the test is fast.
    """
    import os

    from gym_anm_tpu.envs import Feeder141Env

    data = np.load(os.path.join(os.path.dirname(__file__), "data", "polish_calib_feeder141.npz"))
    env = Feeder141Env()
    env.reset(seed=0)
    agent = MPCAgentConstantBanded(
        env.simulator, env.action_space, env.gamma, planning_steps=5
    )
    out = agent._polish_batch(
        data["xs"].astype(np.float64),
        (None, data["z"], data["y"]),
        data["lv"],
        data["uv"],
    )
    q = agent.q
    for b in range(out.shape[0]):
        lv, uv = data["lv"][b], data["uv"][b]
        Ax = agent.apply_A_host(out[b])
        viol = max(np.max(np.maximum(0, lv - Ax)), np.max(np.maximum(0, Ax - uv)))
        gap = abs(q @ out[b] - data["highs_opt"][b]) / max(1.0, abs(data["highs_opt"][b]))
        assert viol < 1e-9, (b, viol)
        assert gap < 1e-8, (b, gap)
