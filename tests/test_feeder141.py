"""141-bus multi-trunk environment: construction, stepping, batching."""

import numpy as np
import jax
import pytest

from gym_anm_tpu.envs import Feeder141Env
from gym_anm_tpu.envs.feeder141 import make_core, make_multi_feeder_network


def test_network_well_formed():
    net = make_multi_feeder_network()
    assert net["bus"].shape[0] == 141
    assert net["branch"].shape[0] == 140  # radial forest from one slack
    # Every branch rating covers the subtree's load (by construction) and
    # generation is deterministic.
    net2 = make_multi_feeder_network()
    for k in ("bus", "device", "branch"):
        np.testing.assert_array_equal(
            np.asarray(net[k], dtype=object).astype(str),
            np.asarray(net2[k], dtype=object).astype(str),
        )
    # Four trunks leave the slack bus.
    from_slack = [row for row in net["branch"] if row[0] == 0]
    assert len(from_slack) == 4


def test_env_steps_and_physics():
    env = Feeder141Env()
    o, _ = env.reset(seed=0)
    assert env.simulator.N_bus == 141
    env.action_space.seed(0)
    for _ in range(5):
        a = env.action_space.sample()
        o, r, term, trunc, _ = env.step(a)
        assert not term
        assert np.isfinite(r)
    st = env.simulator.state
    v = np.array([st["bus_v_magn"]["pu"][i] for i in range(141)])
    assert np.all(v > 0.5) and np.all(v < 1.5)


def test_batched_feeder141_rollout():
    from gym_anm_tpu.envs.batched import BatchedEnv

    core = make_core()
    env = BatchedEnv(core, batch_size=8)
    key = jax.random.PRNGKey(0)
    es, first = env.reset(key)
    assert first.obs.shape == (8, core.obs_n)
    run = jax.jit(env.rollout_fn(n_steps=4))
    es, (rew, term) = run(es, key)
    assert rew.shape == (4, 8)
    assert float(np.asarray(term).mean()) < 0.5


def test_chord_only_matches_pure_nr():
    """The calibrated chord-only budget must reproduce per-lane true-NR
    termination decisions AND rewards on a random rollout (the same
    signal bench.py uses)."""
    from gym_anm_tpu.envs.batched import BatchedEnv

    key = jax.random.PRNGKey(7)
    terms, rews = [], []
    for method in ("hybrid", "scan"):
        core = make_core(pf_method=method)
        env = BatchedEnv(core, batch_size=32)
        es, _ = env.reset(key)
        run = jax.jit(env.rollout_fn(n_steps=10))
        es, (rew, term) = run(es, key)
        terms.append(np.asarray(term))
        rews.append(np.asarray(rew))
    np.testing.assert_array_equal(terms[0], terms[1])
    # Both solvers stop at mismatch <= 1e-5 with different final iterates,
    # so rewards agree to solver tolerance, not exactly.
    np.testing.assert_allclose(rews[0], rews[1], atol=5e-3)


def test_chord_precision_default_resolution():
    """The chord-only solve opts into default-precision update products;
    explicit overrides and non-chord methods are untouched."""
    from gym_anm_tpu.envs.feeder141 import make_core

    # The env default is the tree solver (no chord phase); the chord-only
    # mode auto-selects default-precision products.
    assert make_core().chord_precision is None
    assert make_core(pf_method="hybrid").chord_precision == "default"
    assert make_core(pf_method="hybrid", chord_precision="highest").chord_precision == "highest"
    assert make_core(pf_method="scan").chord_precision is None
