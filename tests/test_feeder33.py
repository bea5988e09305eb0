"""33-bus feeder environment: construction, stepping, invariants, batching."""

import numpy as np
import jax
import pytest

from gym_anm_tpu.envs import Feeder33Env
from gym_anm_tpu.envs.feeder33 import make_core, make_feeder_network


def test_network_well_formed():
    net = make_feeder_network()
    assert net["bus"].shape[0] == 33
    assert net["branch"].shape[0] == 32  # radial: n_bus - 1 branches
    # Deterministic generation.
    net2 = make_feeder_network()
    for k in ("bus", "device", "branch"):
        np.testing.assert_array_equal(
            np.asarray(net[k], dtype=object).astype(str),
            np.asarray(net2[k], dtype=object).astype(str),
        )


def test_env_steps_and_physics():
    env = Feeder33Env()
    o, _ = env.reset(seed=0)
    assert env.simulator.N_bus == 33
    env.action_space.seed(0)
    for _ in range(10):
        a = env.action_space.sample()
        o, r, term, trunc, _ = env.step(a)
        assert not term
        assert np.isfinite(r)
    # Power-flow invariant on the final state.
    st = env.simulator.state
    v = np.array([st["bus_v_magn"]["pu"][i] for i in range(33)])
    assert np.all(v > 0.5) and np.all(v < 1.5)


def test_batched_feeder_rollout():
    from gym_anm_tpu.envs.batched import BatchedEnv

    core = make_core()
    env = BatchedEnv(core, batch_size=16)
    key = jax.random.PRNGKey(0)
    es, first = env.reset(key)
    assert first.obs.shape == (16, core.obs_n)
    run = jax.jit(env.rollout_fn(n_steps=8))
    es, (rew, term) = run(es, key)
    assert rew.shape == (8, 16)
    assert float(np.asarray(term).mean()) < 0.5


def test_xla_hybrid_matches_hybrid():
    """The chord solver has one name, "hybrid" (the former "xla_hybrid"
    alias is rejected), and its default chord precision is the explicit
    "highest" -- identical states and termination decisions."""
    import jax.numpy as jnp
    import jax.random as jr

    a = make_core(pf_method="hybrid")
    b = make_core(pf_method="hybrid", chord_precision="highest")
    with pytest.raises(ValueError, match="pf_method"):
        make_core(pf_method="xla_hybrid").env_state_from_s0(jnp.zeros((1, a.expected_s0_n)))
    keys = jr.split(jr.PRNGKey(5), 16)
    ea = jax.jit(lambda ks: a.env_state_from_s0(jax.vmap(a.init_state_fn)(ks)))(keys)
    eb = jax.jit(lambda ks: b.env_state_from_s0(jax.vmap(b.init_state_fn)(ks)))(keys)
    np.testing.assert_array_equal(np.asarray(ea.terminated), np.asarray(eb.terminated))
    np.testing.assert_allclose(np.asarray(ea.sim.bus_v_re), np.asarray(eb.sim.bus_v_re), atol=0)
    np.testing.assert_allclose(np.asarray(ea.state_vec), np.asarray(eb.state_vec), atol=0)
