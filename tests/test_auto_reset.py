"""Auto-reset semantics: per-step resets and the segment-amortized pool.

RL trainers run ``BatchedEnv(auto_reset=True)``: a terminated lane must
re-enter the rollout as a live, physics-reconciled fresh state in the same
step (never the absorbing zero state, never a diverged sim state).  The
default ``auto_reset_mode="pool"`` samples one batch of fresh states per
rollout segment and terminated lanes draw from it via a rotated gather --
one reset-transition per segment instead of per step (the training-loop
throughput fix).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gym_anm_tpu.core.env_core import EnvCore
from gym_anm_tpu.core.grid import build_grid
from gym_anm_tpu.core.obs import state_values_spec
from gym_anm_tpu.envs.batched import BatchedEnv


def _collapse_core(collapse_prob=0.5):
    """2-bus EnvCore whose *in-episode* loads collapse the grid with
    probability ``collapse_prob`` per lane-step (-3000 MW across a 0.1 p.u.
    line diverges; -20 MW always converges).  Initial states always
    converge, so every termination is an in-episode collapse."""
    net = {
        "baseMVA": 100,
        "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -5000] + [None] * 9,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 30, 1, 0]]),
    }
    spec, _ = build_grid(net, delta_t=0.25, lamb=100)
    K = 0

    def init_fn(key):
        s0 = jnp.zeros((2 * spec.n_dev + spec.n_des + spec.n_gen + K,), spec.dtype)
        # A per-lane random benign load so pool entries are distinguishable.
        p = -15.0 - 10.0 * jax.random.uniform(key, (), spec.dtype)
        return s0.at[1].set(p).at[spec.n_dev + 1].set(p * 0.2)

    def next_vars_fn(s, key):
        bad = jax.random.uniform(key, ()) < collapse_prob
        return jnp.where(bad, -3000.0, -20.0).reshape(1).astype(spec.dtype)

    return EnvCore(
        spec,
        K=K,
        gamma=0.995,
        costs_clipping=(1, 100),
        obs_values=state_values_spec(spec, K),
        init_state_fn=init_fn,
        next_vars_fn=next_vars_fn,
        max_iter=10,
        pf_method="scan",
        stochastic_vars=True,
        reset_attempts=1,
    )


def test_step_mode_revives_terminated_lanes():
    core = _collapse_core(collapse_prob=0.7)
    env = BatchedEnv(core, batch_size=32, auto_reset=True, auto_reset_mode="step")
    key = jax.random.PRNGKey(0)
    es, _ = env.reset(key)
    saw_termination = False
    actions = jnp.zeros((32, core.action_n), core.spec.dtype)
    for i in range(6):
        es, out = env.step(es, actions, jax.random.fold_in(key, i))
        term = np.asarray(out.terminated)
        saw_termination |= term.any()
        # Auto-reset: the *carried* state is live again everywhere.
        assert not np.asarray(es.terminated).any()
        sv = np.asarray(core.state_vec(es))
        assert np.isfinite(sv).all()
        # Revived lanes hold a real fresh state, not the absorbing zeros.
        assert (np.abs(sv).sum(axis=-1) > 0).all()
    assert saw_termination  # the scenario actually exercised termination


def test_pool_mode_rollout_revives_lanes():
    core = _collapse_core(collapse_prob=0.5)
    env = BatchedEnv(core, batch_size=64, auto_reset=True)  # pool is the default
    assert env.auto_reset_mode == "pool"
    key = jax.random.PRNGKey(1)
    es, _ = env.reset(key)
    run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=24))
    es, (rew, term) = run(es, jax.random.fold_in(key, 7))
    frac = float(np.asarray(term).mean())
    # Termination keeps firing (collapse_prob per step) but never saturates:
    # lanes revive from the pool every step.
    assert 0.2 < frac < 0.8, frac
    per_step = np.asarray(term).mean(axis=1)
    assert per_step[-1] < 0.95  # still live lanes at the end
    assert np.isfinite(np.asarray(rew)).all()


def test_pool_gather_uses_pool_entries():
    """A lane terminated this step comes back holding exactly a pool entry,
    drawn i.i.d. per lane (sampling with replacement -- NOT a shared
    rotation, which would hand co-reborn lanes pool entries at fixed
    relative offsets)."""
    core = _collapse_core(collapse_prob=1.0)  # every lane collapses
    B = 16
    env = BatchedEnv(core, batch_size=B, auto_reset=True)
    key = jax.random.PRNGKey(2)
    es, _ = env.reset(key)
    fresh = jax.jit(env.fresh_states)(jax.random.fold_in(key, 1))
    actions = jnp.zeros((B, core.action_n), core.spec.dtype)
    step = jax.jit(lambda es, a, k: env.step_fn(es, a, k, fresh=fresh))
    es2, out = step(es, actions, jax.random.fold_in(key, 2))
    assert np.asarray(out.terminated).all()
    pool = np.asarray(core.state_vec(fresh))

    def pool_index(row):
        hits = np.where(np.all(np.isclose(pool, row[None, :], atol=1e-6), axis=1))[0]
        assert hits.size >= 1, row  # every reborn lane holds a pool row
        return int(hits[0])

    idx2 = np.array([pool_index(r) for r in np.asarray(core.state_vec(es2))])
    # i.i.d. draws: not all lanes landed on one entry, and (across two
    # independent reset keys) the per-lane index *differences* are not a
    # constant offset -- which is exactly what a shared rotation produces.
    es3, _ = step(es, actions, jax.random.fold_in(key, 3))
    idx3 = np.array([pool_index(r) for r in np.asarray(core.state_vec(es3))])
    assert len(set(idx2.tolist())) > 1
    assert len(set(((idx3 - idx2) % B).tolist())) > 1, (idx2, idx3)


def test_pool_and_step_modes_agree_statistically():
    """Both auto-reset modes keep the fleet alive with the same stationary
    behavior (same benign-load distribution): mean rewards over a segment
    agree loosely."""
    means = {}
    for mode in ("pool", "step"):
        core = _collapse_core(collapse_prob=0.3)
        env = BatchedEnv(core, batch_size=128, auto_reset=True, auto_reset_mode=mode)
        key = jax.random.PRNGKey(3)
        es, _ = env.reset(key)
        run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=32))
        _, (rew, term) = run(es, jax.random.fold_in(key, 5))
        means[mode] = float(np.asarray(rew).mean())
    # Terminal rewards dominate (-c2/(1-gamma)); both modes see the same
    # collapse rate, so means agree to ~10%.
    assert abs(means["pool"] - means["step"]) < 0.15 * max(1.0, abs(means["step"])), means
