"""Tree-structured NR solver: parity vs the dense solver, warm starts, and
the env-level `pf_method="tree"` / `warm_start` paths.

The dense batched solver (ops/power_flow.py) is itself parity-tested
against the reference (tests/test_power_flow.py, test_parity_reference.py),
so agreement with it to round-off transfers that chain of evidence to the
tree elimination (ops/tree_nr.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gym_anm_tpu.core.transition import resolve_solver_path, transition
from gym_anm_tpu.envs.feeder33 import make_core as make_core_33, make_feeder_network
from gym_anm_tpu.envs.feeder141 import make_core as make_core_141
from gym_anm_tpu.ops.power_flow import solve_pfe
from gym_anm_tpu.ops.tree_nr import build_tree_info, solve_pfe_tree


def _random_injections(spec, B, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    m = spec.n_bus - 1
    p = rng.uniform(-0.02, 0.01, (B, m)) * scale
    q = rng.uniform(-0.005, 0.005, (B, m)) * scale
    return jnp.asarray(p), jnp.asarray(q)


@pytest.mark.slow
@pytest.mark.parametrize("env", ["feeder33", "feeder141"])
def test_tree_matches_dense(env):
    core = (make_core_33 if env == "feeder33" else make_core_141)(pf_method="scan")
    spec = core.spec
    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    assert tree is not None
    p, q = _random_injections(spec, B=24)
    Yr, Yi = jnp.asarray(spec.Y_re), jnp.asarray(spec.Y_im)
    vr_d, vi_d, diff_d, it_d, conv_d = solve_pfe(Yr, Yi, p, q, x_tol=1e-9, max_iter=25, method="scan")
    vr_t, vi_t, diff_t, it_t, conv_t = jax.jit(
        lambda p, q: solve_pfe_tree(tree, p, q, x_tol=1e-9, max_iter=25)
    )(p, q)
    assert bool(jnp.all(conv_d)) and bool(jnp.all(conv_t))
    np.testing.assert_allclose(vr_t, vr_d, atol=1e-11)
    np.testing.assert_allclose(vi_t, vi_d, atol=1e-11)
    # Same Newton iterates => same iteration counts.
    np.testing.assert_array_equal(np.asarray(it_t), np.asarray(it_d))


def test_tree_flags_infeasible_lanes():
    """Hopelessly overloaded lanes must be flagged unconverged (not return
    a wrong converged voltage) -- the mismatch criterion guard."""
    core = make_core_33(pf_method="scan")
    spec = core.spec
    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    p, q = _random_injections(spec, B=8, scale=400.0)  # absurd loading
    vr, vi, diff, it, conv = jax.jit(
        lambda p, q: solve_pfe_tree(tree, p, q, x_tol=1e-9, max_iter=15)
    )(p, q)
    assert not bool(jnp.any(conv))


def test_tree_warm_start_semantics():
    core = make_core_33(pf_method="scan")
    spec = core.spec
    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    p, q = _random_injections(spec, B=16)
    f = jax.jit(lambda p, q, init: solve_pfe_tree(tree, p, q, x_tol=1e-9, max_iter=20, init=init))
    vr, vi, _, it_cold, conv = f(p, q, None)
    assert bool(jnp.all(conv))
    # Warm from the solution: 0 iterations, identical voltages.
    vr2, vi2, _, it_warm, conv2 = f(p, q, (vr, vi))
    assert bool(jnp.all(conv2))
    assert int(jnp.max(it_warm)) == 0
    np.testing.assert_allclose(vr2, vr, atol=0)
    # Warm from an absorbing zero state: the window guard falls back to the
    # flat start and reproduces the cold solve exactly.
    zeros = (jnp.zeros_like(vr), jnp.zeros_like(vi))
    vr3, vi3, _, it3, conv3 = f(p, q, zeros)
    np.testing.assert_array_equal(np.asarray(it3), np.asarray(it_cold))
    np.testing.assert_allclose(vr3, vr, atol=0)


def test_dense_warm_start_semantics():
    """solve_pfe's `init`: warm-from-solution converges in 0 iterations;
    invalid warm lanes flat-start; best-of guard never starts worse."""
    core = make_core_33(pf_method="scan")
    spec = core.spec
    Yr, Yi = jnp.asarray(spec.Y_re), jnp.asarray(spec.Y_im)
    p, q = _random_injections(spec, B=16)
    vr, vi, _, it_cold, conv = solve_pfe(Yr, Yi, p, q, x_tol=1e-9, max_iter=20, method="scan")
    assert bool(jnp.all(conv))
    _, _, _, it_warm, conv2 = solve_pfe(
        Yr, Yi, p, q, x_tol=1e-9, max_iter=20, method="scan", init=(vr, vi)
    )
    assert bool(jnp.all(conv2)) and int(jnp.max(it_warm)) == 0
    # NaN warm input on some lanes: those flat-start and match cold counts.
    bad = vr.at[::2].set(jnp.nan)
    _, _, _, it3, conv3 = solve_pfe(
        Yr, Yi, p, q, x_tol=1e-9, max_iter=20, method="scan", init=(bad, vi)
    )
    assert bool(jnp.all(conv3))
    np.testing.assert_array_equal(np.asarray(it3)[::2], np.asarray(it_cold)[::2])


def test_build_tree_info_rejects_meshed():
    net = make_feeder_network()
    # Add a loop-closing branch -> not a tree.
    extra = np.array([[2, 30, 0.02, 0.05, 0.0, 10.0, 1, 0]], dtype=object)
    net = dict(net, branch=np.concatenate([net["branch"], extra], axis=0))
    from gym_anm_tpu.core.grid import build_grid

    spec, _ = build_grid(net, delta_t=0.25, lamb=100)
    assert build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im) is None
    with pytest.raises(ValueError, match="radial"):
        transition(
            spec,
            jnp.zeros((spec.n_des,)),
            P_load=jnp.zeros((spec.n_load,)),
            P_pot=jnp.zeros((spec.n_gen,)),
            P_set_gen=jnp.zeros((spec.n_gen,)),
            Q_set_gen=jnp.zeros((spec.n_gen,)),
            P_set_des=jnp.zeros((spec.n_des,)),
            Q_set_des=jnp.zeros((spec.n_des,)),
            pf_method="tree",
        )


def test_resolve_solver_path_tree():
    core = make_core_141(pf_method="tree")
    soc = np.zeros((64, core.spec.n_des), core.spec.dtype)
    pl = np.zeros((64, core.spec.n_load), core.spec.dtype)
    assert resolve_solver_path(core.spec, "tree", soc, pl) == "xla_tree"


@pytest.mark.slow
@pytest.mark.parametrize("env", ["feeder33", "feeder141"])
def test_transition_tree_matches_scan(env):
    """Full env steps through pf_method='tree' vs 'scan': same terminations,
    states to round-off."""
    make = make_core_33 if env == "feeder33" else make_core_141
    core_t = make(pf_method="tree")
    core_s = make(pf_method="scan", pf_max_iter=core_t.max_iter)
    B = 16
    k = jax.random.PRNGKey(3)
    keys = jax.random.split(k, B)
    s0 = jax.vmap(core_t.init_state_fn)(keys)
    es_t = core_t.env_state_from_s0(s0)
    es_s = core_s.env_state_from_s0(s0)
    rng = np.random.default_rng(0)
    lo, hi = core_t.action_low, core_t.action_high
    for i in range(3):
        a = jnp.asarray(rng.uniform(lo, hi, (B, lo.shape[0])), core_t.spec.dtype)
        vars_keys = jax.random.split(jax.random.PRNGKey(100 + i), B)
        vars = jax.vmap(core_t.next_vars_fn)(core_t.state_vec(es_t), vars_keys)
        es_t, out_t = core_t.step(es_t, a, vars)
        es_s, out_s = core_s.step(es_s, a, vars)
        np.testing.assert_array_equal(np.asarray(out_t.terminated), np.asarray(out_s.terminated))
        np.testing.assert_allclose(
            np.asarray(out_t.state_vec), np.asarray(out_s.state_vec), atol=1e-8, rtol=1e-8
        )


def test_tree_exact_where_chord_only_misterminates():
    """The exact-fallback requirement at feeder141: on a
    stressed injection distribution (3x the benchmark envelope, near the
    loadability boundary) the default chord-only iteration provably
    mis-terminates lanes that true NR converges, while the tree solver's
    termination decisions match dense NR exactly -- the capability the
    chord-only formulation fundamentally lacks."""
    from gym_anm_tpu.ops.power_flow import flat_start_jacobian_inv_np

    core = make_core_141(pf_method="tree")
    spec = core.spec
    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    m = spec.n_bus - 1
    rng = np.random.default_rng(0)
    B = 64
    p = jnp.asarray(rng.uniform(-0.02, 0.005, (B, m)) * 3.0)
    q = jnp.asarray(rng.uniform(-0.005, 0.002, (B, m)) * 3.0)
    Yr, Yi = jnp.asarray(spec.Y_re), jnp.asarray(spec.Y_im)
    J0inv = jnp.asarray(flat_start_jacobian_inv_np(spec.Y_re, spec.Y_im, dtype=np.float64))

    _, _, _, _, conv_chord = solve_pfe(
        Yr, Yi, p, q, x_tol=1e-5, max_iter=0, method="hybrid", chord_iters=28, J0inv=J0inv
    )
    _, _, _, _, conv_tree = jax.jit(
        lambda p, q: solve_pfe_tree(tree, p, q, x_tol=1e-5, max_iter=40)
    )(p, q)
    _, _, _, _, conv_dense = solve_pfe(Yr, Yi, p, q, x_tol=1e-5, max_iter=40, method="scan")

    conv_chord, conv_tree, conv_dense = map(np.asarray, (conv_chord, conv_tree, conv_dense))
    # The chord method must demonstrably miss solvable lanes here...
    assert np.mean(conv_dense & ~conv_chord) > 0.2
    # ...while the tree solver reproduces true NR's decisions exactly.
    np.testing.assert_array_equal(conv_tree, conv_dense)


def test_feeder141_tree_f32_x_tol_plateau():
    """feeder141's f32 configs use x_tol=3e-5: the f32 mismatch plateau at
    this network size sits just above 1e-5 (Y V products are O(100) terms
    cancelling to O(0.01)), and at 1e-5 the tree solver mis-flagged 1.2%
    of a random-action rollout's lanes as collapsed vs the f64 oracle
    (round 4).  Pin the auto-selected tolerances."""
    assert make_core_141(pf_method="tree", dtype=jnp.float32).x_tol == pytest.approx(3e-5)
    assert make_core_141(pf_method="hybrid", dtype=jnp.float32).x_tol == pytest.approx(3e-5)
    # The plateau is a property of the f32 mismatch, not of a solver
    # the scan/NR-tail verification paths get it too.
    assert make_core_141(pf_method="scan", dtype=jnp.float32).x_tol == pytest.approx(3e-5)
    assert make_core_141(pf_method="tree", dtype=jnp.float64).x_tol == pytest.approx(1e-5)


@pytest.mark.slow
def test_warm_start_rollout_parity():
    """BatchedEnv rollouts with warm_start on vs off: identical terminations
    and matching trajectories to solver tolerance (the lean carry must
    transport the voltages)."""
    from gym_anm_tpu.envs.batched import BatchedEnv

    tol = 1e-8
    core_c = make_core_33(pf_method="tree", x_tol=1e-9)
    core_w = make_core_33(pf_method="tree", x_tol=1e-9, warm_start=True)
    B, T = 32, 8
    outs = []
    for core in (core_c, core_w):
        env = BatchedEnv(core, batch_size=B, auto_reset=True)
        key = jax.random.PRNGKey(7)
        k_reset, k_run = jax.random.split(key)
        es, _ = env.reset(k_reset)
        run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=T))
        es, (rew, term) = run(es, k_run)
        outs.append((np.asarray(rew), np.asarray(term)))
    (rew_c, term_c), (rew_w, term_w) = outs
    np.testing.assert_array_equal(term_w, term_c)
    np.testing.assert_allclose(rew_w, rew_c, atol=1e-6)


def test_warm_start_anm6easy_step_parity():
    from gym_anm_tpu.envs.anm6.anm6_easy import make_core

    core_c = make_core(pf_method="scan")
    core_w = make_core(pf_method="scan", warm_start=True)
    B = 16
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    s0 = jax.vmap(core_c.init_state_fn)(keys)
    es_c = core_c.env_state_from_s0(s0)
    es_w = core_w.env_state_from_s0(s0)
    rng = np.random.default_rng(1)
    lo, hi = core_c.action_low, core_c.action_high
    for i in range(4):
        a = jnp.asarray(rng.uniform(lo, hi, (B, lo.shape[0])), core_c.spec.dtype)
        vars = jax.vmap(core_c.next_vars_fn, in_axes=(0, None))(
            core_c.state_vec(es_c), jax.random.PRNGKey(50 + i)
        )
        es_c, out_c = core_c.step(es_c, a, vars)
        es_w, out_w = core_w.step(es_w, a, vars)
        np.testing.assert_array_equal(np.asarray(out_w.terminated), np.asarray(out_c.terminated))
        # Warm and cold converge to the same fixed point only to x_tol
        # (1e-5 p.u. = 1e-3 MW on the 100 MVA base); compare at that scale.
        np.testing.assert_allclose(
            np.asarray(out_w.state_vec), np.asarray(out_c.state_vec), atol=2e-3, rtol=1e-5
        )
