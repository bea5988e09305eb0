"""The ``ANM6Easy-v0`` task (reference ``envs/anm6_env/anm6_easy.py``).

Fully-observable 6-bus task with deterministic 24-hour load/generation
profiles (piecewise-constant segments joined by linear ramps, 96 quarter-
hour steps) and a single auxiliary variable: the time-of-day index.

This module holds the task's data, its pure-JAX hooks and
:func:`make_core`, the batched fast path; it needs no Gymnasium.  The
Gymnasium class :class:`~gym_anm_tpu.envs.anm6.anm6.ANM6Easy` wraps the
same hooks.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import jax.random as jrandom


def _profile(levels, ramps=None):
    """Build one 96-step daily profile: 25 + 7 + 13 + 7 + 13 + 7 + 13 + 7 + 4
    entries of [s1, s12, s2, s23, s3, s23[::-1], s2, s12[::-1], s1[:4]]
    (anm6_easy.py:77-132)."""
    s1, s12, s2, s23, s3 = levels
    return np.concatenate((s1, s12, s2, s23, s3, s23[::-1], s2, s12[::-1], s1[:4]))


def _get_load_time_series():
    """Fixed 24-hour load time-series, shape (3, 96) (anm6_easy.py:77-107)."""
    # Residential load (device 1).
    P1 = _profile(
        (-np.ones(25), np.linspace(-1.5, -4.5, 7), -5 * np.ones(13), np.linspace(-4.625, -2.375, 7), -2 * np.ones(13))
    )
    # Industrial load (device 3).
    P3 = _profile(
        (-4 * np.ones(25), np.linspace(-4.75, -9.25, 7), -10 * np.ones(13), np.linspace(-11.25, -18.75, 7), -20 * np.ones(13))
    )
    # EV-charging-station load (device 5).
    P5 = _profile(
        (np.zeros(25), np.linspace(-3.125, -21.875, 7), -25 * np.ones(13), np.linspace(-21.875, -3.125, 7), np.zeros(13))
    )
    P_loads = np.vstack((P1, P3, P5))
    assert P_loads.shape == (3, 96)
    return P_loads


def _get_gen_time_series():
    """Fixed 24-hour maximum-generation time-series, shape (2, 96)
    (anm6_easy.py:110-132)."""
    # Residential PV aggregation (device 2).
    P2 = _profile(
        (np.zeros(25), np.linspace(0.5, 3.5, 7), 4 * np.ones(13), np.linspace(7.25, 36.75, 7), 30 * np.ones(13))
    )
    # Wind farm (device 4).
    P4 = _profile(
        (40 * np.ones(25), np.linspace(36.375, 14.625, 7), 11 * np.ones(13), np.linspace(14.725, 36.375, 7), 40 * np.ones(13))
    )
    P_maxs = np.vstack((P2, P4))
    assert P_maxs.shape == (2, 96)
    return P_maxs


def make_core(
    dtype=None, pf_max_iter=None, pf_method="tree", network=None, chord_precision=None, chord_iters=16,
    warm_start=False,
):
    """Build the pure-functional ANM6Easy :class:`EnvCore` (no Gymnasium
    adapter, no host hooks) -- the batched/vmapped fast path used by
    :class:`gym_anm_tpu.envs.batched.BatchedEnv` and the benchmarks.

    ``pf_max_iter=None`` auto-selects the calibrated budget of 10: measured
    over 10k uniform-random-action steps, every converging Newton-Raphson
    solve on this task finishes in <= 8 iterations (p99.9 = 6); NR either
    converges quadratically within that budget or diverges, so 10 fixed
    masked iterations reproduce the reference's 100-cap semantics.  Pass
    ``pf_max_iter=100, pf_method="while"`` for the exact host semantics.

    ``pf_method="tree"`` (default): the 6-bus network is radial, so the
    tree-structured block elimination applies (the CUDA kernel of
    ops/tree_cuda.py on a GPU, ops/tree_nr.py elsewhere).  ``pf_method=
    "hybrid"`` runs the chord + NR-tail solver with a calibrated tail of 6
    when ``pf_max_iter`` is not given.  ``warm_start`` keeps the same budget:
    measured with scripts/warm_calib.py, warm starting saves no iterations
    here (flat-start NR is already at p50 = 3 and the uniform-random
    actions move the operating point too much) -- a measured dead end kept
    available for smoother action distributions.

    ``network`` overrides the canonical 6-bus dict (same topology/device
    layout required) -- used for domain randomization over grid parameters
    (see :mod:`gym_anm_tpu.envs.randomized`)."""
    import jax.numpy as jnp

    from ...core.env_core import EnvCore
    from ...core.grid import build_grid
    from ...core.obs import state_values_spec
    from .network import network as _canonical_network

    if network is None:
        network = _canonical_network
    if pf_max_iter is None:
        pf_max_iter = 6 if pf_method == "hybrid" else 10
    spec, _ = build_grid(network, delta_t=0.25, lamb=100, dtype=dtype)
    # Host numpy constants (not device arrays): the task hooks close over
    # these tables, so they fold into traced programs as constants.
    P_loads = np.asarray(_get_load_time_series(), dtype=spec.dtype)
    P_maxs = np.asarray(_get_gen_time_series(), dtype=spec.dtype)
    K = 1
    return EnvCore(
        spec,
        K=K,
        gamma=0.995,
        costs_clipping=(1, 100),
        obs_values=state_values_spec(spec, K),  # fully observable
        aux_bounds=np.array([[0, 95]]),
        init_state_fn=lambda key: anm6easy_init_state(key, P_loads, P_maxs),
        next_vars_fn=lambda s, key: anm6easy_next_vars(s, P_loads, P_maxs),
        max_iter=pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        chord_precision=chord_precision,
        warm_start=warm_start,
        stochastic_vars=False,  # deterministic table lookup by time-of-day
        # Measured over 10k sampled initial states: every ANM6Easy s0
        # converges on attempt 1 (the profiles are mild), so the reset
        # program need not trace/execute any masked retry round.
        reset_attempts=1,
    )


def anm6easy_init_state(key, P_loads, P_maxs):
    """Pure-functional ANM6Easy initial-state distribution.

    Matches the reference distribution (anm6_easy.py:25-52) -- including its
    p.u.-valued generator-Q / SoC quirks -- but draws from a JAX PRNG key,
    so individual samples differ from the NumPy-PCG64 host path.
    """
    n_dev, n_gen, n_des, K = 7, 2, 1, 1
    # Host tables enter the trace here and fold as program constants.
    P_loads = jnp.asarray(P_loads)
    P_maxs = jnp.asarray(P_maxs)
    k_t, k_q2, k_q4, k_soc = jrandom.split(key, 4)
    t0 = jrandom.randint(k_t, (), 0, 96)

    state = jnp.zeros((2 * n_dev + n_des + n_gen + K,), dtype=P_loads.dtype)
    state = state.at[-1].set(t0.astype(P_loads.dtype))

    qp_ratio = 0.2
    for i, dev_id in enumerate([1, 3, 5]):
        state = state.at[dev_id].set(P_loads[i, t0])
        state = state.at[n_dev + dev_id].set(P_loads[i, t0] * qp_ratio)

    # Generator (P, Q); Q sampled over p.u. bounds (+-0.3 / +-0.5), SoC over
    # p.u. bounds [0, 1] -- the reference quirk.
    q_bounds = ((-0.3, 0.3), (-0.5, 0.5))
    for idx, (dev_id, kq) in enumerate(zip([2, 4], (k_q2, k_q4))):
        state = state.at[2 * n_dev + n_des + idx].set(P_maxs[idx, t0])
        state = state.at[dev_id].set(P_maxs[idx, t0])
        lo, hi = q_bounds[idx]
        state = state.at[n_dev + dev_id].set(jrandom.uniform(kq, (), P_loads.dtype, lo, hi))

    state = state.at[2 * n_dev].set(jrandom.uniform(k_soc, (), P_loads.dtype, 0.0, 1.0))
    return state


def anm6easy_next_vars(s_t, P_loads, P_maxs):
    """Pure-functional ANM6Easy ``next_vars`` (anm6_easy.py:54-65)."""
    P_loads = jnp.asarray(P_loads)
    P_maxs = jnp.asarray(P_maxs)
    aux = jnp.mod(s_t[-1] + 1, 96).astype(jnp.int32)
    vars = jnp.concatenate(
        [P_loads[:, aux], P_maxs[:, aux], jnp.asarray(aux, dtype=P_loads.dtype).reshape(1)]
    )
    return vars
