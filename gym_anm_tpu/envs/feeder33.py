"""A synthetic 33-bus radial distribution feeder environment.

Stress-tests the batched NR solve and constraint checks at a larger state
dimension than ANM6 (BASELINE.json config 4): 33 buses on a radial feeder
with three laterals, 22 loads, 5 renewable generators, 2 storage units.
Impedances/ratings are drawn once from realistic distribution-network
ranges with a fixed seed, so the network dict is deterministic and the
environment is reproducible.

This module holds the network and the pure-functional :func:`make_core`
for the batched fast path; the Gymnasium class is
:class:`gym_anm_tpu.envs.feeder_envs.Feeder33Env`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import jax.random as jrandom


def make_feeder_network(n_bus: int = 33, seed: int = 0) -> dict:
    """Build the deterministic synthetic radial feeder network dict."""
    rng = np.random.default_rng(seed)

    # Topology: main feeder 0-1-...-k plus three laterals.
    n_main = n_bus - 12
    branches = [(i, i + 1) for i in range(n_main - 1)]
    lateral_roots = [3, 6, 9]
    b = n_main
    for root in lateral_roots:
        prev = root
        for _ in range(4):
            if b >= n_bus:
                break
            branches.append((prev, b))
            prev = b
            b += 1

    bus_rows = [[0, 0, 132, 1.0, 1.0]]
    for i in range(1, n_bus):
        bus_rows.append([i, 1, 12.66, 1.1, 0.9])

    branch_rows = []
    for f, t in branches:
        r = rng.uniform(0.01, 0.08)
        x = rng.uniform(0.02, 0.09)
        rate = 30.0 if f == 0 else rng.uniform(8.0, 15.0)
        branch_rows.append([f, t, r, x, 0.0, rate, 1, 0])

    # Devices: slack at bus 0; loads on most buses; 5 PV; 2 storage.
    dev_rows = [[0, 0, 0, None, 500, -500, 500, -500] + [None] * 7]
    dev_id = 1
    pv_buses = set(np.linspace(4, n_bus - 2, 5, dtype=int).tolist())
    des_buses = {n_main - 1, n_bus - 1}
    for i in range(1, n_bus):
        p_min = -float(np.round(rng.uniform(0.5, 3.0), 3))
        dev_rows.append([dev_id, i, -1, 0.25, 0, p_min] + [None] * 9)
        dev_id += 1
        if i in pv_buses:
            p_max = float(np.round(rng.uniform(2.0, 8.0), 3))
            dev_rows.append(
                [dev_id, i, 2, None, p_max, 0, p_max, -p_max, 0.75 * p_max, None, 0.6 * p_max, -0.6 * p_max]
                + [None] * 3
            )
            dev_id += 1
        if i in des_buses:
            dev_rows.append([dev_id, i, 3, None, 5, -5, 5, -5, 4, -4, 4, -4, 20, 0, 0.92])
            dev_id += 1

    return {
        "baseMVA": 100.0,
        "bus": np.array(bus_rows, dtype=object),
        "device": np.array(dev_rows, dtype=object),
        "branch": np.array(branch_rows, dtype=object),
    }


_NETWORK = make_feeder_network()


def _daily_factor(t):
    """Smooth daily demand factor in [0.5, 1] peaking in the evening."""
    return 0.75 + 0.25 * np.sin(2 * np.pi * (np.asarray(t, dtype=float) / 96.0 - 0.3))


def make_core(
    dtype=None,
    pf_max_iter=None,
    pf_method="tree",
    network=None,
    chord_iters=16,
    x_tol=1e-5,
    chord_precision=None,
    warm_start=False,
):
    """Pure-functional EnvCore for the feeder (batched fast path).

    Default solver: ``pf_method="tree"`` -- true per-lane NR with the
    radial tree elimination (O(n) per-lane 2x2-block solves + sparse Y V;
    the CUDA kernel of ops/tree_cuda.py on a GPU, ops/tree_nr.py
    elsewhere): an *exact* solver whose per-iteration cost is far below
    the dense elimination.

    ``pf_method="hybrid"``: 16 chord iterations with the constant
    flat-start Jacobian (matmul-only; converges 98.6% of lanes on harsh
    random-injection sweeps) followed by a 6-iteration dense true-NR
    tail.  ``pf_max_iter=None``
    auto-selects the calibrated budget: 10 for tree (rollout-measured
    p100 = 6 incl. termination-adjacent lanes, +4 margin --
    scripts/warm_calib.py), 6 (tail) for hybrid, 15 for dense pure NR.
    ``warm_start`` keeps the same budgets (measured: warm starting saves
    no iterations on this task's per-step injection jumps -- see
    scripts/warm_calib.py)."""
    if pf_max_iter is None:
        if pf_method == "hybrid":
            pf_max_iter = 6
        elif pf_method in ("tree", "tree_xla"):
            pf_max_iter = 10
        else:
            pf_max_iter = 15
    from ..core.env_core import EnvCore
    from ..core.grid import build_grid
    from ..core.obs import state_values_spec

    net = _NETWORK if network is None else network
    spec, _ = build_grid(net, delta_t=0.25, lamb=100, dtype=dtype)
    K = 1
    # Host numpy constants (not device arrays): the hooks close over these,
    # so they fold into traced programs as constants.
    load_scale = np.asarray(-np.asarray(spec.load_p_min) * spec.baseMVA, dtype=spec.dtype)
    pv_scale = np.asarray(np.asarray(spec.gen_p_max) * spec.baseMVA, dtype=spec.dtype)
    soc_max_mwh = np.asarray(np.asarray(spec.des_soc_max) * spec.baseMVA, dtype=spec.dtype)
    load_pos = np.asarray(spec.load_pos)
    gen_pos = np.asarray(spec.gen_pos)
    n_dev, n_des, n_gen, n_load = spec.n_dev, spec.n_des, spec.n_gen, spec.n_load

    def daily(t):
        return 0.75 + 0.25 * jnp.sin(2 * jnp.pi * (t / 96.0 - 0.3))

    def init_state_fn(key):
        k1, k2, k3, k4 = jrandom.split(key, 4)
        t0 = jrandom.randint(k1, (), 0, 96).astype(spec.dtype)
        loads = -load_scale * daily(t0) * jrandom.uniform(k2, (n_load,), spec.dtype, 0.3, 0.9)
        pots = pv_scale * jrandom.uniform(k3, (n_gen,), spec.dtype, 0.2, 1.0)
        soc = jrandom.uniform(k4, (n_des,), spec.dtype) * soc_max_mwh
        s = jnp.zeros((2 * n_dev + n_des + n_gen + K,), dtype=spec.dtype)
        s = s.at[load_pos].set(loads).at[n_dev + load_pos].set(loads * 0.25)
        s = s.at[gen_pos].set(pots)
        s = s.at[2 * n_dev + n_des + jnp.arange(n_gen)].set(pots)
        s = s.at[2 * n_dev + jnp.arange(n_des)].set(soc)
        s = s.at[-1].set(t0)
        return s

    def next_vars_fn(s_t, key):
        k1, k2 = jrandom.split(key)
        aux = jnp.mod(s_t[-1] + 1, 96)
        loads = -load_scale * daily(aux) * jrandom.uniform(k1, (n_load,), spec.dtype, 0.3, 0.9)
        pots = pv_scale * jrandom.uniform(k2, (n_gen,), spec.dtype, 0.2, 1.0)
        return jnp.concatenate([loads, pots, aux.reshape(1).astype(spec.dtype)])

    return EnvCore(
        spec,
        K=K,
        gamma=0.995,
        costs_clipping=(1, 100),
        obs_values=state_values_spec(spec, K),
        aux_bounds=np.array([[0, 95]]),
        init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn,
        max_iter=pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        chord_precision=chord_precision,
        x_tol=x_tol,
        warm_start=warm_start,
        # Feeder initial states (loads at 0.3-0.9x peak) essentially always
        # converge; one masked retry round covers the tail without the old
        # 10x statically-unrolled reset sweep.
        reset_attempts=2,
    )
