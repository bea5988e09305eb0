"""A synthetic 141-bus multi-trunk distribution network environment.

Scales the framework past the 33-bus feeder: 141 buses arranged as four
MV trunks leaving the slack substation, each trunk a chain with short
laterals — the depth stays modest (like a real multi-feeder substation)
so the network is physically feasible at full load, while the Jacobian
grows to 280x280 and the chord phase of the hybrid power-flow solver
becomes almost pure matmul work.

Branch ratings are sized from the actual downstream peak load of each
branch's subtree (times a margin), so congestion is meaningful but the
network is not degenerate.  Like :mod:`feeder33`, everything is generated
deterministically from a fixed seed.

The functional core reuses the feeder machinery (the
:mod:`~gym_anm_tpu.envs.feeder33` dynamics: mean-reverting
stochastic loads around a daily profile, random renewable potentials)
with solver budgets calibrated for this network (see ``make_core``).
"""

from __future__ import annotations

import numpy as np

from .feeder33 import make_core as _feeder_make_core


def make_multi_feeder_network(
    n_bus: int = 141,
    seed: int = 0,
    n_trunks: int = 4,
    lateral_len: int = 4,
    lateral_every: int = 3,
) -> dict:
    """Deterministic synthetic multi-trunk network dict.

    Bus 0 is the 132 kV slack substation; ``n_trunks`` 12.66 kV trunks leave
    it. Along each trunk a ``lateral_len``-bus lateral is attached every
    ``lateral_every`` chain buses until the bus budget is exhausted.
    """
    rng = np.random.default_rng(seed)

    # ---- topology ------------------------------------------------------
    branches = []  # (from, to, is_trunk)
    parent = {0: None}
    next_bus = 1
    budget = n_bus - 1
    per_trunk = [budget // n_trunks + (1 if i < budget % n_trunks else 0) for i in range(n_trunks)]
    for trunk_budget in per_trunk:
        remaining = trunk_budget
        prev = 0
        chain_pos = 0
        while remaining > 0:
            # Extend the trunk chain.
            branches.append((prev, next_bus, True))
            parent[next_bus] = prev
            prev = next_bus
            next_bus += 1
            remaining -= 1
            chain_pos += 1
            if chain_pos % lateral_every == 0 and remaining > 0:
                lp = prev
                for _ in range(min(lateral_len, remaining)):
                    branches.append((lp, next_bus, False))
                    parent[next_bus] = lp
                    lp = next_bus
                    next_bus += 1
                    remaining -= 1
    assert next_bus == n_bus

    bus_rows = [[0, 0, 132, 1.0, 1.0]]
    for i in range(1, n_bus):
        bus_rows.append([i, 1, 12.66, 1.1, 0.9])

    # ---- devices -------------------------------------------------------
    # Loads on every non-slack bus; PV on every 8th bus; storage at the
    # ends of the four trunks.
    dev_rows = [[0, 0, 0, None, 500, -500, 500, -500] + [None] * 7]
    dev_id = 1
    load_peak = np.zeros(n_bus)  # |p_min| in MW, for rating computation
    pv_peak = np.zeros(n_bus)
    trunk_ends = []
    trunk_bus = {b for f, t, is_trunk in branches if is_trunk for b in (t,)}
    # The last trunk bus of each trunk: track while building was easier,
    # recompute: a trunk bus whose children contain no trunk bus.
    children = {}
    for f, t, _ in branches:
        children.setdefault(f, []).append(t)
    for b in sorted(trunk_bus):
        if not any(c in trunk_bus for c in children.get(b, [])):
            trunk_ends.append(b)

    for i in range(1, n_bus):
        p_min = -float(np.round(rng.uniform(0.25, 1.25), 3))
        load_peak[i] = -p_min
        dev_rows.append([dev_id, i, -1, 0.25, 0, p_min] + [None] * 9)
        dev_id += 1
        if i % 8 == 0:
            p_max = float(np.round(rng.uniform(1.0, 5.0), 3))
            pv_peak[i] = p_max
            dev_rows.append(
                [dev_id, i, 2, None, p_max, 0, p_max, -p_max, 0.75 * p_max, None, 0.6 * p_max, -0.6 * p_max]
                + [None] * 3
            )
            dev_id += 1
    for i in trunk_ends[: max(2, n_trunks)]:
        dev_rows.append([dev_id, i, 3, None, 4, -4, 4, -4, 3, -3, 3, -3, float(np.round(rng.uniform(10, 30), 1)), 0, 0.92])
        dev_id += 1

    # ---- branch impedances and ratings ---------------------------------
    # Rating = margin x the larger of downstream peak load and downstream
    # peak PV (reverse flow), in MVA (loads carry Q = 0.25 P).
    subtree_load = load_peak.copy()
    subtree_pv = pv_peak.copy()
    for f, t, _ in reversed(branches):  # children appear after parents
        subtree_load[f] += subtree_load[t]
        subtree_pv[f] += subtree_pv[t]

    branch_rows = []
    q_factor = float(np.sqrt(1 + 0.25**2))
    for f, t, is_trunk in branches:
        if is_trunk:
            r = rng.uniform(0.008, 0.03)
            x = rng.uniform(0.015, 0.045)
        else:
            r = rng.uniform(0.02, 0.07)
            x = rng.uniform(0.03, 0.08)
        flow = max(subtree_load[t] * q_factor, subtree_pv[t], 0.5)
        rate = float(np.round(1.4 * flow, 2))
        branch_rows.append([f, t, float(np.round(r, 5)), float(np.round(x, 5)), 0.0, rate, 1, 0])

    return {
        "baseMVA": 100.0,
        "bus": np.array(bus_rows, dtype=object),
        "device": np.array(dev_rows, dtype=object),
        "branch": np.array(branch_rows, dtype=object),
    }


_NETWORK = make_multi_feeder_network()


def make_core(
    dtype=None, pf_max_iter=None, pf_method="tree", chord_iters=28, x_tol=None, chord_precision=None,
    warm_start=False,
):
    """Pure-functional EnvCore for the 141-bus network.

    Scalable solvers at this size:

    * ``pf_method="tree"`` (default) — **true per-lane NR** via the radial
      tree-structured block elimination: O(n) per-lane solves and sparse
      Y V products, no [560, 560, B] Jacobian, no 560-wide dense
      elimination (the CUDA kernel of ops/tree_cuda.py on a GPU,
      ops/tree_nr.py elsewhere).  Exact (same solution as per-lane NR to
      round-off) with a calibrated budget of 18 iterations
      (rollout-measured p100 = 15 including termination-adjacent lanes,
      scripts/warm_calib.py; random-injection-sweep interior lanes need
      only ~3).  ``warm_start`` keeps the same budget (measured: no
      iteration savings under per-step injection jumps).
    * ``pf_method="hybrid"`` — **chord-only** (zero true-NR tail): one
      constant [560, 560] x [560, B] matmul per iteration with convergence
      masking; 28 iterations (5.6x the measured chord p100 = 5).  Inexact
      in the sense that lanes the chord method cannot converge are
      flagged terminated even if true NR would converge them (at 3x
      loading it mis-terminates 32.8% of convergeable lanes --
      tests/test_tree_nr.py).

    Budgets from this network's harsh random-injection sweep (per-bus
    aggregate bounds, the protocol of ``scripts/chord_proto.py``).  Lanes
    that diverge or stall are flagged unconverged (grid collapse), exactly
    like NR budget exhaustion.  ``pf_method="scan"`` (budget 6) keeps
    dense per-lane NR available for small-batch/CPU verification.
    """
    if pf_max_iter is None:
        if pf_method == "hybrid":
            pf_max_iter = 0
        elif pf_method in ("tree", "tree_xla"):
            pf_max_iter = 18
        else:
            pf_max_iter = 6
    if x_tol is None:
        # The float32 mismatch F = V (Y V)* - S plateaus just above the
        # reference's 1e-5 on marginal (full-load) lanes at this network
        # size: the Y V products are O(100) terms cancelling to O(0.01), so
        # f32 rounding leaves ~1e-5 p.u. of noise in the computed mismatch
        # regardless of solver (measured on the chord and tree paths -- at
        # 1e-5 the tree solver
        # mis-flagged 1.2% of a random-action rollout's lanes as collapsed
        # vs the f64 oracle, 0% at 3e-5).  3e-5 p.u. (3 kVA on the 100 MVA
        # base) sits above the plateau and below any physically meaningful
        # violation; float64 keeps the reference tolerance.
        import jax
        import jax.numpy as _jnp

        # Host-side dtype resolution (no eager device op).
        f32 = (dtype == _jnp.float32) if dtype is not None else not jax.config.jax_enable_x64
        # The plateau is a property of the f32 mismatch itself, not of any
        # solver: every f32 solver config at this size uses 3e-5,
        # including the scan/NR-tail verification paths.
        x_tol = 3e-5 if f32 else 1e-5
    if chord_precision is None and pf_method == "hybrid" and pf_max_iter == 0:
        # Chord-only solve: the J0inv @ F update products ARE the program,
        # and the chord fixed point does not depend on their precision (the
        # mismatch stays HIGHEST), so they run at the backend's default
        # matmul precision; pass chord_precision="highest" for exact-f32
        # products.
        chord_precision = "default"
    return _feeder_make_core(
        dtype=dtype, pf_max_iter=pf_max_iter, pf_method=pf_method, network=_NETWORK, chord_iters=chord_iters,
        x_tol=x_tol, chord_precision=chord_precision, warm_start=warm_start,
    )
