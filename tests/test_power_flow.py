"""Power-flow correctness: physics-invariant checks on randomized networks
(ports tests/simulator/test_simulator_transitions.py's `_check_pfe_solution`
strategy) plus Y-bus construction vs a hand-computed transformer case
(ports test_simulator_basics.py:48-67)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gym_anm_tpu.core.grid import build_grid
from gym_anm_tpu.core.transition import transition
from gym_anm_tpu.ops.power_flow import solve_pfe


def two_bus_net():
    return {
        "baseMVA": 100,
        "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -10] + [None] * 9,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 30, 1, 0]]),
    }


def three_bus_loop_net():
    return {
        "baseMVA": 100,
        "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9], [2, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -10] + [None] * 9,
                [2, 2, 1, None, 30, 0, 30, -30] + [None] * 7,
            ],
            dtype=object,
        ),
        "branch": np.array(
            [
                [0, 1, 0.01, 0.1, 0.0, 30, 1, 0],
                [1, 2, 0.02, 0.1, 0.02, 30, 1, 0],
                [0, 2, 0.01, 0.15, 0.0, 30, 1.02, 10],
            ]
        ),
    }


def test_ybus_hand_computed_transformer():
    """Y-bus for a 3-bus network with an off-nominal transformer."""
    net = three_bus_loop_net()
    spec, recs = build_grid(net, 1.0, 10)
    Y = np.asarray(spec.Y_re) + 1j * np.asarray(spec.Y_im)

    # Recompute from the pi-model directly.
    n = 3
    Yh = np.zeros((n, n), dtype=complex)
    for row in net["branch"]:
        f, t, r, x, b, _, tap_m, shift = row
        f, t = int(f), int(t)
        ys = 1 / (r + 1j * x)
        ysh = 1j * b / 2
        tap = tap_m * np.exp(1j * np.deg2rad(shift))
        Yh[f, t] -= ys / np.conj(tap)
        Yh[t, f] -= ys / tap
        Yh[f, f] += (ys + ysh) / abs(tap) ** 2
        Yh[t, t] += ys + ysh
    np.testing.assert_allclose(Y, Yh, rtol=1e-12)


def _check_pfe_invariants(spec, st, atol=1e-5):
    """S = V conj(YV) at every bus; I = YV; branch flow equations."""
    V = np.asarray(st.bus_v_re) + 1j * np.asarray(st.bus_v_im)
    Y = np.asarray(spec.Y_re) + 1j * np.asarray(spec.Y_im)
    I_state = np.asarray(st.bus_i_re) + 1j * np.asarray(st.bus_i_im)
    S = V * np.conj(Y @ V)
    np.testing.assert_allclose(S.real, np.asarray(st.bus_p), atol=atol)
    np.testing.assert_allclose(S.imag, np.asarray(st.bus_q), atol=atol)
    np.testing.assert_allclose(Y @ V, I_state, atol=atol)
    # Slack voltage pinned at 1 + 0j.
    np.testing.assert_allclose(V[0], 1.0 + 0j, atol=1e-12)
    # Branch currents from the pi-model (via the precomputed coefficients).
    f, t = np.asarray(spec.br_f), np.asarray(spec.br_t)
    aff = np.asarray(spec.br_aff[:, 0]) + 1j * np.asarray(spec.br_aff[:, 1])
    aft = np.asarray(spec.br_aft[:, 0]) + 1j * np.asarray(spec.br_aft[:, 1])
    atf = np.asarray(spec.br_atf[:, 0]) + 1j * np.asarray(spec.br_atf[:, 1])
    att = np.asarray(spec.br_att[:, 0]) + 1j * np.asarray(spec.br_att[:, 1])
    i_from = aff * V[f] + aft * V[t]
    I_from_state = np.asarray(st.br_if_re) + 1j * np.asarray(st.br_if_im)
    np.testing.assert_allclose(i_from, I_from_state, atol=1e-9)
    # Power balance: sum of injections = losses in branches.
    s_from = V[f] * np.conj(i_from)
    i_to = atf * V[f] + att * V[t]
    s_to = V[t] * np.conj(i_to)
    np.testing.assert_allclose(np.sum(S.real), np.sum(s_from.real + s_to.real), atol=1e-4)


@pytest.mark.parametrize("net_fn", [two_bus_net, three_bus_loop_net])
def test_randomized_load_flows(net_fn):
    spec, _ = build_grid(net_fn(), delta_t=1.0, lamb=10)
    rng = np.random.default_rng(6)
    n_gen, n_des, n_load = spec.n_gen, spec.n_des, spec.n_load
    for _ in range(20):
        res = transition(
            spec,
            des_soc=jnp.zeros(n_des),
            P_load=jnp.asarray(-rng.uniform(0, 0.08, n_load)),
            P_pot=jnp.asarray(rng.uniform(0, 0.3, n_gen)),
            P_set_gen=jnp.asarray(rng.uniform(0, 0.3, n_gen)),
            Q_set_gen=jnp.asarray(rng.uniform(-0.2, 0.2, n_gen)),
            P_set_des=jnp.zeros(n_des),
            Q_set_des=jnp.zeros(n_des),
        )
        assert bool(res.pfe_converged)
        _check_pfe_invariants(spec, res.state)


def test_nr_vmap_batched_matches_single():
    """vmapped NR == per-lane NR (lockstep batch semantics)."""
    spec, _ = build_grid(three_bus_loop_net(), 1.0, 10)
    rng = np.random.default_rng(7)
    B = 16
    p = jnp.asarray(rng.uniform(-0.3, 0.3, (B, spec.n_bus - 1)))
    q = jnp.asarray(rng.uniform(-0.2, 0.2, (B, spec.n_bus - 1)))
    vmapped = jax.vmap(lambda p, q: solve_pfe(spec.Y_re, spec.Y_im, p, q))
    vr_b, vi_b, diff_b, it_b, conv_b = vmapped(p, q)
    for i in range(B):
        vr, vi, diff, it, conv = solve_pfe(spec.Y_re, spec.Y_im, p[i], q[i])
        np.testing.assert_allclose(np.asarray(vr_b[i]), np.asarray(vr), atol=1e-12)
        np.testing.assert_allclose(np.asarray(vi_b[i]), np.asarray(vi), atol=1e-12)
        assert bool(conv_b[i]) == bool(conv)
    # scan and while methods agree exactly.
    vr_s, vi_s, _, it_s, conv_s = vmapped(p, q)
    vmapped_w = jax.vmap(lambda p, q: solve_pfe(spec.Y_re, spec.Y_im, p, q, method="while"))
    vr_w, vi_w, _, it_w, conv_w = vmapped_w(p, q)
    np.testing.assert_allclose(np.asarray(vr_s), np.asarray(vr_w), atol=1e-13)
    np.testing.assert_array_equal(np.asarray(it_s), np.asarray(it_w))


def test_nr_divergence_flagged_not_raised():
    """Infeasible injections -> converged=False, finite program (no raise)."""
    spec, _ = build_grid(two_bus_net(), 1.0, 10)
    # Absurdly large load -> voltage collapse.
    vr, vi, diff, it, conv = solve_pfe(spec.Y_re, spec.Y_im, jnp.asarray([-500.0]), jnp.asarray([-500.0]))
    assert not bool(conv)


def test_transition_terminal_propagates():
    """A collapsed power flow flags pfe_converged=False end-to-end."""
    net = two_bus_net()
    net["device"][1][5] = -50000  # allow a catastrophically large load
    spec, _ = build_grid(net, 1.0, 10)
    res = transition(
        spec,
        des_soc=jnp.zeros(0),
        P_load=jnp.asarray([-500.0]),  # p.u. -> far beyond feasibility
        P_pot=jnp.zeros(0),
        P_set_gen=jnp.zeros(0),
        Q_set_gen=jnp.zeros(0),
        P_set_des=jnp.zeros(0),
        Q_set_des=jnp.zeros(0),
    )
    assert not bool(res.pfe_converged)


def test_hybrid_matches_scan_nr():
    """method='hybrid' (chord phase + NR tail) converges the same lanes to
    the same solutions as pure NR on a harsh random-injection sweep."""
    from gym_anm_tpu.envs.anm6.network import network as anm6_net

    spec, _ = build_grid(anm6_net, 0.25, 100)
    rng = np.random.default_rng(11)
    m = spec.n_bus - 1
    p = rng.uniform(np.asarray(spec.bus_p_min)[1:], np.asarray(spec.bus_p_max)[1:], size=(1024, m))
    q = rng.uniform(np.asarray(spec.bus_q_min)[1:], np.asarray(spec.bus_q_max)[1:], size=(1024, m))
    Y_re, Y_im = jnp.asarray(spec.Y_re), jnp.asarray(spec.Y_im)
    vr1, vi1, _, _, c1 = solve_pfe(Y_re, Y_im, jnp.asarray(p), jnp.asarray(q), max_iter=100, method="scan")
    vr2, vi2, _, _, c2 = solve_pfe(
        Y_re, Y_im, jnp.asarray(p), jnp.asarray(q), max_iter=8, method="hybrid", chord_iters=16
    )
    c1, c2 = np.asarray(c1), np.asarray(c2)
    np.testing.assert_array_equal(c1, c2)
    both = c1 & c2
    np.testing.assert_allclose(np.asarray(vr2)[both], np.asarray(vr1)[both], atol=1e-4)
    np.testing.assert_allclose(np.asarray(vi2)[both], np.asarray(vi1)[both], atol=1e-4)
    # Converged lanes satisfy the mismatch criterion exactly as NR does:
    # both paths stop at the shared x_tol, so solutions can only differ
    # below that tolerance.
