"""Component parsing + capability-region math.

Ports the closed-form checks of tests/simulator/test_bus.py,
test_branch.py and test_devices.py, including the exact ``map_pq``
projection vectors.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gym_anm_tpu.core.grid import (
    POLY_ROW_P_CAP,
    POLY_ROW_P_FLOOR,
    _device_polytope,
    parse_branch,
    parse_bus,
    parse_generator,
    parse_load,
    parse_storage,
)
from gym_anm_tpu.errors import (
    BranchSpecError,
    BusSpecError,
    GenSpecError,
    LoadSpecError,
    StorageSpecError,
)
from gym_anm_tpu.ops.projection import project_polytope_lanes

BUS_IDS = [0, 1, 2]
BASE = 10


# ---------------------------------------------------------------------------
# Bus
# ---------------------------------------------------------------------------
def test_bus_parse():
    b = parse_bus([2, 1, 33, 1.1, 0.9])
    assert (b.id, b.type, b.baseKV, b.v_max, b.v_min, b.is_slack) == (2, 1, 33, 1.1, 0.9, False)

    s = parse_bus([0, 0, 132, 1.05, 0.95])
    assert s.is_slack and s.v_slack == 1.05


@pytest.mark.parametrize(
    "row",
    [
        [0, 2, 132, 1.1, 0.9],  # bad type
        [0, 1, 0, 1.1, 0.9],  # baseKV <= 0
        [0, 1, 132, -0.1, 0.9],  # v_max < 0
        [0, 1, 132, 1.1, -0.9],  # v_min < 0 (non-slack)
        [0, 1, 132, 0.8, 0.9],  # v_max < v_min
    ],
)
def test_bus_errors(row):
    with pytest.raises(BusSpecError):
        parse_bus(row)


# ---------------------------------------------------------------------------
# Branch
# ---------------------------------------------------------------------------
def test_branch_admittances_randomized():
    rng = np.random.default_rng(1)
    for _ in range(100):
        r, x, b = rng.uniform(0.001, 1, 3)
        rate, tap, shift = rng.uniform(1, 100), rng.uniform(0.5, 2), rng.uniform(0, 360)
        br = parse_branch([0, 1, r, x, b, rate, tap, shift], BASE, BUS_IDS)
        np.testing.assert_allclose(br.series, 1 / (r + 1j * x))
        np.testing.assert_allclose(br.shunt, 1j * b / 2)
        np.testing.assert_allclose(br.tap, tap * np.exp(1j * shift * np.pi / 180))
        np.testing.assert_allclose(br.rate, rate / BASE)


def test_branch_defaults():
    br = parse_branch([0, 1, 0.1, None, None, None, None, None], BASE, BUS_IDS)
    assert (br.x, br.b, br.rate, br.tap_magn, br.shift) == (0.0, 0.0, np.inf, 1.0, 0.0)


@pytest.mark.parametrize(
    "row",
    [
        [0, 5, 0.1, 0.1, 0, 1, 1, 0],  # unknown t_bus
        [5, 1, 0.1, 0.1, 0, 1, 1, 0],  # unknown f_bus
        [0, 1, -0.1, 0.1, 0, 1, 1, 0],  # r < 0
        [0, 1, 0.1, -0.1, 0, 1, 1, 0],  # x < 0
        [0, 1, 0, 0, 0, 1, 1, 0],  # r = x = 0
        [0, 1, 0.1, 0.1, -1, 1, 1, 0],  # b < 0
        [0, 1, 0.1, 0.1, 0, -1, 1, 0],  # rate < 0
        [0, 1, 0.1, 0.1, 0, 1, 0, 0],  # tap <= 0
        [0, 1, 0.1, 0.1, 0, 1, 1, 400],  # shift out of range
    ],
)
def test_branch_errors(row):
    with pytest.raises(BranchSpecError):
        parse_branch(row, BASE, BUS_IDS)


def test_branch_flows_formulas():
    """compute_currents / compute_power_flows vs closed form (branch.py:153-198)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.core.transition import compute_branch_flows

    net = {
        "baseMVA": 10,
        "bus": np.array([[0, 0, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -10] + [None] * 9,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.1, 0.2, 0.3, 10, 1.5, 30]]),
    }
    spec, recs = build_grid(net, 1.0, 10)
    rng = np.random.default_rng(2)
    for _ in range(20):
        v = rng.normal(size=2) + 1j * rng.normal(size=2)
        if_re, if_im, it_re, it_im, p_from, q_from, p_to, q_to, s_max = compute_branch_flows(
            spec, jnp.asarray(v.real), jnp.asarray(v.imag)
        )
        br = recs["branches"][0]
        i1 = (br.series + br.shunt) * v[0] / np.abs(br.tap) ** 2 - br.series * v[1] / np.conj(br.tap)
        i2 = (br.series + br.shunt) * v[1] - br.series * v[0] / br.tap
        np.testing.assert_allclose(np.asarray(if_re)[0] + 1j * np.asarray(if_im)[0], i1, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(it_re)[0] + 1j * np.asarray(it_im)[0], i2, rtol=1e-12)
        s_f, s_t = v[0] * np.conj(i1), v[1] * np.conj(i2)
        np.testing.assert_allclose(np.asarray(p_from)[0], s_f.real, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(q_to)[0], s_t.imag, rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(s_max)[0], np.sign(s_f.real) * max(abs(s_f), abs(s_t)), rtol=1e-12
        )


# ---------------------------------------------------------------------------
# Devices: parsing
# ---------------------------------------------------------------------------
def test_load_parse():
    d = parse_load([1, 1, -1, 0.25, 0, -10] + [None] * 9, BUS_IDS, BASE)
    assert d.qp_ratio == 0.25
    assert d.p_max == 0.0 and d.p_min == -1.0
    assert d.q_max == 0.0 and d.q_min == -0.25


@pytest.mark.parametrize(
    "row",
    [
        [1, 1, -1, None, 0, -10] + [None] * 9,  # missing Q/P
        [1, 1, -1, 0.2, 5, -10] + [None] * 9,  # P_max > 0
        [1, 1, -1, 0.2, -20, -10] + [None] * 9,  # P_max < P_min
    ],
)
def test_load_errors(row):
    with pytest.raises(LoadSpecError):
        parse_load(row, BUS_IDS, BASE)


def test_generator_tau_rho():
    row = [2, 1, 1, None, 10, 1, 2, -3, 5, None, 1, -1, None, None, None]
    g = parse_generator(row, BUS_IDS, BASE)
    tau_1 = (1 - 2) / (10 - 5)
    tau_2 = (-1 - (-3)) / (10 - 5)
    np.testing.assert_allclose(g.tau_1, tau_1)
    np.testing.assert_allclose(g.tau_2, tau_2)
    np.testing.assert_allclose(g.rho_1, 2 / BASE - tau_1 * 5 / BASE)
    np.testing.assert_allclose(g.rho_2, -3 / BASE - tau_2 * 5 / BASE)


def test_generator_no_flex_limits():
    for p_plus in [None, 10]:
        g = parse_generator([2, 1, 1, None, 10, 1, 2, -3, p_plus, None, 1, -1, None, None, None], BUS_IDS, BASE)
        assert g.tau_1 == 0 and g.tau_2 == 0
    for q_plus in [None, 5]:
        g = parse_generator([2, 1, 1, None, 10, 1, 5, -3, 5, None, q_plus, -1, None, None, None], BUS_IDS, BASE)
        assert g.tau_1 == 0
    for q_minus in [None, -3]:
        g = parse_generator([2, 1, 1, None, 10, 1, 2, -3, 5, None, 1, q_minus, None, None, None], BUS_IDS, BASE)
        assert g.tau_2 == 0


@pytest.mark.parametrize(
    "row",
    [
        [2, 1, 1, None, -5, 1, 2, -3] + [None] * 7,  # PMAX < 0
        [2, 1, 1, None, 10, -1, 2, -3] + [None] * 7,  # PMIN < 0 (non-slack)
        [2, 1, 1, None, 1, 5, 2, -3] + [None] * 7,  # PMAX < PMIN
        [2, 1, 1, None, 10, 1, -5, -3] + [None] * 7,  # QMAX < QMIN
        [2, 1, 1, None, 10, 1, 2, -3, 0.5] + [None] * 6,  # P+ < PMIN
        [2, 1, 1, None, 10, 1, 2, -3, 20] + [None] * 6,  # P+ > PMAX
        [2, 1, 1, None, 10, 1, 2, -3, 5, None, 5, -1, None, None, None],  # Q+ > QMAX
        [2, 1, 1, None, 10, 1, 2, -3, 5, None, 1, -5, None, None, None],  # Q- < QMIN
        [2, 1, 1, None, 10, 1, 2, -3, 5, None, -2, -1, None, None, None],  # Q+ < Q-
    ],
)
def test_generator_errors(row):
    with pytest.raises(GenSpecError):
        parse_generator(row, BUS_IDS, BASE)


def test_storage_parse_and_tau():
    row = [2, 1, 3, None, 10, -12, 20, -30, 5, -6, 10, -15, 100, 10, 0.9]
    s = parse_storage(row, BUS_IDS, BASE)
    assert s.eff == 0.9 and s.soc_max == 10.0 and s.soc_min == 1.0
    np.testing.assert_allclose(s.tau_1, (10 - 20) / (10 - 5))
    np.testing.assert_allclose(s.tau_2, (-15 - (-30)) / (10 - 5))
    np.testing.assert_allclose(s.tau_3, (-30 - (-15)) / (-6 - (-12)))
    np.testing.assert_allclose(s.tau_4, (20 - 10) / (-6 - (-12)))


@pytest.mark.parametrize(
    "row",
    [
        [2, 1, 3, None, -1, -12, 20, -30, None, None, None, None, 100, 10, 0.9],  # PMAX < 0
        [2, 1, 3, None, 10, 2, 20, -30, None, None, None, None, 100, 10, 0.9],  # PMIN > 0
        [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, None, 10, 0.9],  # SOC_MAX missing
        [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 100, -1, 0.9],  # SOC_MIN < 0
        [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 10, 20, 0.9],  # SOC_MAX < SOC_MIN
        [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 100, 10, 1.5],  # EFF > 1
        [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 100, 10, -0.1],  # EFF < 0
    ],
)
def test_storage_errors(row):
    with pytest.raises(StorageSpecError):
        parse_storage(row, BUS_IDS, BASE)


# ---------------------------------------------------------------------------
# map_pq (exact projection) -- ported reference vectors
# ---------------------------------------------------------------------------
def project_polytope(point, G, h):
    """One point through the lane-major projection (one device, one lane)."""
    G = np.asarray(G, np.float64)
    h = jnp.asarray(h, jnp.float64)
    x, y = project_polytope_lanes(point[None, None, 0], point[None, None, 1], G[None], h[None, :, None])
    return jnp.stack([x[0, 0], y[0, 0]])


def _gen_map_pq(row, p, q, p_pot):
    d = parse_generator(row, BUS_IDS, BASE)
    G, h = _device_polytope(d)
    h = h.copy()
    h[POLY_ROW_P_CAP] = np.clip(p_pot, d.p_min, d.p_max)
    out = project_polytope(jnp.asarray([p, q], dtype=jnp.float64), jnp.asarray(G), jnp.asarray(h))
    return np.asarray(out)


def _des_map_pq(row, p, q, soc, delta_t):
    d = parse_storage(row, BUS_IDS, BASE)
    G, h = _device_polytope(d)
    h = h.copy()
    h[POLY_ROW_P_CAP] = d.eff * (soc - d.soc_min) / delta_t
    h[POLY_ROW_P_FLOOR] = -(soc - d.soc_max) / (delta_t * d.eff)
    out = project_polytope(jnp.asarray([p, q], dtype=jnp.float64), jnp.asarray(G), jnp.asarray(h))
    return np.asarray(out)


def test_gen_map_pq_no_flex_limits():
    row = [2, 1, 1, None, 10, 1, 2, -3, None, None, None, None, None, None, None]
    rng = np.random.default_rng(3)
    for p in rng.uniform(-10, 10, 5) / BASE:
        for q in rng.uniform(-10, 10, 5) / BASE:
            for p_pot in rng.uniform(1, 10, 5) / BASE:
                out = _gen_map_pq(row, p, q, p_pot)
                true_p = np.clip(p, 1 / BASE, min(10 / BASE, p_pot))
                true_q = np.clip(q, -3 / BASE, 2 / BASE)
                np.testing.assert_allclose(out, [true_p, true_q], atol=1e-10)


def test_gen_map_pq_with_flex_limits():
    """Exact projection vectors from tests/simulator/test_devices.py:286-297."""
    row = [2, 1, 1, None, 10, 1, 2, -2, 9, None, 1, -1, None, None, None]
    points = np.array([(-1, 0.5), (5, 5), (5, -5), (12, 0), (10, 2), (10, -2)]) / BASE
    mapped = np.array([(1, 0.5), (5, 2), (5, -2), (10, 0), (9.5, 1.5), (9.5, -1.5)]) / BASE
    for (p, q), m in zip(points, mapped):
        out = _gen_map_pq(row, p, q, p_pot=10 / BASE)
        np.testing.assert_allclose(out, m, atol=1e-9)


def test_storage_map_pq_no_flex_limits():
    row = [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 1000, 0, 1]
    rng = np.random.default_rng(4)
    soc, dt = 50.0, 1.0
    ps = np.concatenate([rng.uniform(-20, -12, 5), rng.uniform(10.01, 20, 5)]) / BASE
    qs = np.concatenate([rng.uniform(-40, -30, 5), rng.uniform(20.01, 30, 5)]) / BASE
    for p in ps:
        for q in qs:
            out = _des_map_pq(row, p, q, soc, dt)
            np.testing.assert_allclose(out, [np.clip(p, -1.2, 1.0), np.clip(q, -3.0, 2.0)], atol=1e-10)
    # Interior points map to themselves.
    for p in np.array([-10, -5, 0, 5, 10]) / BASE:
        for q in np.array([-30, -10, 0, 15]) / BASE:
            np.testing.assert_allclose(_des_map_pq(row, p, q, soc, dt), [p, q], atol=1e-12)


def test_storage_map_pq_with_flex_limits():
    """Exact projection vectors from tests/simulator/test_devices.py:551-562."""
    row = [2, 1, 3, None, 10, -11, 20, -30, 5, -6, 15, -25, 1000, 0, 1]
    points = np.array([(8.5, 18.5), (8.5, -28.5), (-9.5, 18.5), (-9.5, -28.5)]) / BASE
    mapped = np.array([(7.5, 17.5), (7.5, -27.5), (-8.5, 17.5), (-8.5, -27.5)]) / BASE
    for (p, q), m in zip(points, mapped):
        out = _des_map_pq(row, p, q, soc=50.0, delta_t=1.0)
        np.testing.assert_allclose(out, m, atol=1e-9)


def test_storage_map_pq_soc_caps():
    """(Dis)charging limited by the SoC rate constraints (devices.py:501-514)."""
    row = [2, 1, 3, None, 10, -12, 20, -30, None, None, None, None, 100, 0, 0.5]
    # Nearly empty: discharge capped at eff*(soc - soc_min)/dt = 0.5*2/1 = 1 -> 0.1 pu
    out = _des_map_pq(row, 10 / BASE, 0.0, soc=2 / BASE, delta_t=1.0)
    np.testing.assert_allclose(out[0], 0.5 * (2 / BASE) / 1.0, atol=1e-10)
    # Nearly full: charging capped at p >= (soc - soc_max)/(dt*eff) = -0.04 pu
    out = _des_map_pq(row, -12 / BASE, 0.0, soc=98 / BASE, delta_t=1.0)
    np.testing.assert_allclose(out[0], (98 / BASE - 100 / BASE) / 0.5, atol=1e-10)


def test_projection_vs_scipy():
    """Random polytopes: exact projection matches an SLSQP QP solve."""
    from scipy.optimize import minimize

    rng = np.random.default_rng(5)
    for _ in range(50):
        m = 6
        G = rng.normal(size=(m, 2))
        # Ensure nonempty: all halfspaces contain the origin with margin.
        h = rng.uniform(0.1, 2.0, size=m)
        pt = rng.normal(size=2) * 2
        ours = np.asarray(
            project_polytope(jnp.asarray(pt, dtype=jnp.float64), jnp.asarray(G), jnp.asarray(h))
        )
        res = minimize(
            lambda x: np.sum((x - pt) ** 2),
            x0=np.zeros(2),
            jac=lambda x: 2 * (x - pt),
            constraints=[{"type": "ineq", "fun": lambda x, i=i: h[i] - G[i] @ x} for i in range(m)],
            method="SLSQP",
            options={"ftol": 1e-12, "maxiter": 200},
        )
        np.testing.assert_allclose(ours, res.x, atol=1e-6)
        assert np.sum((ours - pt) ** 2) <= np.sum((res.x - pt) ** 2) + 1e-9


# ---------------------------------------------------------------------------
# Device-common parsing errors (tests/simulator/test_devices.py:18-37)
# ---------------------------------------------------------------------------
def test_device_bad_bus_id():
    from gym_anm_tpu.errors import DeviceSpecError

    for b in [None, -1, 3, 4]:
        with pytest.raises(DeviceSpecError):
            parse_load([2, b, -1, 0.2, 0, -10] + [None] * 9, BUS_IDS, BASE)


def test_device_bad_type():
    from gym_anm_tpu.errors import DeviceSpecError

    for t in [None, -3, -2, 4, 5]:
        with pytest.raises(DeviceSpecError):
            parse_load([2, 1, t] + [None] * 12, BUS_IDS, BASE)


def test_load_wrong_type_rejected():
    """A slack row through the Load parser raises (test_devices.py:59-62)."""
    with pytest.raises(LoadSpecError):
        parse_load([2, 1, 0, 0.2, 0, -10] + [None] * 9, BUS_IDS, BASE)


# ---------------------------------------------------------------------------
# Default P/Q values (test_devices.py:165-191, 354-385)
# ---------------------------------------------------------------------------
def test_generator_default_p_values():
    g = parse_generator([2, 1, 1, None, None, 1, 10, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.p_max == np.inf
    g = parse_generator([2, 1, 1, None, 0, 0, 10, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.p_max == 0
    g = parse_generator([2, 1, 1, None, 10, None, 10, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.p_min == 0


def test_generator_default_q_values():
    g = parse_generator([2, 1, 1, None, 10, 1, None, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.q_max == np.inf
    g = parse_generator([2, 1, 1, None, 10, 1, 10, None] + [None] * 7, BUS_IDS, BASE)
    assert g.q_min == -np.inf


def test_generator_flex_defaults():
    """P+/Q+/Q- default to the box bounds; P- is ignored (test_devices.py:192-233)."""
    g = parse_generator([2, 1, 1, None, 10, 1, 10, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.p_plus == 10 / BASE
    for p_minus in [None, 0, -1, 1]:
        g = parse_generator([2, 1, 1, None, 10, 1, 10, 1, None, p_minus] + [None] * 5, BUS_IDS, BASE)
        assert g.p_minus is None
    g = parse_generator([2, 1, 1, None, 10, 1, 15, 1] + [None] * 7, BUS_IDS, BASE)
    assert g.q_plus == 15 / BASE and g.q_minus == 1 / BASE


def test_storage_default_pq_values():
    g = parse_storage([2, 1, 3, None, None, -12, 20, -30, None, -6, 10, -15, 100, 10, 0.9], BUS_IDS, BASE)
    assert g.p_max == np.inf
    g = parse_storage([2, 1, 3, None, 10, None, 20, -30, 5, -6, 10, -15, 100, 10, 0.9], BUS_IDS, BASE)
    assert g.p_min == -np.inf
    g = parse_storage([2, 1, 3, None, 10, -12, None, -30, 5, -6, None, -15, 100, 10, 0.9], BUS_IDS, BASE)
    assert g.q_max == np.inf
    g = parse_storage([2, 1, 3, None, 10, -12, 20, None, 5, -6, 10, None, 100, 10, 0.9], BUS_IDS, BASE)
    assert g.q_min == -np.inf
    g = parse_storage([2, 1, 3, None, 10, -12, 20, -30, None, -6, 10, -15, 100, 10, 0.9], BUS_IDS, BASE)
    assert g.p_plus == 10 / BASE


def test_storage_infeasible_pq_flex(row_base=None):
    for p_plus in [-15, 25]:
        with pytest.raises(StorageSpecError):
            parse_storage([2, 1, 3, None, 10, -12, 20, -30, p_plus, -6, 10, -15, 100, 10, 0.9], BUS_IDS, BASE)
    # q_minus > q_plus
    with pytest.raises(StorageSpecError):
        parse_storage([2, 1, 3, None, 10, -12, 20, -30, 5, -6, 1, 2, 100, 10, 0.9], BUS_IDS, BASE)


# ---------------------------------------------------------------------------
# map_pq / update_soc through the functional transition pipeline
# ---------------------------------------------------------------------------
def _storage_only_spec(des_row, delta_t=1.0):
    from gym_anm_tpu.core.grid import build_grid

    net = {
        "baseMVA": BASE,
        "bus": np.array([[0, 0, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [[0, 0, 0, None, 200, -200, 200, -200] + [None] * 7, des_row],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 100, 1, 0]]),
    }
    spec, _ = build_grid(net, delta_t, 10)
    return spec


def _map_storage(spec, soc, p_set, q_set):
    from gym_anm_tpu.core.transition import _map_set_points

    z = jnp.zeros(0, dtype=jnp.float64)
    dev_p, dev_q, new_soc, _ = _map_set_points(
        spec,
        jnp.asarray([soc], dtype=jnp.float64),
        z, z, z, z,
        jnp.asarray([p_set], dtype=jnp.float64),
        jnp.asarray([q_set], dtype=jnp.float64),
    )
    return float(dev_p[1]), float(dev_q[1]), float(new_soc[0])


def test_load_map_pq_pipeline():
    """Load.map_pq semantics (test_devices.py:74-106): clip + fixed Q/P."""
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.core.transition import _map_set_points

    net = {
        "baseMVA": BASE,
        "bus": np.array([[0, 0, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -10] + [None] * 9,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 100, 1, 0]]),
    }
    spec, _ = build_grid(net, 1.0, 10)
    z = jnp.zeros(0, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    for p in np.concatenate([rng.uniform(-10, 0, 10), rng.uniform(-50, -10, 5), rng.uniform(0.5, 50, 5)]) / BASE:
        dev_p, dev_q, _, _ = _map_set_points(
            spec, z, jnp.asarray([p], dtype=jnp.float64), z, z, z, z, z
        )
        expect_p = np.clip(p, -10 / BASE, 0.0)
        np.testing.assert_allclose(float(dev_p[1]), expect_p, atol=1e-12)
        np.testing.assert_allclose(float(dev_q[1]), expect_p * 0.2, atol=1e-12)


def test_gen_p_pot_clipped_pipeline():
    """Infeasible p_pot clipped into [p_min, p_max] (test_devices.py:240-247)."""
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.core.transition import _map_set_points

    net = {
        "baseMVA": BASE,
        "bus": np.array([[0, 0, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, 2, None, 10, 1, 2, -3] + [None] * 7,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 100, 1, 0]]),
    }
    spec, _ = build_grid(net, 1.0, 10)
    z = jnp.zeros(0, dtype=jnp.float64)
    rng = np.random.default_rng(8)
    for p_pot in rng.uniform(-10, 10, 20) / BASE:
        _, _, _, pp = _map_set_points(
            spec, z, z,
            jnp.asarray([p_pot], dtype=jnp.float64),
            jnp.asarray([20.0], dtype=jnp.float64),
            jnp.asarray([0.0], dtype=jnp.float64),
            z, z,
        )
        np.testing.assert_allclose(float(pp[0]), np.clip(p_pot, 1 / BASE, 10 / BASE), atol=1e-12)


def test_update_soc_simple_pipeline():
    """SoC recursion with efficiency asymmetry (test_devices.py:456-474)."""
    row = [1, 1, 3, None, 10, -12, 20, -30, 10, -12, 20, -30, 100, 10, 0.9]
    rng = np.random.default_rng(9)
    for delta_t in [1.0, 0.25]:
        spec = _storage_only_spec(row, delta_t)
        for p in rng.uniform(0, 10, 10) / BASE:  # discharge
            des_p, _, soc = _map_storage(spec, 50 / BASE, p, 0.0)
            np.testing.assert_allclose(des_p, p, atol=1e-10)
            np.testing.assert_allclose(soc, 50 / BASE - delta_t * p / 0.9, atol=1e-10)
        for p in rng.uniform(-10, 0, 10) / BASE:  # charge
            des_p, _, soc = _map_storage(spec, 50 / BASE, p, 0.0)
            np.testing.assert_allclose(des_p, p, atol=1e-10)
            np.testing.assert_allclose(soc, 50 / BASE - delta_t * p * 0.9, atol=1e-10)


def test_update_soc_clipping_pipeline():
    """SoC stays inside [soc_min, soc_max] (test_devices.py:476-492).

    The reference clips after an unconstrained update; the pipeline first
    caps the (dis)charge rate so the post-update SoC lands exactly on the
    bound -- same end state (simulator.py:503-523 composes them equally).
    """
    row = [1, 1, 3, None, 10, -12, 20, -30, 10, -12, 20, -30, 10, 0, 1.0]
    spec = _storage_only_spec(row, 1.0)
    rng = np.random.default_rng(10)
    for p in rng.uniform(-12, -1, 10) / BASE:  # charge near-full -> clip at soc_max
        _, _, soc = _map_storage(spec, 9 / BASE, p, 0.0)
        np.testing.assert_allclose(soc, 10 / BASE, atol=1e-10)
    for p in rng.uniform(1, 10, 10) / BASE:  # discharge near-empty -> clip at soc_min
        _, _, soc = _map_storage(spec, 1 / BASE, p, 0.0)
        np.testing.assert_allclose(soc, 0.0, atol=1e-10)
