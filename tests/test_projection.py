"""The lane-major exact set-point projection (ops/projection.py) on the
ANM6 device polytopes, many lanes at once."""

import numpy as np
import jax.numpy as jnp

from gym_anm_tpu.core.grid import build_grid
from gym_anm_tpu.envs.anm6.network import network
from gym_anm_tpu.ops.projection import project_polytope_lanes


def _projection_case(B=1024, seed=7):
    spec, _ = build_grid(network, 0.25, 100, dtype=np.float64)
    G = np.concatenate([np.asarray(spec.gen_G), np.asarray(spec.des_G)], axis=0)
    C, m, _ = G.shape
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1.5, 1.5, (C, B))
    py = rng.uniform(-1.5, 1.5, (C, B))
    h0 = np.concatenate([np.asarray(spec.gen_h0), np.asarray(spec.des_h0)], 0)
    h = np.broadcast_to(h0[:, :, None], (C, m, B)).copy()
    # Dynamic offsets only on structurally present rows, as transition builds h.
    for r, hi in ((2, 0.6), (9, 0.5)):
        rows = np.abs(G[:, r]).sum(-1) > 0
        h[rows, r, :] = rng.uniform(0.0, hi, (int(rows.sum()), B))
    return px, py, G, h


def _feasible(x, y, G, h, tol=1e-9):
    gx = G[:, :, 0, None] * x[:, None, :] + G[:, :, 1, None] * y[:, None, :]  # [C, m, B]
    active = np.isfinite(h) & np.all(np.isfinite(G), axis=-1)[:, :, None]
    return np.all(np.where(active, gx <= h + tol * (1 + np.abs(np.where(np.isfinite(h), h, 0))), True), axis=1)


def test_projection_lanes_fixes_feasible_points():
    """A feasible set-point maps to itself exactly, lane by lane."""
    px, py, G, h = _projection_case(seed=11)
    x, y = (np.asarray(a) for a in project_polytope_lanes(jnp.asarray(px), jnp.asarray(py), G, jnp.asarray(h)))
    inside = _feasible(px, py, G, h, tol=0.0)
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(x[inside], px[inside])
    np.testing.assert_array_equal(y[inside], py[inside])


def test_projection_lanes_is_nearest_feasible_point():
    """Every output is feasible, and no feasible point of a dense sample of
    each lane's region lies closer to the request."""
    px, py, G, h = _projection_case(B=64, seed=13)
    x, y = (np.asarray(a) for a in project_polytope_lanes(jnp.asarray(px), jnp.asarray(py), G, jnp.asarray(h)))
    assert _feasible(x, y, G, h, tol=1e-7).all()
    d_ours = (x - px) ** 2 + (y - py) ** 2
    grid = np.linspace(-1.6, 1.6, 161)
    gx, gy = np.meshgrid(grid, grid)
    gx, gy = gx.ravel(), gy.ravel()
    C, _, B = h.shape
    for c in range(C):
        for b in range(B):
            sx = np.broadcast_to(gx[None, :], (C, gx.size))
            sy = np.broadcast_to(gy[None, :], (C, gy.size))
            hb = np.broadcast_to(h[:, :, b : b + 1], (C, h.shape[1], gx.size))
            ok = _feasible(sx, sy, G, hb, tol=0.0)[c]
            if ok.any():
                d_grid = ((gx[ok] - px[c, b]) ** 2 + (gy[ok] - py[c, b]) ** 2).min()
                assert d_ours[c, b] <= d_grid + 1e-12
