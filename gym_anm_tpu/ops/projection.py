"""Exact Euclidean projection onto 2-D halfspace-intersection polytopes.

The reference maps each requested generator/storage set-point onto its
feasible capability region by solving a CVXPY QP **per device per step**
(``devices.py:280-304`` and ``devices.py:472-522``) -- by far its dominant
per-step cost.  Here we exploit that the feasible region is a 2-D convex
polytope with at most ~10 facets: the Euclidean projection of a point onto
such a set is either

* the point itself (if feasible),
* the foot of the perpendicular onto one facet's supporting line, or
* a vertex (intersection of two supporting lines),

so an exhaustive, fixed-shape candidate enumeration computes the projection
**exactly** (to machine precision -- tighter than the reference's ~1e-8 ECOS
tolerance), with no iteration.

:func:`project_polytope_lanes`: G is a *static* numpy tensor (device
capability normals are fixed at build time), candidates are evaluated one at
a time with a running minimum over ``[C, B]`` lane-major arrays (environment
batch innermost), and candidates whose rows are statically absent (zero
normal / infinite static offset on every device) are pruned at trace time.
No large intermediate tensors; the whole enumeration fuses into elementwise
work.  On an H100 it measured 28-43% faster end to end than a
candidate-tensor form that materialised every candidate at once (PERF.md).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def project_polytope_lanes(px, py, G, h, eps=None):
    """Exact projection, lane-major hot path.

    Parameters
    ----------
    px, py : [C, B]
        Requested (p, q) set-points, batch innermost.
    G : numpy [C, m, 2] (STATIC)
        Halfspace normals per device; zero rows mark structurally absent
        constraints.
    h : [C, m, B]
        Offsets (dynamic rows vary per environment; +inf = inactive).

    Returns ``(x [C, B], y [C, B])``.
    """
    G = np.asarray(G)
    C, m, _ = G.shape
    dtype = jnp.result_type(px)
    if eps is None:
        eps = 1e-9 if dtype == jnp.float64 else 1e-5

    g_finite = np.all(np.isfinite(G), axis=-1)  # [C, m] static
    g_nonzero = (np.abs(G).sum(axis=-1) > 0) & g_finite
    gx_c = [G[:, r, 0][:, None] for r in range(m)]  # [C, 1] constants
    gy_c = [G[:, r, 1][:, None] for r in range(m)]

    h_fin = [jnp.isfinite(h[:, r]) for r in range(m)]
    tol = [eps * (1.0 + jnp.where(h_fin[r], jnp.abs(h[:, r]), 0.0)) for r in range(m)]

    def feasible(x, y):
        ok = jnp.full(x.shape, True)
        for r in range(m):
            if not g_finite[:, r].any():
                continue
            gx = gx_c[r] * x + gy_c[r] * y
            row_ok = gx <= h[:, r] + tol[r]
            # Rows inactive for a device (zero/non-finite normal) or lane
            # (infinite offset) are trivially satisfied.
            mask = jnp.asarray(g_finite[:, r][:, None]) & h_fin[r]
            ok = ok & jnp.where(mask, row_ok, True)
        return ok

    # Running minimum over candidates.
    best_x, best_y = px, py
    best_d = jnp.where(feasible(px, py), jnp.zeros_like(px), jnp.inf)

    def consider(x, y, valid):
        nonlocal best_x, best_y, best_d
        d = (x - px) ** 2 + (y - py) ** 2
        ok = valid & jnp.isfinite(x) & jnp.isfinite(y) & feasible(x, y) & (d < best_d)
        best_x = jnp.where(ok, x, best_x)
        best_y = jnp.where(ok, y, best_y)
        best_d = jnp.where(ok, d, best_d)

    # Feet of perpendiculars.
    for r in range(m):
        if not g_nonzero[:, r].any():
            continue  # statically absent on every device
        gg = (G[:, r, 0] ** 2 + G[:, r, 1] ** 2)[:, None]  # [C, 1] static
        gg_safe = np.where(gg > 0, gg, 1.0)
        coef = (gx_c[r] * px + gy_c[r] * py - h[:, r]) / gg_safe
        fx = px - coef * gx_c[r]
        fy = py - coef * gy_c[r]
        valid = jnp.asarray(g_nonzero[:, r][:, None]) & h_fin[r]
        consider(fx, fy, valid)

    # Vertices (pairwise intersections).
    for r in range(m):
        for s2 in range(r + 1, m):
            det = G[:, r, 0] * G[:, s2, 1] - G[:, r, 1] * G[:, s2, 0]  # [C] static
            nrm = np.sqrt(
                np.maximum((G[:, r] ** 2).sum(-1) * (G[:, s2] ** 2).sum(-1), 0.0)
            )
            det_ok = np.isfinite(det) & (np.abs(det) > eps * np.maximum(1.0, nrm))
            if not det_ok.any():
                continue  # statically parallel/absent on every device
            safe_det = np.where(det_ok, det, 1.0)[:, None]
            hr, hs = h[:, r], h[:, s2]
            vx = (hr * G[:, s2, 1][:, None] - hs * G[:, r, 1][:, None]) / safe_det
            vy = (G[:, r, 0][:, None] * hs - G[:, s2, 0][:, None] * hr) / safe_det
            valid = jnp.asarray(det_ok[:, None]) & h_fin[r] & h_fin[s2]
            consider(vx, vy, valid)

    return best_x, best_y
