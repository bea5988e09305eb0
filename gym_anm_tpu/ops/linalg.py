"""Small-matrix batched linear algebra.

``jnp.linalg.solve`` lowers to an LU library call whose dynamic control flow
defeats fusion for the tiny systems we solve.  The Newton-Raphson Jacobians here are [2(n_bus-1)]^2 --
10x10 for the 6-bus grid -- so a statically-unrolled Gaussian elimination
with partial pivoting, vectorized over the environment batch, is both
portable and faster: n pivot steps of fully-vectorized [B, n, n+1]
elementwise work, no data-dependent control flow anywhere.
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_ge(A, b):
    """Solve ``A x = b`` by Gaussian elimination with partial pivoting.

    A: [..., n, n]; b: [..., n].  The elimination loop is unrolled at trace
    time (n is static and small).  Singular systems produce inf/NaN rather
    than raising -- callers detect divergence from NaNs, mirroring the
    reference's handling of singular NR Jacobians (anm_env.py:280-281).
    """
    n = A.shape[-1]
    Ab = jnp.concatenate([A, b[..., :, None]], axis=-1)  # [..., n, n+1]
    rows = jnp.arange(n)

    for k in range(n):
        # Partial pivot: largest |A[:, k]| among rows >= k.
        col = jnp.abs(Ab[..., :, k])
        col = jnp.where(rows >= k, col, -jnp.inf)
        piv = jnp.argmax(col, axis=-1)  # [...]
        # Swap rows k <-> piv via a per-lane permutation gather.
        pivb = piv[..., None]
        perm = jnp.where(rows == k, pivb, jnp.where(rows == pivb, k, rows))
        Ab = jnp.take_along_axis(Ab, perm[..., :, None], axis=-2)
        # Eliminate below the pivot.
        pivot = Ab[..., k : k + 1, k : k + 1]  # [..., 1, 1]
        factor = Ab[..., :, k : k + 1] / pivot  # [..., n, 1]
        mask = (rows > k)[..., :, None]
        Ab = Ab - jnp.where(mask, factor * Ab[..., k : k + 1, :], 0.0)

    # Back substitution (unrolled).
    x = jnp.zeros_like(b)
    for k in range(n - 1, -1, -1):
        acc = jnp.einsum("...j,...j->...", Ab[..., k, k + 1 : n], x[..., k + 1 : n]) if k + 1 < n else 0.0
        x = x.at[..., k].set((Ab[..., k, n] - acc) / Ab[..., k, k])
    return x
