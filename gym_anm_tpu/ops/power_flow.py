"""Batched Newton-Raphson AC power-flow solve, all-real arithmetic.

JAX reimplementation of the reference solver
(``gym_anm/simulator/solve_load_flow.py:7-226``): the same mismatch
``f(x) = (V (Y V)^*)[1:] - s`` (solve_load_flow.py:116), the same polar
Jacobian blocks dS/d(theta) and dS/d|V| (solve_load_flow.py:123-164), the
same flat start (theta=0, |V|=1; solve_load_flow.py:42), the same stopping
rule (inf-norm of mismatch <= x_tol, or the iteration cap, NaN => diverged;
solve_load_flow.py:176-226).

Design decisions (vs. a translation):

* **All complex arithmetic is expanded to real (re, im) pairs**, which
  maps the Y*V products onto plain real matmuls.
* **The environment batch is the innermost (lane) axis.**  Internally every
  tensor is laid out batch-last -- voltages [n, B], Jacobians [2m, 2m, B] --
  so elementwise work vectorizes across environments and ``Y @ V`` becomes
  an [n, n] x [n, B] matmul, instead of a vmapped batch-first layout over
  tiny per-network dimensions.
* **Fixed-iteration ``lax.scan`` with per-lane convergence masking** is the
  default loop: converged/diverged lanes freeze (their updates are masked
  out), so a batch is one straight-line XLA program with no data-dependent
  control flow.  ``method="while"`` gives the classic early-exit
  ``lax.while_loop`` variant; both produce identical results.
* The scipy sparse LU becomes a batch-last Gaussian elimination with
  partial pivoting whose pivot selection uses one-hot contractions instead
  of gathers; the elimination loop is statically unrolled (dense is optimal
  at distribution-network sizes).

The slack bus must be index 0 with voltage pinned at 1+0j
(solve_load_flow.py:167-173; the reference pins 1+0j regardless of
``v_slack``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST

#: Matmul precision of the chord iteration's constant-Jacobian product
#: ``dx = J0inv @ F``.  The chord method is a self-correcting fixed-point
#: iteration (the mismatch F is always evaluated at HIGHEST precision), so
#: the update product tolerates rounded inputs -- ``lax.Precision.DEFAULT``
#: trades update accuracy for a faster [2m, 2m] x [2m, B] product (see
#: scripts/chord_proto.py).
CHORD_PRECISION = _HI


def cmul(ar, ai, br, bi):
    """(ar + j ai) * (br + j bi) -> (re, im)."""
    return ar * br - ai * bi, ar * bi + ai * br


def solve_ge_lanes(A, b):
    """Solve ``A x = b`` batch-last: A [n, n, B], b [n, B] -> x [n, B].

    Gaussian elimination with partial pivoting; the elimination loop is
    unrolled at trace time and pivot row selection/swap uses one-hot masks
    (no gathers), so every op is a [n, n+1, B] elementwise op with the
    batch riding the 128-wide lane axis.  Singular lanes yield inf/NaN
    (detected downstream as divergence), mirroring the reference's singular-
    Jacobian handling (anm_env.py:280-281).
    """
    n = A.shape[0]
    Ab = jnp.concatenate([A, b[:, None, :]], axis=1)  # [n, n+1, B]
    rows = jnp.arange(n)

    for k in range(n):
        # Partial pivot among rows >= k (per lane).
        col = jnp.abs(Ab[:, k, :])  # [n, B]
        col = jnp.where((rows >= k)[:, None], col, -jnp.inf)
        piv = jnp.argmax(col, axis=0)  # [B]
        onehot = (rows[:, None] == piv[None, :]).astype(Ab.dtype)  # [n, B]
        # row_piv[c, B] = sum_r onehot[r] * Ab[r, c]
        row_piv = jnp.einsum("rB,rcB->cB", onehot, Ab, precision=_HI)
        row_k = Ab[k]  # [n+1, B]
        # Swap: row piv := row k, then row k := row piv.
        Ab = jnp.where(onehot[:, None, :] > 0, row_k[None, :, :], Ab)
        Ab = Ab.at[k].set(row_piv)
        # Eliminate below the pivot.
        pivot = Ab[k, k, :]  # [B]
        factor = Ab[:, k, :] / pivot[None, :]  # [n, B]
        mask = (rows > k)[:, None, None]
        Ab = Ab - jnp.where(mask, factor[:, None, :] * Ab[k][None, :, :], 0.0)

    # Back substitution (unrolled).
    x = jnp.zeros_like(b)
    for k in range(n - 1, -1, -1):
        acc = jnp.einsum("jB,jB->B", Ab[k, k + 1 : n, :], x[k + 1 : n, :], precision=_HI) if k + 1 < n else 0.0
        x = x.at[k].set((Ab[k, n, :] - acc) / Ab[k, k, :])
    return x


def _solve_linear_lanes(A, b):
    """Solve ``A x = b`` batch-last: A [n, n, B], b [n, B] -> x [n, B].

    Dispatches on system size at trace time: the statically-unrolled
    lane-major Gaussian elimination (``solve_ge_lanes``) is the fast path
    for the small systems the batched envs solve (n <= ~128), but its 2n
    unrolled trace steps make compile time quadratic-ish in n.  For large
    systems (e.g. 560x560 Jacobians of the 141-bus network)
    ``jnp.linalg.solve`` (LAPACK / cuSOLVER) is both instant to compile and
    faster to run.  Singular lanes yield inf/NaN in either path (the batched
    solve propagates NaNs rather than raising under jit), which callers
    detect as divergence.
    """
    n = A.shape[0]
    if n >= 128:
        X = jnp.linalg.solve(jnp.moveaxis(A, -1, 0), jnp.moveaxis(b, -1, 0)[..., None])
        return jnp.moveaxis(X[..., 0], 0, -1)
    return solve_ge_lanes(A, b)


def _construct_v(theta, vm):
    """V = [1+0j, vm exp(j theta)] as (re, im), shapes [m, B] -> [n, B]."""
    one = jnp.ones((1,) + theta.shape[1:], dtype=vm.dtype)
    zero = jnp.zeros_like(one)
    return jnp.concatenate([one, vm * jnp.cos(theta)]), jnp.concatenate([zero, vm * jnp.sin(theta)])


def _yv(Y_re, Y_im, v_re, v_im):
    """I = Y V: [n, n] x [n, B] real matmuls."""
    i_re = jnp.dot(Y_re, v_re, precision=_HI) - jnp.dot(Y_im, v_im, precision=_HI)
    i_im = jnp.dot(Y_re, v_im, precision=_HI) + jnp.dot(Y_im, v_re, precision=_HI)
    return i_re, i_im


def _mismatch(v_re, v_im, i_re, i_im, p, q):
    """F = concat(Re, Im) of (V conj(I))[1:] - (p + jq) with I = YV; all [*, B]."""
    s_re = v_re * i_re + v_im * i_im
    s_im = v_im * i_re - v_re * i_im
    return jnp.concatenate([s_re[1:] - p, s_im[1:] - q])


def _jacobian(v_re, v_im, i_re, i_im, Y_re, Y_im):
    """J [2m, 2m, B] from the polar blocks (solve_load_flow.py:123-164).

    dS_dVa[i,k] = 1j * v_i * conj(delta_ik (Yv)_i - Y_ik v_k)
    dS_dVm[i,k] = delta_ik (v/|v|)_i conj((Yv)_i) + v_i conj(Y_ik (v/|v|)_k)
    """
    n = v_re.shape[0]
    vmag = jnp.sqrt(v_re * v_re + v_im * v_im)
    vn_re, vn_im = v_re / vmag, v_im / vmag
    eye = jnp.eye(n, dtype=v_re.dtype)[:, :, None]  # [n, n, 1]

    Yre = Y_re[:, :, None]
    Yim = Y_im[:, :, None]
    # w = diag(Yv) - Y * v[None, :]
    yv_re, yv_im = cmul(Yre, Yim, v_re[None, :, :], v_im[None, :, :])  # [n, n, B]
    w_re = eye * i_re[:, None, :] - yv_re
    w_im = eye * i_im[:, None, :] - yv_im
    # 1j * v * conj(w): (a+jb)(c-jd) * 1j = (ad - bc) + j(ac + bd).
    a, b = v_re[:, None, :], v_im[:, None, :]
    dSa_re = a * w_im - b * w_re
    dSa_im = a * w_re + b * w_im

    # term1 (diagonal): vn * conj(I); term2: v_i * conj(Y_ik vn_k).
    t1_re = vn_re * i_re + vn_im * i_im
    t1_im = vn_im * i_re - vn_re * i_im
    u_re, u_im = cmul(Yre, Yim, vn_re[None, :, :], vn_im[None, :, :])
    dSm_re = eye * t1_re[:, None, :] + (a * u_re + b * u_im)
    dSm_im = eye * t1_im[:, None, :] + (b * u_re - a * u_im)

    top = jnp.concatenate([dSa_re[1:, 1:], dSm_re[1:, 1:]], axis=1)
    bot = jnp.concatenate([dSa_im[1:, 1:], dSm_im[1:, 1:]], axis=1)
    return jnp.concatenate([top, bot], axis=0)  # [2m, 2m, B]


def flat_start_jacobian_inv_np(Y_re, Y_im, dtype=None):
    """Trace-time (NumPy) version of :func:`flat_start_jacobian_inv`.

    The flat-start Jacobian depends only on the admittance matrix, which is
    a static ``GridSpec`` leaf (NumPy), so callers outside the solver's jit
    boundary can compute the inverse on the host and let it fold into the
    compiled program as a constant.  Computing it *inside* the jitted
    solvers instead materializes an LU custom-call + several fusions in the
    compiled step -- inside a ``lax.scan`` body that work re-runs every
    step.  Computed in float64, cast to ``dtype`` (default: Y's dtype).
    """
    Y = np.asarray(Y_re, np.float64) + 1j * np.asarray(Y_im, np.float64)
    n = Y.shape[0]
    v = np.ones(n, dtype=complex)  # flat start: theta=0, |V|=1
    i0 = Y @ v
    w = np.diag(i0) - Y * v[None, :]  # delta_ik (Yv)_i - Y_ik v_k
    dSa = 1j * v[:, None] * np.conj(w)
    vn = v / np.abs(v)
    u = Y * vn[None, :]
    dSm = np.diag(vn * np.conj(i0)) + v[:, None] * np.conj(u)
    J0 = np.block(
        [
            [dSa[1:, 1:].real, dSm[1:, 1:].real],
            [dSa[1:, 1:].imag, dSm[1:, 1:].imag],
        ]
    )
    out_dt = dtype if dtype is not None else np.asarray(Y_re).dtype
    return np.linalg.inv(J0).astype(out_dt)


def flat_start_jacobian_inv(Y_re, Y_im):
    """Inverse of the flat-start NR Jacobian, which depends only on Y.

    At the flat start (theta=0, |V|=1 everywhere) the polar Jacobian is a
    fixed function of the admittance matrix, so its inverse can be folded
    into the compiled program as a constant and used as the iteration matrix
    of the chord (constant-Jacobian) method: one [2m, 2m] x [2m, B] matmul
    per iteration instead of a per-lane factorization.
    """
    n = Y_re.shape[0]
    m = n - 1
    dt = Y_re.dtype
    vr0, vi0 = _construct_v(jnp.zeros((m, 1), dt), jnp.ones((m, 1), dt))
    ir0, ii0 = _yv(Y_re, Y_im, vr0, vi0)
    J0 = _jacobian(vr0, vi0, ir0, ii0, Y_re, Y_im)[:, :, 0]  # [2m, 2m]
    return jnp.linalg.inv(J0)


def nr_flops_per_lane(n: int, max_iter: int, chord_iters: int = 0) -> int:
    """Analytic executed-FLOP count of :func:`solve_pfe` per environment lane.

    XLA's cost analysis counts a loop body once, not once per trip, so
    bench.py counts the NR/chord loop work statically.  Everything here has
    static shapes and fixed iteration budgets, so the count is exact up to
    the conventions below:

    * masked/converged lanes still execute every op (lockstep SIMD), and
      are counted -- this is the work the hardware performs;
    * transcendentals (cos/sin/sqrt) and divides count as 1 flop;
    * compares/selects (pivot masks, convergence masks) count as 0.

    Per-lane breakdown (m = n-1 non-slack buses, nn = 2m system size):

    * ``yv`` (I = YV): 8 n^2
    * ``jacobian``: yvr/yvi 8 n^2 + w 4 n^2 + dSa 6 n^2 + u 8 n^2
      + dSm 8 n^2  ~= 34 n^2
    * ``solve`` (masked full-matrix GE, no shrinking active window):
      per pivot k: one-hot row extract 2 nn (nn+1) + elimination update
      2 nn (nn+1); over nn pivots ~= 4 nn^2 (nn+1); back-substitution nn^2
    * chord iteration: J0inv @ F 2 nn^2 + yv 8 n^2
    * construct_v / mismatch / masked carries: O(n) terms folded into the
      30 n / 20 n fudge constants.
    """
    m = n - 1
    nn = 2 * m
    ge = 4 * nn * nn * (nn + 1)
    nr_iter = 42 * n * n + ge + nn * nn + 30 * n
    chord_iter = 2 * nn * nn + 8 * n * n + 20 * n
    setup = 8 * n * n + 10 * n
    return setup + chord_iters * chord_iter + max_iter * nr_iter


def warm_init_theta_vm(v_re, v_im, m, dt):
    """Per-lane (theta, vm, valid) from previous-step bus voltages.

    ``v_re/v_im [..., n]`` (batch-first, the layout solvers return and
    ``SimState`` stores).  Returns batch-LAST ``theta/vm [m, B]`` plus a
    per-lane ``valid [B]`` mask: a lane is a usable warm start only when
    every bus voltage is finite and its magnitude is within a wide
    physical window (0.25..4 p.u.) -- absorbing zero states (terminated
    lanes), uninitialized lanes, and diverged solutions all fail the
    window and fall back to the flat start.  The *convergence* decision is
    never affected: it stays on the true mismatch at ``x_tol``
    (solve_load_flow.py:176-226), identical to a flat-start solve.
    """
    vr = jnp.moveaxis(jnp.asarray(v_re, dt), -1, 0)[1:]  # [m, B]
    vi = jnp.moveaxis(jnp.asarray(v_im, dt), -1, 0)[1:]
    vm = jnp.sqrt(vr * vr + vi * vi)
    theta = jnp.arctan2(vi, vr)
    finite = jnp.all(jnp.isfinite(vr) & jnp.isfinite(vi), axis=0)
    window = jnp.all((vm > 0.25) & (vm < 4.0), axis=0)
    valid = finite & window
    theta = jnp.where(valid[None, :], theta, 0.0)
    vm = jnp.where(valid[None, :], vm, 1.0)
    return theta, vm, valid


@partial(jax.jit, static_argnames=("max_iter", "method", "chord_iters", "chord_precision"))
def solve_pfe(
    Y_re,
    Y_im,
    p,
    q,
    x_tol=1e-5,
    max_iter=100,
    method="scan",
    chord_iters=16,
    J0inv=None,
    chord_precision=None,
    init=None,
):
    """Newton-Raphson solve of the AC power-flow equations.

    Parameters
    ----------
    Y_re, Y_im : [n, n]
        Real/imaginary parts of the nodal admittance matrix (slack at 0).
    p, q : [m] or [B, m] with m = n-1
        Net injections at the non-slack buses (p.u.); a leading batch axis
        runs B environments in lockstep with the batch as the innermost
        compute axis.
    x_tol : float
        Convergence tolerance on the inf-norm of the mismatch.
    max_iter : int
        Iteration cap (reference ``lim_iter=100``).  For ``method="hybrid"``
        this is the budget of the *true-NR tail* only.
    method : {"scan", "while", "hybrid"}
        "scan" is the straight-line masked fixed-iteration loop, "while"
        early-exits once every lane has converged or diverged; both
        produce identical results.  "hybrid"
        prepends ``chord_iters`` chord iterations -- x <- x - J0^{-1} F(x)
        with the constant flat-start Jacobian -- which are pure matmuls
        (no per-lane Jacobian build or elimination), then finishes the
        unconverged lanes with true NR; lanes the chord phase made worse
        (or NaN) are reset to the flat start first, so every lane the pure
        NR method can solve within ``chord_iters + max_iter`` iterations
        still converges to the same tolerance.
    chord_iters : int
        Number of chord iterations for ``method="hybrid"``.
    chord_precision : {None, "highest", "default"} or jax.lax.Precision
        Matmul precision of the chord update ``J0inv @ F`` (None uses the
        module default :data:`CHORD_PRECISION`).  The chord phase is a
        self-correcting fixed-point iteration whose mismatch is always
        evaluated at HIGHEST precision, so "default" (rounded-input
        products, TF32 on GPU tensor cores) converges to the same fixed
        point.

    init : None or (v_re, v_im) with the batch layout of the returned
        voltages ([B, n] / [n])
        Optional warm start, e.g. the previous step's solved bus voltages
        (``SimState.bus_v_re/im``).  Each lane starts from whichever of
        {warm point, flat start} has the smaller true mismatch (so a
        warm-started solve never starts worse than flat), lanes with
        non-finite/out-of-window voltages (absorbing zero states, reborn
        lanes) flat-start, and the convergence decision is unchanged: the
        true mismatch at ``x_tol``.  The reference flat-starts every solve
        (solve_load_flow.py:42) -- a per-step choice, not a semantic
        requirement, since the fixed point is the same; semantics drift is
        quantified by ``bench.py --check`` (docs/quirks.md).

    Returns ``(v_re, v_im, diff, n_iter, converged)`` with the same batch
    layout as the inputs ([B, n] / [B] when batched).
    """
    single = p.ndim == 1
    if single:
        p, q = p[None, :], q[None, :]

    n = Y_re.shape[0]
    m = n - 1
    dt = p.dtype
    pT, qT = p.T, q.T  # [m, B]
    B = pT.shape[1]

    theta_f = jnp.zeros((m, B), dtype=dt)
    vm_f = jnp.ones((m, B), dtype=dt)
    vr_f, vi_f = _construct_v(theta_f, vm_f)
    ivr_f, ivi_f = _yv(Y_re, Y_im, vr_f, vi_f)
    F_f = _mismatch(vr_f, vi_f, ivr_f, ivi_f, pT, qT)
    diff_f = jnp.max(jnp.abs(F_f), axis=0)  # [B]

    if init is not None:
        v0r, v0i = init
        if single:
            v0r, v0i = v0r[None, :], v0i[None, :]
        theta_w, vm_w, _ = warm_init_theta_vm(v0r, v0i, m, dt)
        vr_w, vi_w = _construct_v(theta_w, vm_w)
        ivr_w, ivi_w = _yv(Y_re, Y_im, vr_w, vi_w)
        F_w = _mismatch(vr_w, vi_w, ivr_w, ivi_w, pT, qT)
        diff_w = jnp.max(jnp.abs(F_w), axis=0)
        use_w = jnp.isfinite(diff_w) & (diff_w < diff_f)
        wm = use_w[None, :]
        theta0 = jnp.where(wm, theta_w, theta_f)
        vm0 = jnp.where(wm, vm_w, vm_f)
        F0 = jnp.where(wm, F_w, F_f)
        diff0 = jnp.where(use_w, diff_w, diff_f)
        ivr0 = jnp.where(wm, ivr_w, ivr_f)
        ivi0 = jnp.where(wm, ivi_w, ivi_f)
        vr0 = jnp.where(wm, vr_w, vr_f)
        vi0 = jnp.where(wm, vi_w, vi_f)
    else:
        theta0, vm0, F0, diff0 = theta_f, vm_f, F_f, diff_f
        vr0, vi0, ivr0, ivi0 = vr_f, vi_f, ivr_f, ivi_f

    if chord_precision is None:
        chord_precision = CHORD_PRECISION
    elif isinstance(chord_precision, str):
        chord_precision = {
            "highest": lax.Precision.HIGHEST,
            "default": lax.Precision.DEFAULT,
        }[chord_precision]

    n_chord = jnp.zeros((B,), dtype=jnp.int32)
    if method == "hybrid" and chord_iters > 0:
        if J0inv is None:
            J0inv = flat_start_jacobian_inv(Y_re.astype(dt), Y_im.astype(dt))
        J0inv = jnp.asarray(J0inv, dtype=dt)

        def chord_body(c, _):
            theta, vm, F, diff, it = c
            active = diff > x_tol  # NaN freezes the lane
            dx = jnp.dot(J0inv, F, precision=chord_precision)  # [2m, B]
            theta_n = theta - dx[:m]
            vm_n = vm - dx[m:]
            vr, vi = _construct_v(theta_n, vm_n)
            ir, ii = _yv(Y_re, Y_im, vr, vi)
            F_n = _mismatch(vr, vi, ir, ii, pT, qT)
            d_n = jnp.max(jnp.abs(F_n), axis=0)
            am = active[None, :]
            theta = jnp.where(am, theta_n, theta)
            vm = jnp.where(am, vm_n, vm)
            F = jnp.where(am, F_n, F)
            diff = jnp.where(active, d_n, diff)
            return (theta, vm, F, diff, it + active.astype(jnp.int32)), None

        (theta_c, vm_c, F_c, diff_c, n_chord), _ = lax.scan(
            chord_body, (theta0, vm0, F0, diff0, n_chord), None, length=chord_iters
        )
        # Lanes the chord phase failed to improve restart NR from the FLAT
        # start (not the possibly-warm phase start -- if a warm point misled
        # the chord, flat is the reference-faithful fallback);
        # improved-but-unconverged lanes hand their iterate to NR.
        bad = ~jnp.isfinite(diff_c) | (diff_c > diff0)
        bm = bad[None, :]
        theta0 = jnp.where(bm, theta_f, theta_c)
        vm0 = jnp.where(bm, vm_f, vm_c)
        F0 = jnp.where(bm, F_f, F_c)
        diff0 = jnp.where(bad, diff_f, diff_c)
        vr0, vi0 = _construct_v(theta0, vm0)
        ivr0, ivi0 = _yv(Y_re, Y_im, vr0, vi0)

    # The current I = YV is carried between iterations: the Jacobian of
    # iteration k and the mismatch of iteration k-1 share it, halving the
    # per-iteration matmul count.
    def nr_update(theta, vm, F, ivr, ivi):
        vr, vi = _construct_v(theta, vm)
        J = _jacobian(vr, vi, ivr, ivi, Y_re, Y_im)
        dx = _solve_linear_lanes(J, F)
        theta_n = theta - dx[:m]
        vm_n = vm - dx[m:]
        vr, vi = _construct_v(theta_n, vm_n)
        ivr_n, ivi_n = _yv(Y_re, Y_im, vr, vi)
        F_n = _mismatch(vr, vi, ivr_n, ivi_n, pT, qT)
        return theta_n, vm_n, F_n, jnp.max(jnp.abs(F_n), axis=0), ivr_n, ivi_n

    if max_iter == 0:
        # Chord-only configuration (method="hybrid", max_iter=0): skip the
        # NR phase entirely -- important at large n, where even *tracing*
        # nr_update's per-lane Jacobian build ([2m, 2m, B] exceeds HBM at
        # production batch sizes) and unrolled elimination must be avoided.
        # Lanes the chord phase could not converge keep diff > x_tol and
        # are flagged unconverged below, like NR-budget exhaustion.
        theta, vm, diff, n_iter = theta0, vm0, diff0, jnp.zeros((B,), dtype=jnp.int32)
    elif method == "while":
        # Early-exit loop; exits when every lane has converged/diverged.
        def cond(c):
            _, _, _, diff, it, _, _ = c
            return jnp.any((diff > x_tol) & (it < max_iter))

        def body(c):
            theta, vm, F, diff, it, ivr, ivi = c
            active = (diff > x_tol) & (it < max_iter)
            t_n, v_n, F_n, d_n, ivr_n, ivi_n = nr_update(theta, vm, F, ivr, ivi)
            theta = jnp.where(active[None, :], t_n, theta)
            vm = jnp.where(active[None, :], v_n, vm)
            F = jnp.where(active[None, :], F_n, F)
            diff = jnp.where(active, d_n, diff)
            ivr = jnp.where(active[None, :], ivr_n, ivr)
            ivi = jnp.where(active[None, :], ivi_n, ivi)
            return theta, vm, F, diff, it + active.astype(jnp.int32), ivr, ivi

        it0 = jnp.zeros((B,), dtype=jnp.int32)
        theta, vm, _, diff, n_iter, _, _ = lax.while_loop(
            cond, body, (theta0, vm0, F0, diff0, it0, ivr0, ivi0)
        )
    else:

        def body(c, _):
            theta, vm, F, diff, it, ivr, ivi = c
            active = diff > x_tol  # NaN freezes the lane, like the while-cond
            t_n, v_n, F_n, d_n, ivr_n, ivi_n = nr_update(theta, vm, F, ivr, ivi)
            theta = jnp.where(active[None, :], t_n, theta)
            vm = jnp.where(active[None, :], v_n, vm)
            F = jnp.where(active[None, :], F_n, F)
            diff = jnp.where(active, d_n, diff)
            ivr = jnp.where(active[None, :], ivr_n, ivr)
            ivi = jnp.where(active[None, :], ivi_n, ivi)
            return (theta, vm, F, diff, it + active.astype(jnp.int32), ivr, ivi), None

        it0 = jnp.zeros((B,), dtype=jnp.int32)
        (theta, vm, _, diff, n_iter, _, _), _ = lax.scan(
            body, (theta0, vm0, F0, diff0, it0, ivr0, ivi0), None, length=max_iter
        )

    v_re, v_im = _construct_v(theta, vm)
    converged = diff <= x_tol
    n_iter = n_iter + n_chord
    v_re, v_im = v_re.T, v_im.T  # [B, n]
    if single:
        return v_re[0], v_im[0], diff[0], n_iter[0], converged[0]
    return v_re, v_im, diff, n_iter, converged
