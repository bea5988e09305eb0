"""Tree-structured Newton-Raphson power flow for radial networks.

Distribution feeders are trees (the reference's example networks and both
synthetic feeders here are radial), and the polar NR Jacobian inherits the
network's sparsity: the 2x2 block J[i,k] = d(P_i,Q_i)/d(theta_k,|V|_k) is
nonzero only on the diagonal and across branches (Y_ik != 0).  Eliminating
a *leaf* bus touches only its parent -- the classic zero-fill property of
tree-ordered Gaussian elimination -- so the per-lane linear solve costs
O(n) 2x2-block operations instead of the O(n^3) dense elimination of
:func:`gym_anm_tpu.ops.power_flow.solve_ge_lanes`.  This is what makes
**true per-lane NR** feasible at 141 buses, where the dense path needs a
[560, 560, B] Jacobian (20 GB at B=4096 -- more than HBM) and was
previously replaced by the inexact chord-only iteration.  The reference
gets the same effect implicitly from scipy's sparse LU
(solve_load_flow.py:220); here the elimination *is* the tree.

Design (not a sparse-matrix library).  This XLA form is the plain reference
and the path off the GPU; on a GPU in float32 the same solve runs as one
CUDA kernel (ops/tree_cuda.py), whose per-lane walk uses this module's
elimination order.

* **Elimination-order renumbering makes every level contiguous.**  Nodes
  are grouped by height-from-leaves and renumbered so each level occupies
  a contiguous index range: per-level work is a slice, per-level results
  are written with contiguous ``.at[lo:hi].set`` updates, and child/parent
  references are static gathers.  There are **no scatters anywhere**.
* **Child contributions are gathered by the parent, never pushed.**  Each
  node's Schur-complement contribution to its parent is written once at
  its own (contiguous) position; the parent gathers its children's rows
  when its level is eliminated.  Sibling conflicts therefore never arise.
* **Sparse Y V.**  The nodal currents I = YV needed by the mismatch and
  Jacobian are evaluated over the tree edges (diagonal + parent + padded
  children) as exact-f32 elementwise multiply-adds -- O(n B) instead of
  the O(n^2 B) dense matmul, and free of any matmul input rounding.
* **Batch-last layout** [*, B] throughout, like every hot solver here.
* **No pivoting** -- within a 2x2 block (closed-form adjugate inverse) or
  across the tree (fixed leaf-to-root order).  Correctness is guarded by
  the convergence criterion: the accepted answer must drive the *true
  mismatch* below ``x_tol``, so a bad elimination can only cost
  iterations or surface as non-convergence, never return a wrong
  converged voltage.

The math (flat start, mismatch, polar Jacobian blocks, stopping rule)
is identical to the reference solver (solve_load_flow.py:7-226) and to
:mod:`gym_anm_tpu.ops.power_flow`; results agree with the dense path to
f32/f64 round-off (tests/test_tree_nr.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp
from jax import lax

from .power_flow import warm_init_theta_vm


@dataclasses.dataclass(frozen=True)
class TreeInfo:
    """Host-side elimination schedule for a radial network (all NumPy).

    Node = non-slack bus; ``m`` nodes are stored in **elimination order**
    (leaves first, grouped into contiguous levels; children always precede
    their parent).  ``eo`` index = position in this order.
    """

    n_bus: int
    bus: np.ndarray  # [m] full-bus index of node j (1..n-1)
    par_bus: np.ndarray  # [m] full-bus index of the parent (0 = slack)
    par_eo: np.ndarray  # [m] eo index of the parent; m (dummy) if slack
    has_par: np.ndarray  # [m] bool, parent is non-slack
    enum: np.ndarray  # [m] bus-1 -> eo position (inverse of ``bus - 1``)
    levels: tuple  # ((lo, hi), ...) contiguous eo ranges, leaves first
    ch_eo: np.ndarray  # [m, maxC] children eo indices, padded with m
    ch_bus: np.ndarray  # [m, maxC] children full-bus indices, padded with 0
    # Static admittance entries per node (complex split re/im):
    y_diag: np.ndarray  # [m, 2] Y[bus, bus]
    y_up: np.ndarray  # [m, 2] Y[bus, par_bus]   (row bus, col parent)
    y_down: np.ndarray  # [m, 2] Y[par_bus, bus] (row parent, col bus)
    y_ch: np.ndarray  # [m, maxC, 2] Y[bus, ch_bus] = y_down of each child, pad 0


def build_tree_info(br_f, br_t, n_bus, Y_re, Y_im):
    """Derive the elimination schedule from the branch list, or ``None``
    if the network is not a tree rooted at the slack (bus 0): wrong branch
    count, disconnected, or cyclic."""
    br_f = np.asarray(br_f)
    br_t = np.asarray(br_t)
    m = n_bus - 1
    if br_f.shape[0] != m:
        return None

    adj = [[] for _ in range(n_bus)]
    for f, t in zip(br_f.tolist(), br_t.tolist()):
        adj[f].append(t)
        adj[t].append(f)

    # BFS from the slack; a visited "child" seen twice means a cycle, and
    # with exactly n-1 edges full coverage implies a tree.
    parent_bus = np.full(n_bus, -2, dtype=np.int64)
    parent_bus[0] = -1
    order = [0]
    head = 0
    while head < len(order):
        u = order[head]
        head += 1
        for w in adj[u]:
            if parent_bus[w] == -2:
                parent_bus[w] = u
                order.append(w)
    if len(order) != n_bus:
        return None  # disconnected (and therefore cyclic elsewhere)

    children_bus = [[] for _ in range(n_bus)]
    for b in range(1, n_bus):
        children_bus[parent_bus[b]].append(b)

    # Height-from-leaves levels over non-slack buses.
    height = np.zeros(n_bus, dtype=np.int64)
    for b in reversed(order):  # children before parents in reverse BFS
        if b == 0:
            continue
        hs = [height[c] for c in children_bus[b]]
        height[b] = 1 + max(hs) if hs else 0

    n_levels = int(height[1:].max()) + 1 if m else 0
    eo_bus = []  # node full-bus indices in elimination order
    levels = []
    for lv in range(n_levels):
        lo = len(eo_bus)
        eo_bus.extend(int(b) for b in range(1, n_bus) if height[b] == lv)
        levels.append((lo, len(eo_bus)))
    bus = np.asarray(eo_bus, dtype=np.int64)
    enum = np.empty(m, dtype=np.int64)
    enum[bus - 1] = np.arange(m)

    par_bus = parent_bus[bus]
    has_par = par_bus != 0
    par_eo = np.where(has_par, enum[np.maximum(par_bus - 1, 0)], m)

    maxC = max((len(children_bus[int(b)]) for b in bus), default=0)
    maxC = max(maxC, 1)  # keep the arrays non-degenerate
    ch_eo = np.full((m, maxC), m, dtype=np.int64)
    ch_bus = np.zeros((m, maxC), dtype=np.int64)
    for j, b in enumerate(bus):
        for c_i, c in enumerate(children_bus[int(b)]):
            ch_eo[j, c_i] = enum[c - 1]
            ch_bus[j, c_i] = c

    Y_re = np.asarray(Y_re, np.float64)
    Y_im = np.asarray(Y_im, np.float64)
    y2 = lambda r, c: np.stack([Y_re[r, c], Y_im[r, c]], axis=-1)
    y_diag = y2(bus, bus)
    y_up = y2(bus, par_bus)
    y_down = y2(par_bus, bus)
    y_ch = np.where((ch_bus > 0)[:, :, None], y2(bus[:, None], ch_bus), 0.0)

    return TreeInfo(
        n_bus=n_bus,
        bus=bus,
        par_bus=par_bus,
        par_eo=par_eo,
        has_par=has_par,
        enum=enum,
        levels=tuple(levels),
        ch_eo=ch_eo,
        ch_bus=ch_bus,
        y_diag=y_diag,
        y_up=y_up,
        y_down=y_down,
        y_ch=y_ch,
    )


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def tree_nr_flops_per_lane(n: int, max_iter: int, maxC: int = 2, warm: bool = False) -> int:
    """Analytic executed-FLOP count per lane (same conventions as
    ``ops.power_flow.nr_flops_per_lane``: masked lanes count, divides and
    transcendentals count 1, compares/selects 0).

    Per node per NR iteration: sparse YV (2 + maxC complex mul-adds, 8
    flops each) + mismatch ~12; Jacobian blocks D/L/U ~130; elimination
    (2x2 adjugate inverse, child gather-sums, L Dinv, Schur products)
    ~60 + 8 maxC; back-substitution ~20; iterate/carry updates ~25.
    """
    m = n - 1
    per_node = (2 + maxC) * 8 + 12 + 130 + 60 + 8 * maxC + 20 + 25
    setup = m * ((2 + maxC) * 8 + 20) * (2 if warm else 1)
    return setup + max_iter * per_node * m


def solve_pfe_tree(tree: TreeInfo, p, q, x_tol=1e-5, max_iter=10, init=None):
    """Batched NR solve over the tree factorization.

    ``tree``: a :class:`TreeInfo` (static, host NumPy -- folds into the
    program as constants).  ``p, q``: [B, m] (or [m]) net injections at the
    non-slack buses in **bus order** (1..n-1), like
    :func:`~gym_anm_tpu.ops.power_flow.solve_pfe`.  ``init`` optionally
    warm-starts from previous bus voltages ``(v_re [B, n], v_im [B, n])``
    with the best-of-{warm, flat} per-lane guard.  Not jitted itself (the
    schedule is a static Python object); call under the caller's ``jit``.

    Returns ``(v_re, v_im, diff, n_iter, converged)`` batch-first, matching
    ``solve_pfe``.
    """
    single = p.ndim == 1
    if single:
        p, q = p[None, :], q[None, :]
    dt = p.dtype
    m = tree.bus.shape[0]
    n = tree.n_bus
    B = p.shape[0]

    # Static gathers / constants (NumPy, folded into the program).
    f = lambda a: np.asarray(a, dtype=dt)
    busm1 = tree.bus - 1  # node -> bus-1 (for p/q and theta/vm gathers)
    enum = tree.enum  # bus-1 -> eo
    ydr, ydi = f(tree.y_diag[:, 0])[:, None], f(tree.y_diag[:, 1])[:, None]  # [m, 1]
    yur, yui = f(tree.y_up[:, 0])[:, None], f(tree.y_up[:, 1])[:, None]
    ywr, ywi = f(tree.y_down[:, 0])[:, None], f(tree.y_down[:, 1])[:, None]
    ycr = f(tree.y_ch[:, :, 0])[:, :, None]  # [m, maxC, 1]
    yci = f(tree.y_ch[:, :, 1])[:, :, None]

    pT = p.T[busm1]  # [m, B] in eo order (node j's injection = bus busm1[j])
    qT = q.T[busm1]

    def v_full(theta, vm):
        vr_n = vm * jnp.cos(theta)  # [m, B] eo
        vi_n = vm * jnp.sin(theta)
        one = jnp.ones((1, B), dt)
        zero = jnp.zeros((1, B), dt)
        vr = jnp.concatenate([one, vr_n[enum]], axis=0)  # bus order
        vi = jnp.concatenate([zero, vi_n[enum]], axis=0)
        return vr, vi

    def yv_nodes(vr, vi):
        """I = YV at the nodes (eo order) via the tree edges: diagonal +
        parent + padded children.  Exact f32 FMAs, O(n B)."""
        vbr, vbi = vr[tree.bus], vi[tree.bus]  # [m, B]
        vpr, vpi = vr[tree.par_bus], vi[tree.par_bus]
        vcr, vci = vr[tree.ch_bus], vi[tree.ch_bus]  # [m, maxC, B]
        ir, ii = _cmul(ydr, ydi, vbr, vbi)
        ur, ui = _cmul(yur, yui, vpr, vpi)
        cr, ci = _cmul(ycr, yci, vcr, vci)
        return ir + ur + cr.sum(axis=1), ii + ui + ci.sum(axis=1)

    def mismatch(vr, vi, ir, ii):
        """F blocks (dP, dQ) [m, B] each, eo order; diff = inf-norm."""
        vbr, vbi = vr[tree.bus], vi[tree.bus]
        Fp = (vbr * ir + vbi * ii) - pT
        Fq = (vbi * ir - vbr * ii) - qT
        diff = jnp.maximum(jnp.max(jnp.abs(Fp), axis=0), jnp.max(jnp.abs(Fq), axis=0))
        return Fp, Fq, diff

    hp = tree.has_par[:, None]  # [m, 1] static mask

    def jacobian_blocks(vr, vi, ir, ii):
        """Diagonal D and off-diagonal L = J[par, node], U = J[node, par]
        2x2 blocks, eo order, components [m, B].

        Block convention (rows = (dP_i, dQ_i), cols = (dtheta_k, dvm_k)):
        [[Re dSa, Re dSm], [Im dSa, Im dSm]] with
        dSa[i,k] = 1j v_i conj(delta_ik I_i - Y_ik v_k),
        dSm[i,k] = delta_ik vn_i conj(I_i) + v_i conj(Y_ik vn_k)
        (solve_load_flow.py:123-164).
        """
        vbr, vbi = vr[tree.bus], vi[tree.bus]
        vmag = jnp.sqrt(vbr * vbr + vbi * vbi)
        vnr, vni = vbr / vmag, vbi / vmag
        vpr, vpi = vr[tree.par_bus], vi[tree.par_bus]
        pmag = jnp.sqrt(vpr * vpr + vpi * vpi)
        # Parent = slack rows are masked out of L/U anyway; avoid 0/0.
        pmag = jnp.where(np.asarray(~tree.has_par)[:, None], 1.0, pmag)
        pnr, pni = vpr / pmag, vpi / pmag

        def blocks(a, b, wre, wim, ure, uim, t1r=None, t1i=None):
            """J entries for row-bus voltage (a, b), w = (I-contrib), u =
            Y*vn term; t1 adds the diagonal-only vn conj(I) piece."""
            dSa_re = a * wim - b * wre
            dSa_im = a * wre + b * wim
            dSm_re = a * ure + b * uim
            dSm_im = b * ure - a * uim
            if t1r is not None:
                dSm_re = dSm_re + t1r
                dSm_im = dSm_im + t1i
            return dSa_re, dSm_re, dSa_im, dSm_im

        # Diagonal: w = I_i - Y_ii v_i ; u = Y_ii vn_i ; t1 = vn_i conj(I_i).
        yvr, yvi = _cmul(ydr, ydi, vbr, vbi)
        ure, uim = _cmul(ydr, ydi, vnr, vni)
        t1r = vnr * ir + vni * ii
        t1i = vni * ir - vnr * ii
        D = blocks(vbr, vbi, ir - yvr, ii - yvi, ure, uim, t1r, t1i)

        # L = J[par, node]: row voltage = v_par, w = -Y_down v_node,
        # u = Y_down vn_node.
        wre, wim = _cmul(ywr, ywi, vbr, vbi)
        ure, uim = _cmul(ywr, ywi, vnr, vni)
        L = blocks(vpr, vpi, -wre, -wim, ure, uim)

        # U = J[node, par]: row voltage = v_node, w = -Y_up v_par,
        # u = Y_up vn_par.
        wre, wim = _cmul(yur, yui, vpr, vpi)
        ure, uim = _cmul(yur, yui, pnr, pni)
        U = blocks(vbr, vbi, -wre, -wim, ure, uim)

        L = tuple(jnp.where(hp, x, 0.0) for x in L)
        U = tuple(jnp.where(hp, x, 0.0) for x in U)
        return D, L, U

    def tree_solve(D, L, U, Fp, Fq):
        """Solve J dx = F via leaf-to-root block elimination.  All arrays
        eo order; returns (dx_theta, dx_vm) [m, B] in eo order."""
        D00, D01, D10, D11 = D
        L00, L01, L10, L11 = L
        U00, U01, U10, U11 = U

        # Per-node outputs, written contiguously level by level; the extra
        # dummy row m reads 0 for padded child / slack-parent gathers.
        z = jnp.zeros((m + 1, B), dt)
        Dinv = [z, z, z, z]
        beff = [z, z]
        # Contribution of each node to its parent (read via child gathers).
        cD = [z, z, z, z]
        cB = [z, z]

        for lo, hi in tree.levels:
            sl = slice(lo, hi)
            chs = tree.ch_eo[sl]  # [k, maxC] static (dummy -> zero row)
            # Effective diagonal/rhs: initial minus accumulated child Schur
            # complements (children were eliminated in earlier levels).
            d00 = D00[sl] - cD[0][chs].sum(axis=1)
            d01 = D01[sl] - cD[1][chs].sum(axis=1)
            d10 = D10[sl] - cD[2][chs].sum(axis=1)
            d11 = D11[sl] - cD[3][chs].sum(axis=1)
            b0 = Fp[sl] - cB[0][chs].sum(axis=1)
            b1 = Fq[sl] - cB[1][chs].sum(axis=1)
            det = d00 * d11 - d01 * d10
            i00, i01, i10, i11 = d11 / det, -d01 / det, -d10 / det, d00 / det
            Dinv = [
                Dinv[0].at[sl].set(i00),
                Dinv[1].at[sl].set(i01),
                Dinv[2].at[sl].set(i10),
                Dinv[3].at[sl].set(i11),
            ]
            beff = [beff[0].at[sl].set(b0), beff[1].at[sl].set(b1)]

            # Schur contribution to the parent: M = L Dinv; cD = M U;
            # cB = M b.  (Masked to zero for slack-parent nodes.)
            l00, l01, l10, l11 = L00[sl], L01[sl], L10[sl], L11[sl]
            M00 = l00 * i00 + l01 * i10
            M01 = l00 * i01 + l01 * i11
            M10 = l10 * i00 + l11 * i10
            M11 = l10 * i01 + l11 * i11
            u00, u01, u10, u11 = U00[sl], U01[sl], U10[sl], U11[sl]
            hpk = hp[sl]
            w = lambda x: jnp.where(hpk, x, 0.0)
            cD = [
                cD[0].at[sl].set(w(M00 * u00 + M01 * u10)),
                cD[1].at[sl].set(w(M00 * u01 + M01 * u11)),
                cD[2].at[sl].set(w(M10 * u00 + M11 * u10)),
                cD[3].at[sl].set(w(M10 * u01 + M11 * u11)),
            ]
            cB = [
                cB[0].at[sl].set(w(M00 * b0 + M01 * b1)),
                cB[1].at[sl].set(w(M10 * b0 + M11 * b1)),
            ]

        # Back-substitution, root level first (parents are solved strictly
        # before their children; dummy row m reads 0 for slack parents).
        x0 = jnp.zeros((m + 1, B), dt)
        x1 = jnp.zeros((m + 1, B), dt)
        for lo, hi in reversed(tree.levels):
            sl = slice(lo, hi)
            pe = tree.par_eo[sl]  # static gather indices
            xp0, xp1 = x0[pe], x1[pe]
            r0 = beff[0][sl] - (U00[sl] * xp0 + U01[sl] * xp1)
            r1 = beff[1][sl] - (U10[sl] * xp0 + U11[sl] * xp1)
            x0 = x0.at[sl].set(Dinv[0][sl] * r0 + Dinv[1][sl] * r1)
            x1 = x1.at[sl].set(Dinv[2][sl] * r0 + Dinv[3][sl] * r1)
        return x0[:m], x1[:m]

    # ------------------------------------------------------------------
    # Flat / warm starting points (best-of per lane, like solve_pfe).
    theta_f = jnp.zeros((m, B), dt)
    vm_f = jnp.ones((m, B), dt)
    vr_f, vi_f = v_full(theta_f, vm_f)
    ir_f, ii_f = yv_nodes(vr_f, vi_f)
    Fp_f, Fq_f, diff_f = mismatch(vr_f, vi_f, ir_f, ii_f)

    if init is not None:
        v0r, v0i = init
        if single:
            v0r, v0i = v0r[None, :], v0i[None, :]
        # warm_init_theta_vm returns bus order [m, B]; reorder to eo.
        th_b, vm_b, _ = warm_init_theta_vm(v0r, v0i, m, dt)
        theta_w, vm_w = th_b[busm1], vm_b[busm1]
        vr_w, vi_w = v_full(theta_w, vm_w)
        ir_w, ii_w = yv_nodes(vr_w, vi_w)
        Fp_w, Fq_w, diff_w = mismatch(vr_w, vi_w, ir_w, ii_w)
        use_w = jnp.isfinite(diff_w) & (diff_w < diff_f)
        wm = use_w[None, :]
        theta0 = jnp.where(wm, theta_w, theta_f)
        vm0 = jnp.where(wm, vm_w, vm_f)
        Fp0 = jnp.where(wm, Fp_w, Fp_f)
        Fq0 = jnp.where(wm, Fq_w, Fq_f)
        diff0 = jnp.where(use_w, diff_w, diff_f)
        ir0 = jnp.where(wm, ir_w, ir_f)
        ii0 = jnp.where(wm, ii_w, ii_f)
    else:
        theta0, vm0, Fp0, Fq0, diff0 = theta_f, vm_f, Fp_f, Fq_f, diff_f
        ir0, ii0 = ir_f, ii_f

    def body(c, _):
        theta, vm, Fp, Fq, diff, it, ir, ii = c
        active = diff > x_tol  # NaN freezes the lane
        vr, vi = v_full(theta, vm)
        D, L, U = jacobian_blocks(vr, vi, ir, ii)
        dx0, dx1 = tree_solve(D, L, U, Fp, Fq)
        theta_n = theta - dx0
        vm_n = vm - dx1
        vr_n, vi_n = v_full(theta_n, vm_n)
        ir_n, ii_n = yv_nodes(vr_n, vi_n)
        Fp_n, Fq_n, d_n = mismatch(vr_n, vi_n, ir_n, ii_n)
        am = active[None, :]
        theta = jnp.where(am, theta_n, theta)
        vm = jnp.where(am, vm_n, vm)
        Fp = jnp.where(am, Fp_n, Fp)
        Fq = jnp.where(am, Fq_n, Fq)
        ir = jnp.where(am, ir_n, ir)
        ii = jnp.where(am, ii_n, ii)
        diff = jnp.where(active, d_n, diff)
        return (theta, vm, Fp, Fq, diff, it + active.astype(jnp.int32), ir, ii), None

    it0 = jnp.zeros((B,), jnp.int32)
    (theta, vm, _, _, diff, n_iter, _, _), _ = lax.scan(
        body, (theta0, vm0, Fp0, Fq0, diff0, it0, ir0, ii0), None, length=max_iter
    )

    vr, vi = v_full(theta, vm)
    converged = diff <= x_tol
    v_re, v_im = vr.T, vi.T  # [B, n]
    if single:
        return v_re[0], v_im[0], diff[0], n_iter[0], converged[0]
    return v_re, v_im, diff, n_iter, converged
