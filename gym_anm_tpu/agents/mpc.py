"""MPC DC-OPF baseline agents.

JAX re-design of the reference's CVXPY-based multi-stage DC Optimal
Power Flow policy (``gym_anm/agents/mpc.py:8-441``).  The reference builds a
parametric CVXPY problem once and re-solves it with ECOS each step; here the
same N-stage DC-OPF is assembled **once** as a dense linear program

    min  q^T z   s.t.   l <= A z <= u

(the branch-overflow penalty ``max(0, |P_ij| - beta * rate)`` is linearized
with per-branch slack variables), and solved by an OSQP-style ADMM iteration
whose KKT matrix ``sigma*I + A^T diag(rho) A`` is factorized once at
construction -- so every ``act()`` is just matvecs + clipping, jit-able and
vmap-able over batches of (forecast, SoC) parameters.  A final active-set
"polish" solve recovers the exact LP vertex, matching the reference solver
to ~1e-9.

Per-stage variables, mirroring mpc.py:202-319:
``z_s = [theta (n_bus), P_dev (n_dev), p_ch (n_des), p_dis (n_des),
soc (n_des), t (n_branch)]`` with constraints:

* DC flow balance  sum_ij B_ij (theta_i - theta_j) = sum_d P_d  (mpc.py:241-253)
* loads pinned to forecasts                                     (mpc.py:255-259)
* generator / storage P bounds                                  (mpc.py:261-273)
* generation <= forecasted potential                            (mpc.py:275-279)
* P_des = p_dis - p_ch, SoC recursion with efficiency, SoC box  (mpc.py:281-295)
* |theta| <= pi, slack angle = 0                                (mpc.py:297-302)
* t >= 0, t >= +-P_branch - beta*rate  (linearized penalty)     (mpc.py:304-314)

Objective: sum_s gamma^s [ sum_{non-renewable gens} P + lamb * sum_br t ]
(mpc.py:304-314).  Action extraction: stage-0 P for non-slack generators
and storage, Q = 0, scaled to MW and clipped (mpc.py:372-393).

Reference quirk reproduced: the slack-angle constraint indexes ``theta``
with the slack *device* mapping position, not the slack bus position
(mpc.py:302) -- identical whenever the slack device is device 0 on bus 0.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp



def _trace_highest(f):
    """Trace ``f`` under f32-exact matmuls.

    A default-precision float32 matmul may round its inputs (TF32 on GPU
    tensor cores, ~1e-3 relative).  The ADMM KKT factorizations and Schur
    complements here are one-shot (not self-correcting): rounded products
    can make the stage blocks indefinite, at which point the Cholesky
    factor -- and every action -- is NaN (seen at horizons >= 10 with
    bf16-rounded products, scripts/mpc_bench.py).  Pinning the trace to HIGHEST restores the f64-host
    semantics; the same lesson as the one-shot einsums in
    core/transition.py (docs/quirks.md).
    """

    def g(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return f(*args, **kwargs)

    return g


class MPCAgent:
    """Base class: build the parametric N-stage DC-OPF (abstract forecast()).

    Parameters mirror the reference (mpc.py:32-57): ``simulator`` (the
    gym_anm_tpu Simulator facade), ``action_space``, ``gamma``,
    ``safety_margin`` (beta), ``planning_steps`` (N).
    """

    def __init__(
        self, simulator, action_space, gamma, safety_margin=0.9, planning_steps=1, solver_x64=False,
        warm_start=False, warm_shift=True,
    ):
        # warm_start: carry the (scaled) ADMM iterate across consecutive
        # ``act()`` calls -- the receding-horizon problems at consecutive
        # env steps differ only in a few parameter rows, so the previous
        # optimum is near-feasible and the early-exit chunk loop converges
        # in far fewer chunks.  warm_shift additionally realigns the carry
        # by one stage (stage s <- s+1, last stage duplicated, duals
        # un-discounted by 1/gamma) -- the receding-horizon shift, which
        # matters for time-varying forecasts (MPCAgentPerfect) and is a
        # near-no-op for constant forecasts.  The reference re-solves its
        # parametric CVXPY problem cold each step (mpc.py:372-393);
        # warm_start=False reproduces that behavior exactly.
        self.warm_start = bool(warm_start)
        self.warm_shift = bool(warm_shift)
        self._act_carry = None
        # solver_x64: run the ADMM solver in float64 via the scoped
        # jax.enable_x64(True) context -- in float32 the batched ADMM
        # plateaus at ~1e-4 scaled residuals, which at feeder141 scale
        # leaves a measurable objective gap (~5-10% vs the HiGHS optimum;
        # f64 closes it to ~1e-5).
        # No-op where x64 is already globally enabled (the CPU test suite).
        self.solver_x64 = bool(solver_x64)
        self.safety_margin = safety_margin
        self.baseMVA = simulator.baseMVA
        self.lamb = simulator.lamb
        self.action_space = action_space
        self.planning_steps = int(planning_steps)
        self.gamma = gamma

        spec = simulator.spec
        self.spec = spec
        self.simulator = simulator
        self.n_bus = spec.n_bus
        self.n_dev = spec.n_dev
        self.n_branch = spec.n_branch
        self.delta_t = spec.delta_t
        self.n_gen = spec.n_gen + 1  # incl. slack, as the reference counts
        self.n_des = spec.n_des
        self.n_load = spec.n_load
        self.n_rer = spec.n_rer
        self.load_ids = list(spec.load_ids)
        self.non_slack_gen_ids = list(spec.gen_ids)
        self.gen_rer_ids = list(spec.rer_ids)
        self.des_ids = list(spec.des_ids)
        self.branch_ids = list(spec.branch_ids)
        self.device_ids = list(spec.dev_ids)
        self.bus_ids = list(spec.bus_ids)
        self.gen_ids = [spec.slack_dev_id] + [i for i in spec.dev_ids if i in spec.gen_ids]
        self.slack_dev_id = spec.slack_dev_id

        # ID -> dense-position mappings (mpc.py:88-98).
        self.bus_id_mapping = {b: i for i, b in enumerate(self.bus_ids)}
        self.dev_id_mapping = {d: i for i, d in enumerate(self.device_ids)}

        # B matrix in bus-ID order (mpc.py:110-111).
        srt = np.asarray(spec.bus_sorted)
        self.B_bus = np.asarray(spec.Y_im)[np.ix_(srt, srt)]

        self._build_lp()
        self._build_solver()

    def _x64_ctx(self):
        """Scoped-x64 context for solver calls (see ``solver_x64``)."""
        if self.solver_x64:
            return jax.enable_x64(True)
        from contextlib import nullcontext

        return nullcontext()

    # ------------------------------------------------------------------
    # LP assembly (host-side numpy, once).
    # ------------------------------------------------------------------
    def _build_lp(self):
        spec = self.spec
        nb, nd, ndes, nbr = self.n_bus, self.n_dev, self.n_des, self.n_branch
        N = self.planning_steps
        S = nb + nd + 2 * ndes + ndes + nbr  # stage width

        def off(s):
            base = s * S
            return dict(
                theta=base,
                P=base + nb,
                pch=base + nb + nd,
                pdis=base + nb + nd + ndes,
                soc=base + nb + nd + 2 * ndes,
                t=base + nb + nd + 3 * ndes,
            )

        self.stage_size = S
        self.nz = N * S

        dev_pos = self.dev_id_mapping
        bus_pos = self.bus_id_mapping
        load_pos = [dev_pos[i] for i in self.load_ids]
        gen_pos = [dev_pos[i] for i in self.non_slack_gen_ids]
        des_pos = [dev_pos[i] for i in self.des_ids]
        # Device -> bus (ID-order positions).
        srt = np.asarray(spec.bus_sorted)
        inv = np.empty_like(srt)
        inv[srt] = np.arange(len(srt))  # internal idx -> sorted position
        dev_bus_sorted = inv[np.asarray(spec.dev_bus)]

        rows_A, rows_l, rows_u = [], [], []
        # Parameter hooks: (row_index, kind, stage, local_index) where kind in
        # {"load_eq", "gen_cap", "soc_init"}; act() writes l/u there.
        self.param_rows = []

        P_gen_min = np.asarray(spec.gen_p_min)
        P_gen_max = np.asarray(spec.gen_p_max)
        P_des_min = np.asarray(spec.dev_p_min)[des_pos] if ndes else np.zeros(0)
        P_des_max = np.asarray(spec.dev_p_max)[des_pos] if ndes else np.zeros(0)
        soc_min = np.asarray(spec.des_soc_min)
        soc_max = np.asarray(spec.des_soc_max)
        eff = np.asarray(spec.des_eff)
        rates = np.asarray(spec.br_rate)
        beta = self.safety_margin
        B = self.B_bus

        def add_row(cols, vals, lo, hi):
            row = np.zeros(self.nz)
            row[np.asarray(cols, dtype=int)] = vals
            rows_A.append(row)
            rows_l.append(lo)
            rows_u.append(hi)
            return len(rows_A) - 1

        for s in range(N):
            o = off(s)
            # R1: DC flow balance per bus (mpc.py:241-253).
            for i_pos in range(nb):
                cols, vals = [], []
                for (f, t) in self.branch_ids:
                    j, k = bus_pos[f], bus_pos[t]
                    if j == i_pos:
                        cols += [o["theta"] + j, o["theta"] + k]
                        vals += [B[j, k], -B[j, k]]
                    elif k == i_pos:
                        cols += [o["theta"] + k, o["theta"] + j]
                        vals += [B[k, j], -B[k, j]]
                # minus sum of device injections at this bus
                for d_idx in range(nd):
                    if dev_bus_sorted[d_idx] == i_pos:
                        cols.append(o["P"] + d_idx)
                        vals.append(-1.0)
                # Accumulate duplicate columns.
                row = np.zeros(self.nz)
                for c, v in zip(cols, vals):
                    row[c] += v
                rows_A.append(row)
                rows_l.append(0.0)
                rows_u.append(0.0)

            # R2: loads pinned to forecast (param).
            for li, p in enumerate(load_pos):
                r = add_row([o["P"] + p], [1.0], 0.0, 0.0)
                self.param_rows.append((r, "load_eq", s, li))

            # R3/R5: gen box + potential cap (param u).
            for gi, p in enumerate(gen_pos):
                add_row([o["P"] + p], [1.0], P_gen_min[gi], P_gen_max[gi])
                r = add_row([o["P"] + p], [1.0], -np.inf, np.inf)
                self.param_rows.append((r, "gen_cap", s, gi))

            # R4: storage box.
            for di, p in enumerate(des_pos):
                add_row([o["P"] + p], [1.0], P_des_min[di], P_des_max[di])

            # R6: P_des = p_dis - p_ch (mpc.py:291).
            for di, p in enumerate(des_pos):
                add_row([o["P"] + p, o["pdis"] + di, o["pch"] + di], [1.0, -1.0, 1.0], 0.0, 0.0)

            # R7: SoC recursion (mpc.py:281-295).
            for di in range(ndes):
                cols = [o["soc"] + di, o["pch"] + di, o["pdis"] + di]
                vals = [1.0, -self.delta_t * eff[di], self.delta_t / eff[di]]
                if s == 0:
                    r = add_row(cols, vals, 0.0, 0.0)
                    self.param_rows.append((r, "soc_init", s, di))
                else:
                    cols.append(off(s - 1)["soc"] + di)
                    vals.append(-1.0)
                    add_row(cols, vals, 0.0, 0.0)

            # R8: SoC box.
            for di in range(ndes):
                add_row([o["soc"] + di], [1.0], soc_min[di], soc_max[di])

            # R9: theta box (mpc.py:297-299).
            for i_pos in range(nb):
                add_row([o["theta"] + i_pos], [1.0], -np.pi, np.pi)

            # R10: slack angle = 0, using the reference's device-position
            # index quirk (mpc.py:302).
            add_row([o["theta"] + self.dev_id_mapping[self.slack_dev_id]], [1.0], 0.0, 0.0)

            # R11: branch-overflow slacks: +-P_branch - t <= beta*rate.
            for bi, (f, t) in enumerate(self.branch_ids):
                j, k = bus_pos[f], bus_pos[t]
                c = B[j, k]
                add_row(
                    [o["theta"] + j, o["theta"] + k, o["t"] + bi],
                    [c, -c, -1.0],
                    -np.inf,
                    beta * rates[bi] if np.isfinite(rates[bi]) else np.inf,
                )
                add_row(
                    [o["theta"] + j, o["theta"] + k, o["t"] + bi],
                    [-c, c, -1.0],
                    -np.inf,
                    beta * rates[bi] if np.isfinite(rates[bi]) else np.inf,
                )

            # R12: nonnegativity of t, p_ch, p_dis.
            for bi in range(nbr):
                add_row([o["t"] + bi], [1.0], 0.0, np.inf)
            for di in range(ndes):
                add_row([o["pch"] + di], [1.0], 0.0, np.inf)
                add_row([o["pdis"] + di], [1.0], 0.0, np.inf)

        self.A = np.asarray(rows_A)
        self.l = np.asarray(rows_l)
        self.u = np.asarray(rows_u)

        # Objective (mpc.py:304-314): gamma^s * (non-renewable gen P + lamb * t).
        q = np.zeros(self.nz)
        nonrer_gen_pos = [dev_pos[g] for g in self.gen_ids if g not in self.gen_rer_ids]
        for s in range(N):
            o = off(s)
            for p in nonrer_gen_pos:
                q[o["P"] + p] += self.gamma**s
            for bi in range(nbr):
                q[o["t"] + bi] += self.gamma**s * self.lamb
        self.q = q
        self._off0 = off(0)

    # ------------------------------------------------------------------
    # OSQP-style ADMM solver with one-time KKT factorization.
    # ------------------------------------------------------------------
    def _build_solver(self, rho=0.1, sigma=1e-6, alpha=1.6, iters=4000):
        A, l, u = self.A, self.l, self.u
        m, n = A.shape

        # Ruiz equilibration (OSQP-style): diagonal E (rows) / D (cols) so
        # the scaled A has ~unit-norm rows and columns -- the decisive factor
        # for ADMM convergence speed on this LP.
        D = np.ones(n)
        E = np.ones(m)
        As = A.copy()
        for _ in range(15):
            r = np.sqrt(np.maximum(np.max(np.abs(As), axis=1), 1e-8))
            As = As / r[:, None]
            E /= r
            c = np.sqrt(np.maximum(np.max(np.abs(As), axis=0), 1e-8))
            As = As / c[None, :]
            D /= c
        self._D, self._E = D, E
        qs = D * self.q
        cost_norm = max(np.max(np.abs(qs)), 1e-6)
        self._c = 1.0 / cost_norm
        qs = qs * self._c

        self._eq_rows = (l == u) & np.isfinite(l)
        self._As = As
        self._qs = qs
        self._rho0 = rho
        self._sigma = sigma
        self._alpha = alpha
        self._chunk_iters = iters

        Aj = jnp.asarray(As)
        qj = jnp.asarray(qs)

        def admm_chunk(ls, us, x, z, y, L, rho_vec):
            def solve_kkt(b):
                h = jax.scipy.linalg.solve_triangular(L, b, lower=True)
                return jax.scipy.linalg.solve_triangular(L.T, h, lower=False)

            def body(carry, _):
                x, z, y = carry
                b = sigma * x - qj + Aj.T @ (rho_vec * z - y)
                x_new = solve_kkt(b)
                Ax = Aj @ x_new
                z_t = alpha * Ax + (1 - alpha) * z
                z_new = jnp.clip(z_t + y / rho_vec, ls, us)
                y_new = y + rho_vec * (z_t - z_new)
                return (x_new, z_new, y_new), None

            (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=iters)
            # Residuals in the scaled space (OSQP termination criteria).
            Ax = Aj @ x
            pri = jnp.max(jnp.abs(Ax - z))
            dual = jnp.max(jnp.abs(qj + Aj.T @ y + sigma * x))
            return x, z, y, pri, dual

        self._admm_chunk = jax.jit(_trace_highest(admm_chunk))

        def admm_batch_full(ls, us, x0, z0, y0, rho0, n_chunks, chunk_len, eps):
            """Fully on-device batched ADMM: ls/us [B, m] -> x [B, n].

            Runs ``n_chunks`` chunks of ``chunk_len`` iterations under one
            jit; after each chunk the per-lane rho is rebalanced from the
            primal/dual residual ratio and the per-lane KKT matrix is
            re-factorized on device (OSQP's adaptive-rho scheme, without
            any host round-trips -- closes the host-driven restart loop of
            the earlier implementation).  Fixed iteration structure (scan
            of scans), one program per solve; converged lanes simply keep
            iterating at their fixed point (ADMM fixed points are
            rho-invariant).

            (x0, z0, y0, rho0) is the starting iterate: zeros for a cold
            start, or the previous receding-horizon solve's final iterate
            for a warm start (the MPC problems at consecutive env steps
            differ only in a few parameter rows, so the previous optimum
            is already near-feasible and far fewer chunks are needed).
            """
            eye = jnp.eye(Aj.shape[1], dtype=Aj.dtype)

            def factor_inv(rho):  # rho [B, m] -> K^-1 [B, n, n]
                # Explicit inverse (via the Cholesky factor) instead of two
                # triangular solves *per iteration*: substitution is
                # sequential, while the inner loop below is then one batched
                # matrix-vector product per iteration.  K is SPD
                # with sigma-regularization; ADMM tolerates the inexact
                # solve (it is a fixed-point iteration) and the host path
                # (`_admm` + `_polish`) keeps the backward-stable solves.
                K = sigma * eye[None] + jnp.einsum("mi,Bm,mj->Bij", Aj, rho, Aj)
                L = jnp.linalg.cholesky(K)
                eyeB = jnp.broadcast_to(eye, K.shape)
                h = jax.scipy.linalg.solve_triangular(L, eyeB, lower=True)
                return jax.scipy.linalg.solve_triangular(
                    jnp.swapaxes(L, -1, -2), h, lower=False
                )

            def chunk(carry, _):
                x, z, y, rho = carry  # x [B, n], z/y/rho [B, m]
                Kinv = factor_inv(rho)

                def body(c, _):
                    x, z, y = c
                    b = sigma * x - qj[None] + jnp.einsum("mn,Bm->Bn", Aj, rho * z - y)
                    x_new = jnp.einsum("Bij,Bj->Bi", Kinv, b)
                    Ax = jnp.einsum("mn,Bn->Bm", Aj, x_new)
                    z_t = alpha * Ax + (1 - alpha) * z
                    z_new = jnp.clip(z_t + y / rho, ls, us)
                    y_new = y + rho * (z_t - z_new)
                    return (x_new, z_new, y_new), None

                (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=chunk_len)
                Ax = jnp.einsum("mn,Bn->Bm", Aj, x)
                pri = jnp.max(jnp.abs(Ax - z), axis=1)  # [B]
                dual = jnp.max(jnp.abs(qj[None] + jnp.einsum("mn,Bm->Bn", Aj, y) + sigma * x), axis=1)
                ratio = jnp.sqrt(jnp.maximum(pri, 1e-16) / jnp.maximum(dual, 1e-16))
                ratio = jnp.clip(ratio, 1e-2, 1e2)
                conv = (pri < eps) & (dual < eps)
                rebal = (~conv) & ((ratio < 0.5) | (ratio > 2.0))
                rho = jnp.where(rebal[:, None], jnp.clip(rho * ratio[:, None], 1e-6, 1e6), rho)
                return (x, z, y, rho), (pri, dual)

            (x, z, y, rho), (pri, dual) = jax.lax.scan(
                chunk, (x0, z0, y0, rho0), None, length=n_chunks
            )
            return x, z, y, rho, pri[-1], dual[-1]

        self._admm_batch_full = jax.jit(_trace_highest(admm_batch_full), static_argnums=(6, 7, 8))

    def _factor(self, rho_vec):
        K = self._sigma * np.eye(self.nz) + (self._As.T * rho_vec) @ self._As
        return np.linalg.cholesky(K)

    def _admm(self, lv, uv, eps=1e-9, max_chunks=12, warm=None):
        """Run ADMM to convergence with warm-started chunks and adaptive rho
        (refactorizing the KKT matrix on rho updates, as OSQP does).

        ``warm`` is a scaled-space (x, z, y) carry from a previous call
        (the 4th return value); starting from it, the early-exit chunk loop
        converges in fewer chunks on receding-horizon problem sequences.

        Runs under the scoped ``solver_x64`` context (like the banded
        backend): the jitted chunk re-traces on the f64 operands, so the
        flag is honored on this dense backend too.  Returns
        ``(x, z, y, carry)`` -- the first three unscaled as before."""
        with self._x64_ctx():
            return self._admm_impl(lv, uv, eps=eps, max_chunks=max_chunks, warm=warm)

    def _admm_impl(self, lv, uv, eps=1e-9, max_chunks=12, warm=None):
        m, n = self._As.shape
        ls, us = self._E * lv, self._E * uv
        rho_vec = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0)
        L = self._factor(rho_vec)
        if warm is None:
            x = np.zeros(n)
            z = np.clip(np.zeros(m), ls, us)
            y = np.zeros(m)
        else:
            x, z, y = (np.asarray(v, dtype=float) for v in warm)
            z = np.clip(z, ls, us)
            if not np.all(np.isfinite(x)) or not np.all(np.isfinite(y)):
                x, z, y = np.zeros(n), np.clip(np.zeros(m), ls, us), np.zeros(m)
        prev_worst = np.inf
        for _ in range(max_chunks):
            x, z, y, pri, dual = (
                np.asarray(v)
                for v in self._admm_chunk(
                    jnp.asarray(ls), jnp.asarray(us), jnp.asarray(x), jnp.asarray(z), jnp.asarray(y),
                    jnp.asarray(L), jnp.asarray(rho_vec),
                )
            )
            worst = max(pri, dual)
            if pri < eps and dual < eps:
                break
            if worst < 1e-6 and worst > 0.5 * prev_worst:
                break  # stalled at the residual floor; the polish finishes
            prev_worst = worst
            factor = np.sqrt(max(pri, 1e-16) / max(dual, 1e-16))
            factor = float(np.clip(factor, 1e-2, 1e2))
            if 0.5 < factor < 2.0:
                continue  # balanced: just iterate more
            rho_vec = np.clip(rho_vec * factor, 1e-6, 1e6)
            L = self._factor(rho_vec)
        # Unscale: x = D x_bar, z = E^-1 z_bar, y = E y_bar / c.
        return self._D * x, z / self._E, self._E * y / self._c, (x, z, y)

    def _polish(self, x, z, y, lv, uv, tol=1e-6):
        """Active-set refinement: solve the equality-constrained system on the
        detected active rows to recover the exact LP vertex (OSQP-style)."""
        A, q = self.A, self.q
        act_l = (z <= lv + tol) & (y < -tol / 10)
        act_u = (z >= uv - tol) & (y > tol / 10)
        eq = (lv == uv) & np.isfinite(lv)
        act = act_l | act_u | eq
        if not np.any(act):
            return x
        A_act = A[act]
        b_act = np.where(act_u[act], uv[act], lv[act])
        # KKT of min q^T x + (delta/2)||x||^2 s.t. A_act x = b_act.
        na = A_act.shape[0]
        delta = 1e-9
        KKT = np.block([[delta * np.eye(self.nz), A_act.T], [A_act, -delta * np.eye(na)]])
        rhs = np.concatenate([-q, b_act])
        try:
            sol = np.linalg.solve(KKT, rhs)
        except np.linalg.LinAlgError:
            return x
        x_p = sol[: self.nz]
        # Accept only if primal-feasible and not worse.
        Axp = A @ x_p
        feas = np.all(Axp >= lv - 1e-6) and np.all(Axp <= uv + 1e-6)
        if feas and q @ x_p <= q @ x + 1e-9:
            return x_p
        return x

    def _admm_batch(self, lv, uv, eps=1e-8, max_chunks=16, chunk_len=1500, warm=None, warm_chunks=2):
        """Batched ADMM across B problem instances sharing (A, q).

        lv/uv: [B, m].  One jitted program: per-lane adaptive rho with
        on-device KKT refactorization between chunks (no host round-trips).
        No per-lane polish -- accuracy is the ADMM tolerance (eps on
        scaled residuals).

        ``warm`` is a (x, z, y) device carry from a previous call (in the
        scaled space).  A warm call starts from that iterate -- but with a
        *fresh* rho (the adaptively-rebalanced rho from the previous solve
        turns out to converge far slower on the perturbed problem than
        restarting the rho schedule; measured 1e-3 vs 3e-6 primal residual
        after 2 warm chunks) -- runs only ``warm_chunks`` chunks, then
        checks the worst per-lane residual on host and falls back to a
        full ``max_chunks`` resume if any lane is worse than ``_warm_tol``.
        Returns (x [B, n] unscaled numpy, carry) -- hand the carry back in
        as ``warm`` on the next receding-horizon step.

        Runs under the scoped ``solver_x64`` context (like the banded
        backend's _admm_batch): the jitted program re-traces on the f64
        operands, so the flag is honored on this dense backend too.
        """
        with self._x64_ctx():
            return self._admm_batch_impl(
                lv, uv, eps=eps, max_chunks=max_chunks, chunk_len=chunk_len, warm=warm, warm_chunks=warm_chunks
            )

    def _admm_batch_impl(self, lv, uv, eps=1e-8, max_chunks=16, chunk_len=1500, warm=None, warm_chunks=2):
        ls = jnp.asarray(self._E[None, :] * lv)  # [B, m]
        us = jnp.asarray(self._E[None, :] * uv)
        m, n = self._As.shape
        Bsz = ls.shape[0]
        rho0 = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0)
        rho0 = jnp.asarray(np.broadcast_to(rho0, ls.shape), ls.dtype)
        if warm is None:
            x0 = jnp.zeros((Bsz, n), ls.dtype)
            z0 = jnp.clip(jnp.zeros((Bsz, m), ls.dtype), ls, us)
            y0 = jnp.zeros((Bsz, m), ls.dtype)
            chunks = max_chunks
        else:
            x0, z0, y0 = warm
            z0 = jnp.clip(z0, ls, us)
            chunks = warm_chunks
        x, z, y, rho, pri, dual = self._admm_batch_full(
            ls, us, x0, z0, y0, rho0, chunks, chunk_len, eps
        )
        if warm is not None:
            worst = float(np.max(np.asarray(jnp.maximum(pri, dual))))
            if not np.isfinite(worst):
                # A non-finite iterate poisons ADMM permanently (NaN
                # propagates through every subsequent matvec), so resuming
                # from it can never recover: restart the full budget from
                # the cold-start iterate with a fresh rho schedule.
                x0 = jnp.zeros((Bsz, n), ls.dtype)
                z0 = jnp.clip(jnp.zeros((Bsz, m), ls.dtype), ls, us)
                y0 = jnp.zeros((Bsz, m), ls.dtype)
                x, z, y, rho, pri, dual = self._admm_batch_full(
                    ls, us, x0, z0, y0, rho0, max_chunks, chunk_len, eps
                )
            elif worst > self._warm_tol:
                x, z, y, rho, pri, dual = self._admm_batch_full(
                    ls, us, x, z, y, rho, max_chunks, chunk_len, eps
                )
        return np.asarray(x) * self._D[None, :], (x, z, y)

    def _shift_warm_carry(self, carry):
        """Receding-horizon realignment of a scaled ADMM carry: stage s
        takes stage s+1's iterate (the plan the previous solve made for
        this wall-clock step), the last stage duplicates, and the duals are
        un-discounted by 1/gamma (stage s's objective weight is gamma^s, so
        the shifted multipliers were scaled for gamma^(s+1)).  The scaled
        space commutes with the shift because the Ruiz scales are
        stage-uniform (tiled per stage)."""
        import jax.numpy as _jnp

        N = self.planning_steps
        if N == 1:
            return carry

        x, z, y = carry
        # Banded carries are already stage-major [B, N, rows]; dense ones
        # are flat [B, N*rows] (or [N*rows] from the single-env path) with
        # stage-major row blocks (_build_lp builds rows per stage).
        if x.ndim == 3:
            xs = _jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)
            zs = _jnp.concatenate([z[:, 1:], z[:, -1:]], axis=1)
            ys = _jnp.concatenate([y[:, 1:], y[:, -1:]], axis=1) / self.gamma
            return (xs, zs, ys)

        def sh(a):
            shp = a.shape
            rows = shp[-1] // N
            a3 = _jnp.reshape(a, shp[:-1] + (N, rows))
            a3 = _jnp.concatenate([a3[..., 1:, :], a3[..., -1:, :]], axis=-2)
            return _jnp.reshape(a3, shp)

        return (sh(x), sh(z), sh(y) / self.gamma)

    @property
    def _warm_tol(self):
        """Residual acceptance threshold for warm-started batched solves, in
        the scaled space.  f32 cannot reach the f64 residual floor, so
        the bar is dtype-aware (checked host-side -- no eager device op);
        calibrated in tests/test_mpc.py (warm actions match cold solves to
        the tested 2e-2 MW after real receding-horizon steps; the DC-OPF is
        degenerate, so different optimal vertices can differ more than the
        residual tolerance suggests)."""
        return 5e-5 if jax.config.jax_enable_x64 else 5e-4

    def _polish_batch(self, X, carry, LV, UV):
        """Per-lane active-set polish of a batched solve (overridden by the
        banded backend with a sparse-KKT version that scales to feeder141
        horizon 20).  The dense fallback reuses ``_polish`` when the dense
        mirror exists."""
        if getattr(self, "A", None) is None:
            return X
        Zs, Ys = np.asarray(carry[1]), np.asarray(carry[2])
        Z = Zs.reshape(Zs.shape[0], -1) / self._E[None, :]
        Y = Ys.reshape(Ys.shape[0], -1) * self._E[None, :] / self._c
        out = np.array(X)
        tol = self._polish_act_tol
        for b in range(X.shape[0]):
            out[b] = self._polish(X[b], Z[b], Y[b], LV[b], UV[b], tol=tol)
        return out

    @property
    def _polish_act_tol(self):
        """Active-set detection tolerance for batched polishes: f32 ADMM
        stalls near ~5e-5 scaled residuals, so the f32 bar is looser than
        the f64 host path's 1e-6."""
        return 1e-6 if jax.config.jax_enable_x64 else 1e-4

    def solve_batch(
        self, load_forecasts, gen_forecasts, init_socs, warm_start=False, warm_shift=False,
        polish=False, sharding=None,
    ):
        """Solve the N-stage DC-OPF for a batch of B environment lanes.

        Parameters
        ----------
        load_forecasts : [B, n_load, N] (p.u.)
        gen_forecasts : [B, n_gen-1, N] (p.u.)
        init_socs : [B, n_des] (p.u.)

        Returns actions [B, action_n] in MW/MVAr (Q = 0), clipped to the
        action space.

        With ``warm_start=True`` the solver keeps the previous call's final
        ADMM iterate on device and starts the next solve from it -- in
        receding-horizon operation consecutive problems differ only in the
        forecast/SoC parameter rows, so warm calls converge in a fraction
        of the cold-start chunk budget (with an automatic full-budget
        fallback when the residual check fails, e.g. after a large state
        jump).  The carry is invalidated when the batch size changes.

        ``sharding`` (optional, a ``jax.sharding.Sharding`` over the lane
        axis, e.g. ``NamedSharding(mesh, P("dp"))``) places the assembled
        per-lane bounds on a device mesh before the ADMM solve: the lanes
        are independent, so the solver data-parallelizes with no
        collectives.  Call under ``jax.sharding.use_mesh(mesh)``.
        """
        load_forecasts = np.asarray(load_forecasts, dtype=float)
        gen_forecasts = np.asarray(gen_forecasts, dtype=float)
        init_socs = np.asarray(init_socs, dtype=float)
        Bsz = load_forecasts.shape[0]
        lv = np.tile(self.l, (Bsz, 1))
        uv = np.tile(self.u, (Bsz, 1))
        for r, kind, s, i in self.param_rows:
            if kind == "load_eq":
                lv[:, r] = uv[:, r] = load_forecasts[:, i, s]
            elif kind == "gen_cap":
                uv[:, r] = gen_forecasts[:, i, s]
            elif kind == "soc_init":
                lv[:, r] = uv[:, r] = init_socs[:, i]

        if sharding is not None:
            import jax

            lv = jax.device_put(lv, sharding)
            uv = jax.device_put(uv, sharding)
        warm = getattr(self, "_warm_carry", None)
        if not warm_start:
            warm = None
        elif warm is not None and warm[0].shape[0] != Bsz:
            warm = None
        if warm is not None and warm_shift:
            # Receding-horizon realignment (see _shift_warm_carry): stage s
            # starts from the plan the previous solve made for it.
            warm = self._shift_warm_carry(warm)
        x, carry = self._admm_batch(lv, uv, warm=warm)
        self._warm_carry = carry if warm_start else None
        if polish:
            # Mixed-precision accuracy mode: the device's f32 ADMM
            # identifies the active set, an exact float64 equality-
            # constrained KKT solve on the host recovers the LP vertex per
            # lane (the banded backend does this sparsely --
            # _polish_batch): reference (CVXPY/ECOS ~1e-8, reference
            # mpc.py:383) solution quality from a float32 solve.
            x = self._polish_batch(x, carry, lv, uv)
        # Full per-lane solutions for inspection / external-oracle
        # cross-checks (e.g. scripts/mpc_bench.py --verify): x [B, nz] with
        # the per-lane bounds actually solved against.
        self.last_batch_solution = {"x": x, "lv": lv, "uv": uv}
        o = self._off0
        P = x[:, o["P"] : o["P"] + self.n_dev]
        gp = [self.dev_id_mapping[d] for d in self.non_slack_gen_ids]
        dp = [self.dev_id_mapping[d] for d in self.des_ids]
        acts = np.concatenate(
            [
                P[:, gp] * self.baseMVA,
                np.zeros((Bsz, len(gp))),
                P[:, dp] * self.baseMVA,
                np.zeros((Bsz, len(dp))),
            ],
            axis=1,
        )
        return np.clip(acts, self.action_space.low, self.action_space.high)

    # ------------------------------------------------------------------
    def forecast(self, env):
        """Return (P_load_forecast [n_load, N], P_gen_forecast [n_gen-1, N])
        in p.u. -- implemented by subclasses (mpc.py:345-370)."""
        raise NotImplementedError()

    def act(self, env):
        """Solve the N-stage DC-OPF and return the stage-0 action
        (mpc.py:321-343)."""
        P_load_forecast, P_gen_forecast = self.forecast(env)
        a = self._solve(env.simulator, P_load_forecast, P_gen_forecast)
        return np.clip(a, self.action_space.low, self.action_space.high)

    def _solve(self, simulator, load_forecasts, gen_forecasts):
        lv, uv = self.l.copy(), self.u.copy()
        load_forecasts = np.asarray(load_forecasts, dtype=float)
        gen_forecasts = np.asarray(gen_forecasts, dtype=float)
        init_soc = np.array(
            [simulator.state["des_soc"]["pu"][i] for i in self.des_ids], dtype=float
        )
        for r, kind, s, i in self.param_rows:
            if kind == "load_eq":
                lv[r] = uv[r] = load_forecasts[i, s]
            elif kind == "gen_cap":
                uv[r] = gen_forecasts[i, s]
            elif kind == "soc_init":
                lv[r] = uv[r] = init_soc[i]

        warm = self._act_carry if self.warm_start else None
        if warm is not None and self.warm_shift:
            warm = self._shift_warm_carry(warm)
        x, z, y, carry = self._admm(lv, uv, warm=warm)
        self._act_carry = carry if self.warm_start else None
        x = self._polish(x, z, y, lv, uv)

        # Expose the full solution for inspection/tests (the reference
        # exposes the CVXPY variables, mpc.py:196-198).
        S = self.stage_size
        nb, nd, ndes, nbr = self.n_bus, self.n_dev, self.n_des, self.n_branch
        self.last_solution = {
            "x": x,
            "lv": lv,
            "uv": uv,
            "theta": [x[s * S : s * S + nb] for s in range(self.planning_steps)],
            "P_dev": [x[s * S + nb : s * S + nb + nd] for s in range(self.planning_steps)],
            "soc": [
                x[s * S + nb + nd + 2 * ndes : s * S + nb + nd + 3 * ndes]
                for s in range(self.planning_steps)
            ],
        }

        o = self._off0
        P = x[o["P"] : o["P"] + self.n_dev]
        P_gen = [P[self.dev_id_mapping[d]] * self.baseMVA for d in self.non_slack_gen_ids]
        Q_gen = [0.0] * len(P_gen)
        P_des = [P[self.dev_id_mapping[d]] * self.baseMVA for d in self.des_ids]
        Q_des = [0.0] * len(P_des)
        return np.concatenate((P_gen, Q_gen, P_des, Q_des))
