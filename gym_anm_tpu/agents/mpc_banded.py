"""Stage-banded MPC DC-OPF solver: the scalable backend.

The dense backend (:mod:`gym_anm_tpu.agents.mpc`) assembles the N-stage
DC-OPF as one dense LP ``A [m, N*S]`` -- O((N*S)^2) memory/compute, which
collapses at long horizons (reference CI exercises horizon 20,
/root/reference/tests/test_dcopf_agent.py:57) and at feeder141 scale
(S ~ 900 per stage).  This module exploits the LP's *stage-banded*
structure instead:

* every stage has the same row/column pattern -- one shared pair
  ``A_diag [M, S]`` (stage-s rows on stage-s variables) and ``A_sub [M, S]``
  (stage-s rows on stage-(s-1) variables; only the SoC-recursion rows,
  mpc.py:281-295, are nonzero there, and stage 0 has no sub part) --
  so ``A z`` and ``A^T y`` are batched ``[M, S]`` einsums over an ``[B, N]``
  grid, never a dense ``[m, N*S]`` matmul;
* the ADMM KKT matrix ``sigma*I + A^T diag(rho) A`` is block tridiagonal
  with ``[S, S]`` stage blocks; it is factorized by a *block-Thomas LDL^T*
  (one ``lax.scan`` over stages with batched Cholesky-based block
  inversions) and each ADMM iteration solves it with two O(N) scan sweeps
  of batched ``[B, S, S] @ [B, S]`` matvecs -- explicit block inverses, not
  per-element substitution, so the inner loop stays batched matvecs (the same
  lesson as the dense backend's explicit KKT inverse).

Per-iteration cost drops from O((N*S)^2) to O(N*(M*S + S^2)) and memory
from O((N*S)^2) to O(N*S^2), making horizon 20 and the 141-bus network
practical.  Accuracy machinery (Ruiz equilibration, per-lane adaptive rho
with on-device refactorization, warm starts, optional dense active-set
polish for small problems) mirrors the dense backend and the two agree to
solver tolerance (tests/test_mpc_banded.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .mpc import MPCAgent, _trace_highest
from .mpc_constant import MPCAgentConstant
from .mpc_perfect import MPCAgentPerfect


class MPCAgentBanded(MPCAgent):
    """`MPCAgent` with the stage-banded solver backend (same public API)."""

    #: run the dense active-set polish only while N*S stays small (its KKT
    #: solve is O((nz + n_active)^3)); beyond it, accuracy is the ADMM
    #: residual tolerance.
    POLISH_MAX_NZ = 2048
    #: build the dense (A, l, u) mirror -- needed only for the polish -- up
    #: to a larger, memory-bound limit.  Constraint inspection at any scale
    #: goes through :meth:`apply_A_host` / :meth:`sparse_A` instead (e.g.
    #: feeder141 horizon 20, nz = 9100 -- tests/test_mpc_banded.py).
    MIRROR_MAX_NZ = 4096
    #: share of the device's memory (``memory_stats()["bytes_limit"]``) one
    #: ADMM batch program may plan for: the block-Thomas factors are
    #: 2 x [B, N, S, S] plus comparable temporaries (~16 N S^2 values per
    #: lane).  Larger batches are split into power-of-two lane chunks
    #: solved sequentially; a device that reports no limit is not split.
    DEVICE_MEMORY_SHARE = 0.5

    # ------------------------------------------------------------------
    # Banded LP assembly (host numpy, once).
    # ------------------------------------------------------------------
    def _build_lp(self):
        spec = self.spec
        nb, nd, ndes, nbr = self.n_bus, self.n_dev, self.n_des, self.n_branch
        N = self.planning_steps
        S = nb + nd + 3 * ndes + nbr  # stage width (theta, P, pch, pdis, soc, t)
        self.stage_size = S
        self.nz = N * S

        o_theta = 0
        o_P = nb
        o_pch = nb + nd
        o_pdis = nb + nd + ndes
        o_soc = nb + nd + 2 * ndes
        o_t = nb + nd + 3 * ndes
        self._off0 = dict(theta=o_theta, P=o_P, pch=o_pch, pdis=o_pdis, soc=o_soc, t=o_t)

        dev_pos = self.dev_id_mapping
        bus_pos = self.bus_id_mapping
        load_pos = [dev_pos[i] for i in self.load_ids]
        gen_pos = [dev_pos[i] for i in self.non_slack_gen_ids]
        des_pos = [dev_pos[i] for i in self.des_ids]
        srt = np.asarray(spec.bus_sorted)
        inv = np.empty_like(srt)
        inv[srt] = np.arange(len(srt))
        dev_bus_sorted = inv[np.asarray(spec.dev_bus)]

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

        rows_d, rows_s, lo, hi = [], [], [], []
        # (stage-local row index, kind, local index); kinds as in the dense
        # backend, but stage-generic ("load_eq"/"gen_cap" repeat per stage,
        # "soc_init" applies to stage 0 only).
        self.stage_param_rows = []

        def add_row(d_cols, d_vals, l, u, s_cols=(), s_vals=()):
            rd = np.zeros(S)
            for c, v in zip(d_cols, d_vals):
                rd[c] += v
            rs = np.zeros(S)
            for c, v in zip(s_cols, s_vals):
                rs[c] += v
            rows_d.append(rd)
            rows_s.append(rs)
            lo.append(l)
            hi.append(u)
            return len(rows_d) - 1

        # R1: DC flow balance per bus (mpc.py:241-253).
        for i_pos in range(nb):
            cols, vals = [], []
            for (f, t) in self.branch_ids:
                j, k = bus_pos[f], bus_pos[t]
                if j == i_pos:
                    cols += [o_theta + j, o_theta + k]
                    vals += [B[j, k], -B[j, k]]
                elif k == i_pos:
                    cols += [o_theta + k, o_theta + j]
                    vals += [B[k, j], -B[k, j]]
            for d_idx in range(nd):
                if dev_bus_sorted[d_idx] == i_pos:
                    cols.append(o_P + d_idx)
                    vals.append(-1.0)
            add_row(cols, vals, 0.0, 0.0)

        # R2: loads pinned to forecast (param per stage).
        for li, p in enumerate(load_pos):
            r = add_row([o_P + p], [1.0], 0.0, 0.0)
            self.stage_param_rows.append((r, "load_eq", li))

        # R3/R5: gen box + potential cap (param u per stage).
        for gi, p in enumerate(gen_pos):
            add_row([o_P + p], [1.0], P_gen_min[gi], P_gen_max[gi])
            r = add_row([o_P + p], [1.0], -np.inf, np.inf)
            self.stage_param_rows.append((r, "gen_cap", gi))

        # R4: storage box.
        for di, p in enumerate(des_pos):
            add_row([o_P + p], [1.0], P_des_min[di], P_des_max[di])

        # R6: P_des = p_dis - p_ch (mpc.py:291).
        for di, p in enumerate(des_pos):
            add_row([o_P + p, o_pdis + di, o_pch + di], [1.0, -1.0, 1.0], 0.0, 0.0)

        # R7: SoC recursion (mpc.py:281-295).  A_sub carries the -soc_{s-1}
        # coupling; at stage 0 the sub part is masked off and the bound is
        # the soc_init parameter instead of 0.
        for di in range(ndes):
            r = add_row(
                [o_soc + di, o_pch + di, o_pdis + di],
                [1.0, -self.delta_t * eff[di], self.delta_t / eff[di]],
                0.0,
                0.0,
                s_cols=[o_soc + di],
                s_vals=[-1.0],
            )
            self.stage_param_rows.append((r, "soc_init", di))

        # R8: SoC box.
        for di in range(ndes):
            add_row([o_soc + di], [1.0], soc_min[di], soc_max[di])

        # R9: theta box (mpc.py:297-299).
        for i_pos in range(nb):
            add_row([o_theta + i_pos], [1.0], -np.pi, np.pi)

        # R10: slack angle = 0 (device-position quirk, mpc.py:302).
        add_row([o_theta + self.dev_id_mapping[self.slack_dev_id]], [1.0], 0.0, 0.0)

        # R11: branch-overflow slacks.
        for bi, (f, t) in enumerate(self.branch_ids):
            j, k = bus_pos[f], bus_pos[t]
            c = B[j, k]
            u_b = beta * rates[bi] if np.isfinite(rates[bi]) else np.inf
            add_row([o_theta + j, o_theta + k, o_t + bi], [c, -c, -1.0], -np.inf, u_b)
            add_row([o_theta + j, o_theta + k, o_t + bi], [-c, c, -1.0], -np.inf, u_b)

        # R12: nonnegativity of t, p_ch, p_dis.
        for bi in range(nbr):
            add_row([o_t + bi], [1.0], 0.0, np.inf)
        for di in range(ndes):
            add_row([o_pch + di], [1.0], 0.0, np.inf)
            add_row([o_pdis + di], [1.0], 0.0, np.inf)

        self.A_diag = np.asarray(rows_d)  # [M, S]
        self.A_sub = np.asarray(rows_s)  # [M, S]
        self.l_stage = np.asarray(lo)  # [M]
        self.u_stage = np.asarray(hi)
        self.M_rows = self.A_diag.shape[0]
        self.m = N * self.M_rows

        # Per-stage objective (mpc.py:304-314): q[s] = gamma^s * q_stage.
        q_stage = np.zeros(S)
        nonrer_gen_pos = [dev_pos[g] for g in self.gen_ids if g not in self.gen_rer_ids]
        for p in nonrer_gen_pos:
            q_stage[o_P + p] += 1.0
        for bi in range(nbr):
            q_stage[o_t + bi] += self.lamb
        self.q_stage = q_stage
        gammas = self.gamma ** np.arange(N)
        self.q = (gammas[:, None] * q_stage[None, :]).reshape(-1)  # dense mirror

        # Dense mirrors of A/l/u for the polish + inspection tests, only
        # while small (MIRROR_MAX_NZ); large problems skip them.
        if self.nz <= self.MIRROR_MAX_NZ:
            A = np.zeros((self.m, self.nz))
            for s in range(N):
                r0 = s * self.M_rows
                A[r0 : r0 + self.M_rows, s * S : (s + 1) * S] = self.A_diag
                if s > 0:
                    A[r0 : r0 + self.M_rows, (s - 1) * S : s * S] = self.A_sub
            self.A = A
        else:
            self.A = None
        self.l = np.tile(self.l_stage, N)
        self.u = np.tile(self.u_stage, N)

        # Dense-layout param hooks (row index in the stacked [N*M] order) so
        # act()/solve_batch parameter writing is shared with the dense
        # backend's convention.
        self.param_rows = []
        for s in range(N):
            for r, kind, i in self.stage_param_rows:
                if kind == "soc_init" and s > 0:
                    continue  # s>0 recursion rows keep their (0, 0) bound
                self.param_rows.append((s * self.M_rows + r, kind, s, i))

    # ------------------------------------------------------------------
    # Banded ADMM solver.
    # ------------------------------------------------------------------
    def _build_solver(self, rho=0.1, sigma=1e-6, alpha=1.6, iters=1500):
        Ad, As = self.A_diag, self.A_sub
        M, S = Ad.shape
        N = self.planning_steps

        # Ruiz equilibration on the stacked [M, 2S] stage template: row
        # scales E (shared by every stage's row block) and column scales D
        # (shared by every stage's variable block), preserving the banded
        # structure exactly.
        D = np.ones(S)
        E = np.ones(M)
        Ads, Ass = Ad.copy(), As.copy()
        for _ in range(15):
            stacked = np.abs(np.concatenate([Ads, Ass], axis=1))
            r = np.sqrt(np.maximum(stacked.max(axis=1), 1e-8))
            Ads /= r[:, None]
            Ass /= r[:, None]
            E /= r
            c = np.sqrt(np.maximum(np.maximum(np.abs(Ads).max(axis=0), np.abs(Ass).max(axis=0)), 1e-8))
            Ads /= c[None, :]
            Ass /= c[None, :]
            D /= c
        self._D_stage, self._E_stage = D, E
        # Dense-layout scale mirrors (used by solve_batch/_admm plumbing).
        self._D = np.tile(D, N)
        self._E = np.tile(E, N)

        gammas = self.gamma ** np.arange(N)
        qs_stage = (gammas[:, None] * (D * self.q_stage)[None, :])  # [N, S] scaled
        cost_norm = max(np.abs(qs_stage).max(), 1e-6)
        self._c = 1.0 / cost_norm
        qs_stage = qs_stage * self._c

        self._eq_rows = (self.l == self.u) & np.isfinite(self.l)
        self._rho0 = rho
        self._sigma = sigma
        self._alpha = alpha
        self._chunk_iters = iters

        # Host numpy templates: converted with jnp.asarray only INSIDE the
        # traced program below, so they fold as constants in the ambient
        # dtype (f32, or f64 under the scoped solver_x64 context) without a
        # device->host copy at lowering time (docs/quirks.md #7).
        Ad_np = np.asarray(Ads)  # [M, S] scaled
        As_np = np.asarray(Ass)
        q_np = np.asarray(qs_stage)  # [N, S]

        def admm_batch_full(ls, us, x0, z0, y0, rho0, n_chunks, chunk_len, eps):
            """Banded analog of the dense backend's fully on-device batched
            ADMM (mpc.py): chunks of fixed iterations, per-lane adaptive rho
            with on-device refactorization between chunks."""
            dt = ls.dtype
            Adj = jnp.asarray(Ad_np, dt)
            Asj = jnp.asarray(As_np, dt)
            qj = jnp.asarray(q_np, dt)
            eyeS = jnp.eye(S, dtype=dt)

            def apply_A(x):  # x [B, N, S] -> [B, N, M]
                y = jnp.einsum("ms,bns->bnm", Adj, x)
                y = y.at[:, 1:, :].add(jnp.einsum("ms,bns->bnm", Asj, x[:, :-1, :]))
                return y

            def apply_AT(y):  # y [B, N, M] -> [B, N, S]
                x = jnp.einsum("ms,bnm->bns", Adj, y)
                x = x.at[:, :-1, :].add(jnp.einsum("ms,bnm->bns", Asj, y[:, 1:, :]))
                return x

            def factor(rho_):  # rho_ [B, N, M] -> (Msub, Dinv) each [B, N, S, S]
                # Block-tridiagonal K: D_s = sigma*I + Ad^T R_s Ad (+ As^T
                # R_{s+1} As for s < N-1); F_s = Ad^T R_s As for s >= 1.
                Dblk = sigma * eyeS[None, None] + jnp.einsum("mi,bnm,mj->bnij", Adj, rho_, Adj)
                if N > 1:
                    Dblk = Dblk.at[:, :-1].add(jnp.einsum("mi,bnm,mj->bnij", Asj, rho_[:, 1:], Asj))
                    Fblk = jnp.einsum("mi,bnm,mj->bnij", Adj, rho_[:, 1:], Asj)  # [B, N-1, S, S]
                else:
                    Fblk = jnp.zeros((rho_.shape[0], 0, S, S), rho_.dtype)

                def inv_spd(K):  # [B, S, S] -> [B, S, S] via Cholesky
                    L = jnp.linalg.cholesky(K)
                    eyeB = jnp.broadcast_to(eyeS, K.shape)
                    h = jax.scipy.linalg.solve_triangular(L, eyeB, lower=True)
                    return jax.scipy.linalg.solve_triangular(jnp.swapaxes(L, -1, -2), h, lower=False)

                # Block-Thomas LDL^T: Dt_s = D_s - M_s F_s^T, M_s = F_s Dinv_{s-1}.
                def step(Dinv_prev, blocks):
                    Db, Fb = blocks  # [B, S, S] each
                    Msub = jnp.einsum("bij,bjk->bik", Fb, Dinv_prev)
                    Dt = Db - jnp.einsum("bij,bkj->bik", Msub, Fb)
                    Dinv = inv_spd(Dt)
                    return Dinv, (Msub, Dinv)

                Dinv0 = inv_spd(Dblk[:, 0])
                if N > 1:
                    _, (Msub_rest, Dinv_rest) = jax.lax.scan(
                        step, Dinv0, (jnp.swapaxes(Dblk[:, 1:], 0, 1), jnp.swapaxes(Fblk, 0, 1))
                    )
                    Msub = jnp.concatenate(
                        [jnp.zeros_like(Dinv0)[None], Msub_rest], axis=0
                    )  # [N, B, S, S]
                    Dinv = jnp.concatenate([Dinv0[None], Dinv_rest], axis=0)
                else:
                    Msub = jnp.zeros_like(Dinv0)[None]
                    Dinv = Dinv0[None]
                return Msub, Dinv  # stage-major [N, B, S, S]

            def kkt_solve(Msub, Dinv, b):  # b [B, N, S] -> x [B, N, S]
                bT = jnp.swapaxes(b, 0, 1)  # [N, B, S]

                def fwd(w_prev, xs):
                    Ms, bs = xs
                    w = bs - jnp.einsum("bij,bj->bi", Ms, w_prev)
                    return w, w

                w0 = jnp.zeros_like(bT[0])
                _, w = jax.lax.scan(fwd, w0, (Msub, bT))
                v = jnp.einsum("nbij,nbj->nbi", Dinv, w)

                def bwd(x_next, xs):
                    Ms_next, vs = xs  # Ms_next = Msub[s+1]
                    x = vs - jnp.einsum("bji,bj->bi", Ms_next, x_next)
                    return x, x

                if N > 1:
                    xN = v[-1]
                    _, x_rest = jax.lax.scan(
                        bwd, xN, (Msub[1:][::-1], v[:-1][::-1])
                    )
                    x = jnp.concatenate([x_rest[::-1], xN[None]], axis=0)
                else:
                    x = v
                return jnp.swapaxes(x, 0, 1)  # [B, N, S]

            def chunk(carry, _):
                x, z, y, rho_ = carry  # x [B,N,S]; z/y/rho [B,N,M]
                Msub, Dinv = factor(rho_)

                def body(c, _):
                    x, z, y = c
                    b = sigma * x - qj[None] + apply_AT(rho_ * z - y)
                    x_new = kkt_solve(Msub, Dinv, b)
                    Ax = apply_A(x_new)
                    z_t = alpha * Ax + (1 - alpha) * z
                    z_new = jnp.clip(z_t + y / rho_, ls, us)
                    y_new = y + rho_ * (z_t - z_new)
                    return (x_new, z_new, y_new), None

                (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=chunk_len)
                Ax = apply_A(x)
                pri = jnp.max(jnp.abs(Ax - z), axis=(1, 2))  # [B]
                dual = jnp.max(jnp.abs(qj[None] + apply_AT(y) + sigma * x), axis=(1, 2))
                ratio = jnp.sqrt(jnp.maximum(pri, 1e-16) / jnp.maximum(dual, 1e-16))
                ratio = jnp.clip(ratio, 1e-2, 1e2)
                conv = (pri < eps) & (dual < eps)
                rebal = (~conv) & ((ratio < 0.5) | (ratio > 2.0))
                rho_ = jnp.where(rebal[:, None, None], jnp.clip(rho_ * ratio[:, None, None], 1e-6, 1e6), rho_)
                return (x, z, y, rho_), (pri, dual)

            (x, z, y, rho_), (pri, dual) = jax.lax.scan(chunk, (x0, z0, y0, rho0), None, length=n_chunks)
            return x, z, y, rho_, pri[-1], dual[-1]

        self._admm_batch_full_banded = jax.jit(_trace_highest(admm_batch_full), static_argnums=(6, 7, 8))

    # ------------------------------------------------------------------
    def _admm_batch(self, lv, uv, eps=1e-8, max_chunks=16, chunk_len=None, warm=None, warm_chunks=2):
        """Banded drop-in for the dense backend's `_admm_batch`: same
        dense-layout [B, m] bounds in, [B, nz] unscaled solution out."""
        if chunk_len is None:
            chunk_len = self._chunk_iters
        N, M, S = self.planning_steps, self.M_rows, self.stage_size
        Bsz = lv.shape[0]

        # Memory guard: split over-budget batches into lane chunks (each
        # chunk is an independent set of lanes; results concatenate exactly).
        import jax as _jax

        x64 = self.solver_x64 or _jax.config.jax_enable_x64
        limit = (_jax.devices()[0].memory_stats() or {}).get("bytes_limit")
        b_chunk = Bsz
        if limit:
            per_lane_bytes = 16 * N * S * S * (8 if x64 else 4)
            b_chunk = max(1, int(self.DEVICE_MEMORY_SHARE * limit // per_lane_bytes))
            b_chunk = 1 << (b_chunk.bit_length() - 1)  # power of two: stable compiles
        if Bsz > b_chunk:
            outs, carries = [], []
            for i in range(0, Bsz, b_chunk):
                w = None if warm is None else tuple(wv[i : i + b_chunk] for wv in warm)
                xd, c = self._admm_batch(
                    lv[i : i + b_chunk],
                    uv[i : i + b_chunk],
                    eps=eps,
                    max_chunks=max_chunks,
                    chunk_len=chunk_len,
                    warm=w,
                    warm_chunks=warm_chunks,
                )
                outs.append(xd)
                carries.append(c)
            x_dense = np.concatenate(outs, axis=0)
            carry = tuple(jnp.concatenate([c[j] for c in carries], axis=0) for j in range(3))
            return x_dense, carry

        with self._x64_ctx():
            ls = jnp.asarray((self._E[None, :] * lv).reshape(Bsz, N, M))
            us = jnp.asarray((self._E[None, :] * uv).reshape(Bsz, N, M))
            rho0 = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0).reshape(1, N, M)
            rho0 = jnp.asarray(np.broadcast_to(rho0, (Bsz, N, M)), ls.dtype)

            def run_budget(x, z, y, rho_, n_chunks):
                return self._admm_batch_full_banded(ls, us, x, z, y, rho_, n_chunks, chunk_len, eps)

            if warm is None:
                x0 = jnp.zeros((Bsz, N, S), ls.dtype)
                z0 = jnp.clip(jnp.zeros((Bsz, N, M), ls.dtype), ls, us)
                y0 = jnp.zeros((Bsz, N, M), ls.dtype)
                x, z, y, rho_, pri, dual = run_budget(x0, z0, y0, rho0, max_chunks)
            else:
                x0, z0, y0 = warm
                z0 = jnp.clip(z0, ls, us)
                x, z, y, rho_, pri, dual = run_budget(x0, z0, y0, rho0, warm_chunks)
                worst = float(np.max(np.asarray(jnp.maximum(pri, dual))))
                if not np.isfinite(worst):
                    # Restart cold with a fresh rho (NaN iterates never recover).
                    x0 = jnp.zeros((Bsz, N, S), ls.dtype)
                    z0 = jnp.clip(jnp.zeros((Bsz, N, M), ls.dtype), ls, us)
                    y0 = jnp.zeros((Bsz, N, M), ls.dtype)
                    x, z, y, rho_, pri, dual = run_budget(x0, z0, y0, rho0, max_chunks)
                elif worst > self._warm_tol:
                    x, z, y, rho_, pri, dual = run_budget(x, z, y, rho_, max_chunks)
            x_dense = np.asarray(x).reshape(Bsz, N * S) * self._D[None, :]
            return x_dense, (x, z, y)

    def _admm(self, lv, uv, eps=1e-9, max_chunks=12, warm=None):
        """Single-instance host path: one-lane banded solve with the dense
        backend's host-side chunk loop and early exit (a typical DC-OPF
        converges in 1-2 chunks; running the full budget in one program
        would cost ~10x the wall time per ``act()``).  ``warm`` is a
        scaled-space stage-major (x, z, y) carry (the 4th return value);
        near-optimal warm points exit after their first chunk."""
        N, M, S = self.planning_steps, self.M_rows, self.stage_size
        with self._x64_ctx():
            ls = jnp.asarray((self._E * lv).reshape(1, N, M))
            us = jnp.asarray((self._E * uv).reshape(1, N, M))
            rho = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0).reshape(1, N, M)
            rho = jnp.asarray(rho, ls.dtype)
            if warm is not None and all(np.all(np.isfinite(np.asarray(v))) for v in warm):
                x = jnp.asarray(np.asarray(warm[0], dtype=float).reshape(1, N, S), ls.dtype)
                z = jnp.clip(jnp.asarray(np.asarray(warm[1], dtype=float).reshape(1, N, M), ls.dtype), ls, us)
                y = jnp.asarray(np.asarray(warm[2], dtype=float).reshape(1, N, M), ls.dtype)
            else:
                x = jnp.zeros((1, N, S), ls.dtype)
                z = jnp.clip(jnp.zeros((1, N, M), ls.dtype), ls, us)
                y = jnp.zeros((1, N, M), ls.dtype)
            prev = np.inf
            for _ in range(max_chunks):
                x, z, y, rho, pri, dual = self._admm_batch_full_banded(
                    ls, us, x, z, y, rho, 1, self._chunk_iters, eps
                )
                worst = float(np.max(np.asarray(jnp.maximum(pri, dual))))
                # Converged, or stalled at the float64 residual floor below any
                # meaningful tolerance -- the active-set polish recovers the
                # exact vertex from there (verified bit-equal to the dense
                # backend's solutions in tests/test_mpc_banded.py).
                if worst < eps or (worst < 1e-6 and worst > 0.5 * prev):
                    break
                prev = worst
            x_dense = np.asarray(x).reshape(N * S) * self._D
            # Unscale to the dense backend's (x, z, y) convention for _polish.
            z_d = np.asarray(z).reshape(N * M) / self._E
            y_d = np.asarray(y).reshape(N * M) * self._E / self._c
            carry = (
                np.asarray(x).reshape(N * S),
                np.asarray(z).reshape(N * M),
                np.asarray(y).reshape(N * M),
            )
            return x_dense, z_d, y_d, carry

    def _polish(self, x, z, y, lv, uv, tol=1e-6):
        if self.A is None or self.nz > self.POLISH_MAX_NZ:
            return x  # too large for the dense active-set polish
        return super()._polish(x, z, y, lv, uv, tol=tol)

    #: add/drop refinement rounds of the sparse-KKT polish.  The f32 ADMM
    #: active-set guess both misses rows (its residual floor is ~5e-5
    #: scaled) and marks spurious ones; a single-shot KKT on that guess is
    #: usually either infeasible or suboptimal and gets rejected, leaving
    #: the raw ~1-2% f32 objective gap (measured at feeder141 h5/h20).  Each
    #: round bulk-adds the rows the trial vertex violates and -- only at a
    #: feasible iterate -- releases ONE active row with the worst
    #: wrong-signed multiplier (bulk drops were measured to underdetermine
    #: the set and diverge); lanes settle well within this cap (p100 = 13
    #: over the calibration batch, tests/data/polish_calib_feeder141.npz).
    POLISH_REFINE_ITERS = 40

    def _polish_batch(self, X, carry, LV, UV):
        """Sparse-KKT active-set polish with add/drop refinement, per lane,
        on the host in float64.

        The mixed-precision accuracy mode for large problems: the device's
        f32 ADMM proposes each lane's active constraint set (to its
        ~5e-5-scaled residual floor), then an equality-constrained KKT
        system on those rows -- assembled SPARSELY from the banded stage
        blocks, so it scales to feeder141 horizon 20 where the dense
        mirror/polish cannot exist -- is solved exactly in f64 with
        scipy's sparse LU.  Because the f32 guess is imperfect, the active
        set is refined: rows the trial vertex violates join the set, active
        inequality rows whose KKT multiplier has the wrong sign (lower
        bounds need nu <= 0, upper bounds nu >= 0 under the convention
        ``q + A_act' nu = 0``) leave it, one per round (the worst
        offender: bulk drops underdetermine the set and diverge), and only
        at a primal-feasible iterate.  Each KKT solve gets two steps of
        iterative refinement against the UNregularized system (reusing the
        LU factors): without them the delta-regularization residual
        ``delta * nu`` (~1e-7 on rows with |nu| ~ 1e2) leaks through the
        active constraints and the "vertex" undercuts the true optimum by
        up to ~0.7% objective (measured round 5); with them the active
        rows hold to f64 round-off, so a feasible iterate whose wrong-sign
        set is empty is a genuine KKT certificate.  The BEST primal-
        feasible iterate is returned (never the raw ADMM point when a
        feasible iterate exists): the slightly infeasible f32 ADMM point
        can undercut the true optimum, so objective comparisons against it
        would veto exact solutions.  An iterate whose active rows cannot
        be satisfied (refined residual > 1e-6: the add path assembled an
        inconsistent set) aborts the loop, keeping the best candidate.
        DC-OPF degeneracy means a polished lane may land on a different
        optimal vertex than HiGHS, but the objective matches the LP
        optimum to solver precision (the quantity scripts/mpc_bench.py
        --verify measures: <=1e-11 relative over the round-5 calibration
        batch at feeder141 h5).
        """
        from scipy import sparse
        from scipy.sparse.linalg import splu

        A = self.sparse_A()
        q = self.q
        tol = self._polish_act_tol
        Zs, Ys = np.asarray(carry[1], dtype=np.float64), np.asarray(carry[2], dtype=np.float64)
        Bsz = X.shape[0]
        Z = Zs.reshape(Bsz, -1) / self._E[None, :]
        Y = Ys.reshape(Bsz, -1) * self._E[None, :] / self._c
        out = np.array(X, dtype=np.float64)
        delta = 1e-9
        feas_tol, dual_tol = 1e-8, 1e-8
        eyen = sparse.identity(self.nz, format="csr")
        for b in range(Bsz):
            x, z, y, lv, uv = out[b], Z[b], Y[b], LV[b], UV[b]
            eq = (lv == uv) & np.isfinite(lv)
            act_u = (z >= uv - tol) & (y > tol / 10) & ~eq
            act_l = (z <= lv + tol) & (y < -tol / 10) & ~eq & ~act_u
            best_obj = np.inf
            for _ in range(self.POLISH_REFINE_ITERS):
                act = act_l | act_u | eq
                if not np.any(act):
                    break
                A_act = A[act]
                b_act = np.where(act_u[act], uv[act], lv[act])
                na = A_act.shape[0]
                KKT = sparse.bmat(
                    [[delta * eyen, A_act.T], [A_act, -delta * sparse.identity(na, format="csr")]],
                    format="csc",
                )
                try:
                    lu = splu(KKT)
                    sol = lu.solve(np.concatenate([-q, b_act]))
                    for _r in range(2):
                        # Iterative refinement toward the delta -> 0 KKT
                        # system (factorization reused): the residual rhs
                        # cancels the systematic delta*nu leak, putting
                        # active-row residuals at f64 round-off.
                        x_p, nu = sol[: self.nz], sol[self.nz :]
                        r1 = -q - A_act.T @ nu
                        r2 = b_act - A_act @ x_p
                        sol = sol + lu.solve(np.concatenate([r1, r2]))
                except Exception:
                    break
                x_p, nu = sol[: self.nz], sol[self.nz :]
                if not np.all(np.isfinite(x_p)):
                    break
                if np.max(np.abs(b_act - A_act @ x_p)) > 1e-6:
                    # The active set became inconsistent (no x satisfies
                    # the forced equalities, so the refined residual stays
                    # large): adds/drops harvested from this trial would be
                    # garbage.  Stop and keep the best candidate so far.
                    break
                Axp = self.apply_A_host(x_p)
                viol_l = Axp < lv - feas_tol
                viol_u = Axp > uv + feas_tol
                primal_ok = not (np.any(viol_l) or np.any(viol_u))
                obj = q @ x_p
                if primal_ok and obj < best_obj:
                    # Best feasible iterate to date: accepted regardless of
                    # the ADMM objective (the slightly infeasible f32 point
                    # can undercut the true optimum -- comparing against it
                    # would veto exact solutions).
                    best_obj = obj
                    out[b] = x_p
                if not primal_ok:
                    # Restore primal feasibility first: bulk-add violated
                    # rows at their violated side; never drop while
                    # infeasible (drops at infeasible iterates were the
                    # measured divergence mode).
                    add_u = viol_u & ~act
                    add_l = viol_l & ~act & ~add_u
                    if not (np.any(add_u) or np.any(add_l)):
                        break  # violated rows already active: dead end
                    act_u = act_u | add_u
                    act_l = act_l | add_l
                    continue
                # Feasible: release the single worst wrong-signed active
                # inequality row (nu is ordered like act's True rows).
                nu_full = np.zeros(A.shape[0])
                nu_full[act] = nu
                wrong = np.where(act_u & (nu_full < -dual_tol), -nu_full, 0.0)
                wrong = wrong + np.where(act_l & (nu_full > dual_tol), nu_full, 0.0)
                if wrong.max() <= 0.0:
                    break  # KKT certificate: primal- and dual-feasible
                r = int(np.argmax(wrong))
                act_u[r] = False
                act_l[r] = False
        return out

    # ------------------------------------------------------------------
    # Scale-independent constraint inspection (no dense mirror needed).
    # ------------------------------------------------------------------
    def apply_A_host(self, x):
        """Host-numpy ``A @ x`` from the banded stage blocks -- valid at any
        problem size (the dense mirror stops at ``MIRROR_MAX_NZ``, so
        constraint checks past that scale -- e.g. feeder141 horizon 20 --
        go through this instead)."""
        N, S, M = self.planning_steps, self.stage_size, self.M_rows
        xs = np.asarray(x, dtype=np.float64).reshape(N, S)
        y = xs @ np.asarray(self.A_diag, dtype=np.float64).T  # [N, M]
        if N > 1:
            y[1:] += xs[:-1] @ np.asarray(self.A_sub, dtype=np.float64).T
        return y.reshape(-1)

    def sparse_A(self):
        """The full constraint matrix as ``scipy.sparse`` (block bi-diagonal
        assembly of ``A_diag``/``A_sub``) for external LP oracles (HiGHS via
        ``scipy.optimize.linprog``) at sizes where the dense mirror is
        memory-infeasible."""
        from scipy import sparse

        N = self.planning_steps
        Ad = sparse.csr_matrix(self.A_diag)
        As = sparse.csr_matrix(self.A_sub)
        blocks = [[None] * N for _ in range(N)]
        for s in range(N):
            blocks[s][s] = Ad
            if s > 0:
                blocks[s][s - 1] = As
        return sparse.bmat(blocks, format="csr")


class MPCAgentConstantBanded(MPCAgentConstant, MPCAgentBanded):
    """Constant-forecast policy on the stage-banded solver backend."""


class MPCAgentPerfectBanded(MPCAgentPerfect, MPCAgentBanded):
    """Perfect-forecast policy on the stage-banded solver backend."""
