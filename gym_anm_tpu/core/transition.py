"""The pure-functional physics transition.

JAX equivalent of ``Simulator.transition`` (simulator.py:464-537) and
``Simulator.reset`` (simulator.py:225-293):

1. map requested device set-points onto feasible (P, Q) injections
   (loads: clip + Q/P ratio, devices.py:156-167; generators/storage: exact
   polytope projection replacing the per-device CVXPY QPs,
   devices.py:280-304 / 472-522),
2. update storage SoC (devices.py:524-545),
3. aggregate bus injections (simulator.py:539-549) via a static incidence
   matmul,
4. solve the AC power flow with batched all-real Newton-Raphson
   (solve_load_flow.py:7-81),
5. recover slack/bus/branch electrical quantities,
6. compute the energy-loss + constraint-penalty reward
   (simulator.py:638-683).

Everything is a pure function of ``(GridSpec, inputs)`` -> ``SimState``;
``jax.vmap`` over the inputs yields thousands of lockstep environments.
All power quantities here are in per-unit (the env layer converts MW/MVAr);
complex quantities are (re, im) real pairs.

Every function supports an optional leading batch axis on its dynamic
inputs (``[B, ...]``): the batch then executes natively -- bus aggregation
and I = YV become [B, n] matmuls, and the NR solvers run their batch-last
lane layouts -- rather than through ``vmap`` over the tiny per-network
dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.power_flow import cmul, solve_pfe
from ..ops.projection import project_polytope_lanes
from .grid import GridSpec, POLY_ROW_P_CAP, POLY_ROW_P_FLOOR
from .state import SimState


class TransitionResult(NamedTuple):
    state: SimState
    reward: jnp.ndarray
    e_loss: jnp.ndarray
    penalty: jnp.ndarray
    pfe_converged: jnp.ndarray


def compute_branch_flows(spec: GridSpec, v_re, v_im):
    """Directional branch currents and power flows (branch.py:153-198).

    Supports leading batch axes on v_re/v_im."""
    vf_re, vf_im = v_re[..., spec.br_f], v_im[..., spec.br_f]
    vt_re, vt_im = v_re[..., spec.br_t], v_im[..., spec.br_t]

    if1_re, if1_im = cmul(spec.br_aff[:, 0], spec.br_aff[:, 1], vf_re, vf_im)
    if2_re, if2_im = cmul(spec.br_aft[:, 0], spec.br_aft[:, 1], vt_re, vt_im)
    if_re, if_im = if1_re + if2_re, if1_im + if2_im

    it1_re, it1_im = cmul(spec.br_att[:, 0], spec.br_att[:, 1], vt_re, vt_im)
    it2_re, it2_im = cmul(spec.br_atf[:, 0], spec.br_atf[:, 1], vf_re, vf_im)
    it_re, it_im = it1_re + it2_re, it1_im + it2_im

    # S = V conj(I) at each end.
    p_from = vf_re * if_re + vf_im * if_im
    q_from = vf_im * if_re - vf_re * if_im
    p_to = vt_re * it_re + vt_im * it_im
    q_to = vt_im * it_re - vt_re * it_im

    s_from = jnp.sqrt(p_from * p_from + q_from * q_from)
    s_to = jnp.sqrt(p_to * p_to + q_to * q_to)
    s_max = jnp.sign(p_from) * jnp.maximum(s_from, s_to)
    return if_re, if_im, it_re, it_im, p_from, q_from, p_to, q_to, s_max


PF_METHODS = ("scan", "while", "hybrid", "tree", "tree_xla")


def resolve_solver_path(spec: GridSpec, pf_method: str, des_soc, P_load, *more) -> str:
    """The power-flow implementation :func:`transition` dispatches to.

    One of ``"cuda_tree"`` (the CUDA tree-NR kernel, ops/tree_cuda.py:
    ``pf_method="tree"`` on a GPU in float32), ``"xla_tree"`` (the XLA
    level sweep of ops/tree_nr.py: ``"tree"`` elsewhere, or pinned by
    ``"tree_xla"``) or ``"xla"`` (the dense scan/while/hybrid solver of
    ops/power_flow.py).  :func:`transition` routes through this function
    and bench.py reports it, so the two cannot drift apart.

    Only shapes/dtypes of ``des_soc``/``P_load``/``more`` are read, so host
    probes (NumPy arrays or ``jax.ShapeDtypeStruct``) work without tracing.
    """
    if pf_method not in PF_METHODS:
        raise ValueError("pf_method=%r; expected one of %s" % (pf_method, PF_METHODS))
    if pf_method == "tree_xla":
        return "xla_tree"
    if pf_method == "tree":
        import jax

        dts = [np.dtype(spec.dtype)] + [
            np.dtype(a.dtype) for a in (des_soc, P_load) + more if getattr(a, "dtype", None) is not None
        ]
        if jax.default_backend() == "gpu" and np.result_type(*dts) == np.float32:
            return "cuda_tree"
        return "xla_tree"
    return "xla"


def _map_set_points(spec: GridSpec, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des):
    """Steps 1-3 of the transition: feasible injections + SoC update."""
    dt = spec.dtype

    # Loads: clip + fixed Q/P ratio (devices.py:156-167).
    load_p = jnp.clip(P_load, spec.load_p_min, spec.load_p_max)
    load_q = load_p * spec.load_qp

    # Generators: clip the potential, then cap P by it (devices.py:181-187, 280-304).
    p_pot = jnp.clip(P_pot, spec.gen_p_min, spec.gen_p_max)
    rows = jnp.arange(spec.gen_h0.shape[-1])
    # Dynamic polytope rows written via broadcasting where (batch-friendly).
    gen_h = jnp.where(rows == POLY_ROW_P_CAP, p_pot[..., :, None], spec.gen_h0)

    # Storage: SoC-rate caps on (dis)charging (devices.py:501-514).
    discharge_cap = spec.des_eff * (des_soc - spec.des_soc_min) / spec.delta_t
    charge_cap = -(des_soc - spec.des_soc_max) / (spec.delta_t * spec.des_eff)
    des_h = jnp.where(
        rows == POLY_ROW_P_CAP,
        discharge_cap[..., :, None],
        jnp.where(rows == POLY_ROW_P_FLOOR, charge_cap[..., :, None], spec.des_h0),
    )

    # One batched exact projection for all controllable devices.
    C = spec.n_gen + spec.n_des
    h = jnp.concatenate([gen_h, des_h], axis=-2)  # [..., C, m]
    m = h.shape[-1]
    G_static = np.concatenate([np.asarray(spec.gen_G), np.asarray(spec.des_G)], axis=0)
    p_pts = jnp.concatenate([P_set_gen, P_set_des], axis=-1).astype(dt)  # [..., C]
    q_pts = jnp.concatenate([Q_set_gen, Q_set_des], axis=-1).astype(dt)
    bs = h.shape[:-2]
    B = int(np.prod(bs)) if bs else 1
    px = jnp.moveaxis(p_pts.reshape((B, C)), 0, -1)  # [C, B]
    py = jnp.moveaxis(q_pts.reshape((B, C)), 0, -1)
    hL = jnp.moveaxis(h.reshape((B, C, m)), 0, -1)  # [C, m, B]
    x, y = project_polytope_lanes(px, py, G_static, hL)
    proj_p = jnp.moveaxis(x, -1, 0).reshape(bs + (C,))
    proj_q = jnp.moveaxis(y, -1, 0).reshape(bs + (C,))
    gen_p, gen_q = proj_p[..., : spec.n_gen], proj_q[..., : spec.n_gen]
    des_p, des_q = proj_p[..., spec.n_gen :], proj_q[..., spec.n_gen :]

    # SoC update with round-trip efficiency asymmetry + clip (devices.py:524-545).
    new_soc = jnp.where(
        des_p <= 0,
        des_soc - spec.delta_t * spec.des_eff * des_p,
        des_soc - spec.delta_t * des_p / spec.des_eff,
    )
    new_soc = jnp.clip(new_soc, spec.des_soc_min, spec.des_soc_max)

    # Assemble full device injection vectors (slack initialized to 0,
    # simulator.py:520-523) via a static permutation gather.
    bs = jnp.broadcast_shapes(load_p.shape[:-1], gen_p.shape[:-1], des_p.shape[:-1])
    concat_order = np.concatenate(
        [[int(spec.slack_pos)], np.asarray(spec.load_pos), np.asarray(spec.gen_pos), np.asarray(spec.des_pos)]
    )
    perm = np.empty(spec.n_dev, dtype=np.int32)
    perm[concat_order] = np.arange(spec.n_dev)
    zero_slack = jnp.zeros(bs + (1,), dtype=dt)
    dev_p = jnp.concatenate(
        [zero_slack, jnp.broadcast_to(load_p, bs + (spec.n_load,)), gen_p, des_p], axis=-1
    )[..., perm]
    dev_q = jnp.concatenate(
        [zero_slack, jnp.broadcast_to(load_q, bs + (spec.n_load,)), gen_q, des_q], axis=-1
    )[..., perm]
    return dev_p, dev_q, new_soc, p_pot


def _reward(spec: GridSpec, dev_p, gen_p_pot, v_re, v_im, br_s):
    """Energy loss + constraint penalty (simulator.py:638-683)."""
    e_loss = jnp.sum(spec.eloss_mask * dev_p, axis=-1)
    if spec.n_rer:
        curtail = jnp.maximum(0.0, gen_p_pot[..., spec.rer_gen_idx] - dev_p[..., spec.rer_pos])
        e_loss = e_loss + jnp.sum(curtail, axis=-1)
    e_loss = e_loss * spec.delta_t

    v_magn = jnp.sqrt(v_re * v_re + v_im * v_im)
    v_pen = jnp.sum(
        jnp.maximum(0.0, v_magn - spec.bus_v_max) + jnp.maximum(0.0, spec.bus_v_min - v_magn), axis=-1
    )
    br_pen = jnp.sum(jnp.maximum(0.0, jnp.abs(br_s) - spec.br_rate), axis=-1)
    penalty = (v_pen + br_pen) * spec.delta_t * spec.lamb

    return -(e_loss + penalty), e_loss, penalty


def transition(
    spec: GridSpec,
    des_soc,
    P_load,
    P_pot,
    P_set_gen,
    Q_set_gen,
    P_set_des,
    Q_set_des,
    x_tol=1e-5,
    max_iter=100,
    pf_method="scan",
    chord_iters=16,
    chord_precision=None,
    v_init=None,
) -> TransitionResult:
    """One physics transition (simulator.py:464-537). All inputs in p.u.

    Parameters
    ----------
    des_soc : [n_des]
        Current storage state of charge (p.u.).
    P_load : [n_load]
        Fixed load active injections.
    P_pot : [n_gen]
        Maximum potential generation of non-slack generators.
    P_set_gen, Q_set_gen : [n_gen]
        Generator set-points.
    P_set_des, Q_set_des : [n_des]
        Storage set-points.
    pf_method : {"scan", "while", "hybrid", "tree", "tree_xla"}
        Power-flow solver.  "scan"/"while" run dense per-lane NR (masked
        fixed-budget scan / early-exit while loop); "hybrid" prepends
        ``chord_iters`` constant-Jacobian chord iterations (matmul-only,
        at ``chord_precision``) before ``max_iter`` true-NR iterations.
        "tree" runs true per-lane NR with the tree-structured block
        elimination (radial networks only; O(n) per-lane solves): on a
        GPU in float32 as the CUDA kernel of ops/tree_cuda.py, elsewhere
        as the XLA level sweep of ops/tree_nr.py, which "tree_xla" pins.
    v_init : None or (bus_v_re, bus_v_im) with leading batch dims
        Optional warm start for the power-flow solve, e.g. the previous
        step's solved voltages (``SimState.bus_v_re/im``).  Per lane the
        solver starts from whichever of {warm point, flat start} has the
        smaller true mismatch; absorbing/reborn lanes (zero or
        out-of-window voltages) flat-start automatically, and the
        convergence decision is unchanged (true mismatch at ``x_tol``).
    """
    import jax

    solver_path = resolve_solver_path(
        spec, pf_method, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des
    )
    dev_p, dev_q, new_soc, p_pot = _map_set_points(
        spec, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des
    )

    # Bus aggregation as a static incidence matmul (simulator.py:539-549).
    # precision: a default-precision float32 matmul may round its inputs
    # (TF32 on GPU tensor cores, ~1e-3 relative); the NR iteration is
    # self-correcting under that, but these one-shot aggregations are not
    # -- they feed rewards, bounds checks and observations directly -- so
    # every product on the step path is pinned to HIGHEST.
    _HI = jax.lax.Precision.HIGHEST
    bus_p = jnp.einsum("nd,...d->...n", spec.inc_bus_dev, dev_p, precision=_HI)
    bus_q = jnp.einsum("nd,...d->...n", spec.inc_bus_dev, dev_q, precision=_HI)

    # Newton-Raphson load flow; slack bus is internal index 0.
    p_in, q_in = bus_p[..., 1:], bus_q[..., 1:]
    if solver_path in ("cuda_tree", "xla_tree"):
        from ..ops.tree_nr import build_tree_info

        if not (isinstance(spec.Y_re, np.ndarray) and isinstance(spec.br_f, np.ndarray)):
            raise ValueError("pf_method='tree' needs a static (NumPy-leaf) GridSpec")
        tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
        if tree is None:
            raise ValueError(
                "pf_method='tree' requires a radial network (a tree rooted at the "
                "slack bus); this network is meshed or disconnected"
            )
        if solver_path == "cuda_tree":
            from ..ops.tree_cuda import pack_schedule, solve_pfe_tree_cuda

            v_re, v_im, _, _, converged = solve_pfe_tree_cuda(
                pack_schedule(tree), p_in, q_in, x_tol=x_tol, max_iter=max_iter, init=v_init
            )
        else:
            from ..ops.tree_nr import solve_pfe_tree

            v_re, v_im, _, _, converged = solve_pfe_tree(
                tree, p_in, q_in, x_tol=x_tol, max_iter=max_iter, init=v_init
            )
    else:
        # The flat-start Jacobian inverse of the chord phase is a pure
        # function of the (static, NumPy) admittance matrix: invert on the
        # host at trace time so it folds into the program as a constant.
        J0inv = None
        if pf_method == "hybrid" and isinstance(spec.Y_re, np.ndarray) and isinstance(spec.Y_im, np.ndarray):
            from ..ops.power_flow import flat_start_jacobian_inv_np

            J0inv = flat_start_jacobian_inv_np(spec.Y_re, spec.Y_im, dtype=spec.dtype)
        v_re, v_im, _, _, converged = solve_pfe(
            spec.Y_re, spec.Y_im, p_in, q_in, x_tol=x_tol, max_iter=max_iter, method=pf_method,
            chord_iters=chord_iters, J0inv=J0inv, chord_precision=chord_precision, init=v_init,
        )

    # Nodal currents I = Y V and slack power (solve_load_flow.py:54-72;
    # NaN slack power becomes +inf).  V_slack = 1 + 0j, so
    # S_slack = conj(I_0).
    _HI = jax.lax.Precision.HIGHEST
    i_re = jnp.einsum("nk,...k->...n", spec.Y_re, v_re, precision=_HI) - jnp.einsum(
        "nk,...k->...n", spec.Y_im, v_im, precision=_HI
    )
    i_im = jnp.einsum("nk,...k->...n", spec.Y_re, v_im, precision=_HI) + jnp.einsum(
        "nk,...k->...n", spec.Y_im, v_re, precision=_HI
    )
    p0 = jnp.where(jnp.isnan(i_re[..., 0]), jnp.inf, i_re[..., 0])
    q0 = jnp.where(jnp.isnan(i_im[..., 0]), jnp.inf, -i_im[..., 0])
    # Masked writes instead of scatters (static one-hot masks).
    bus0 = np.arange(spec.n_bus) == 0
    devs = np.arange(spec.n_dev) == int(spec.slack_pos)
    bus_p = jnp.where(bus0, p0[..., None], bus_p)
    bus_q = jnp.where(bus0, q0[..., None], bus_q)
    dev_p = jnp.where(devs, p0[..., None], dev_p)
    dev_q = jnp.where(devs, q0[..., None], dev_q)

    if_re, if_im, it_re, it_im, p_from, q_from, p_to, q_to, s_max = compute_branch_flows(spec, v_re, v_im)

    state = SimState(
        dev_p=dev_p,
        dev_q=dev_q,
        des_soc=new_soc,
        gen_p_pot=p_pot,
        bus_v_re=v_re,
        bus_v_im=v_im,
        bus_i_re=i_re,
        bus_i_im=i_im,
        bus_p=bus_p,
        bus_q=bus_q,
        br_if_re=if_re,
        br_if_im=if_im,
        br_it_re=it_re,
        br_it_im=it_im,
        br_p_from=p_from,
        br_q_from=q_from,
        br_p_to=p_to,
        br_q_to=q_to,
        br_s=s_max,
        pfe_converged=converged,
    )
    reward, e_loss, penalty = _reward(spec, dev_p, p_pot, v_re, v_im, s_max)
    return TransitionResult(state, reward, e_loss, penalty, converged)


def sim_reset(
    spec: GridSpec, s0, x_tol=1e-5, max_iter=100, pf_method="scan", chord_iters=16, chord_precision=None
) -> SimState:
    """Apply an initial state vector (reference layout, MW/MVAr/MWh units)
    to the grid (simulator.py:225-293).

    ``s0 = [dev_p (d), dev_q (d), des_soc (n_des), gen_p_max (n_gen), ...]``;
    trailing entries (aux vars) are ignored here.
    """
    d = spec.n_dev
    base = spec.baseMVA
    P_dev = s0[..., :d] / base
    Q_dev = s0[..., d : 2 * d] / base
    soc_target = s0[..., 2 * d : 2 * d + spec.n_des] / base
    P_max = s0[..., 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base

    P_set_des = P_dev[..., spec.des_pos]
    # Pre-set each storage SoC to empty/full so the requested injection is
    # feasible during the transition (simulator.py:273-278).
    soc_pre = jnp.where(P_set_des <= 0, spec.des_soc_min, spec.des_soc_max)

    res = transition(
        spec,
        soc_pre,
        P_load=P_dev[..., spec.load_pos],
        P_pot=P_max,
        P_set_gen=P_dev[..., spec.gen_pos],
        Q_set_gen=Q_dev[..., spec.gen_pos],
        P_set_des=P_set_des,
        Q_set_des=Q_dev[..., spec.des_pos],
        x_tol=x_tol,
        max_iter=max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        chord_precision=chord_precision,
    )
    # Override the SoC with the requested initial value (simulator.py:284-288;
    # note the reference does not clip it here).
    return dataclasses.replace(res.state, des_soc=soc_target.astype(spec.dtype))
