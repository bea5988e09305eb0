"""On-device trajectory-parity harness.

Every headline perf number rests on f32 solver paths on the accelerator;
this module gives them a *non-vacuous on-device correctness check*: fixed
initial states, fixed actions, and fixed internal variables are committed
to the repo together with the host-float64 trajectory they produce, and
``bench.py --check`` replays the identical inputs through a solver path on
the device (tree / scan / hybrid) comparing states, rewards and
termination decisions step by step.

Matches the reference's invariant-test strategy
(/root/reference/tests/simulator/test_simulator_transitions.py:189-265) but
as a cross-precision, cross-backend trajectory oracle instead of per-solve
invariants.

Design notes:

* All inputs (s0, actions, vars) are stored at float32 precision so host
  and device consume *bit-identical* values -- the comparison then isolates
  the physics path (projection + power flow + reward), not input rounding.
* Internal variables are pre-recorded from the host rollout and replayed
  verbatim (``EnvCore.step(es, action, vars)``), so stochastic tasks
  (feeder33) are checked on a common trajectory too.
* The action sequence is scaled toward the action-space center
  (``action_scale``) and the horizon chosen so the final terminated
  fraction lands in [0.2, 0.8]: the termination signal must discriminate
  between solvers, which it cannot when ~100% of lanes are terminated
  (the round-1 bench's saturated ``terminated_frac = 0.998``).
* Termination may legitimately differ on a *tiny* fraction of lanes near
  the convergence boundary (f32 vs f64 Newton-Raphson); states are
  compared only while a lane's termination history matches, and the check
  fails if more than ``term_tol`` of lanes ever disagree.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")

# Per-env check configuration: sizes, action scaling (calibrated so the
# final terminated_frac is in [0.2, 0.8] -- see scripts/gen_onchip_refs.py),
# and which solver paths to verify on the device.
CHECK_CONFIG = {
    # method -> make_core kwargs (the calibrated budgets bench.py uses).
    "anm6easy": dict(
        B=256,
        T=64,
        seed=0,
        action_scale=1.0,
        methods={"scan": {}, "hybrid": {}, "tree": {}},
    ),
    # ``stress``: the recorded loads are ramped up to (1 + stress)x by the
    # final step, sweeping lanes across the collapse boundary during the
    # trajectory -- legitimate because the (stressed) vars are replayed
    # bit-identically on host and device; uniform-random actions alone cannot
    # collapse these stiff feeders within a committable horizon.
    "feeder33": dict(B=128, T=24, seed=0, action_scale=1.0, stress=1.5, methods={"tree": {}, "hybrid": {}}),
    # feeder141 is feasible-by-construction at full load (branch ratings are
    # sized from downstream subtree peaks and loads clip at p_min -- see
    # envs/feeder141.py), so no legal input collapses it: stress=2 saturates
    # every load at its bound (the worst legal case), terminated_frac stays
    # 0, and the check's signal is pure state/reward parity of the f32
    # solver against per-lane NR f64.
    "feeder141": dict(B=64, T=16, seed=0, action_scale=1.0, stress=2.0, methods={"tree": {}}),
}


def ref_path(env_name: str) -> str:
    return os.path.join(DATA_DIR, "onchip_ref_%s.npz" % env_name)


def make_actions(core, B: int, T: int, seed: int, action_scale: float) -> np.ndarray:
    """Deterministic f32 action sequence: uniform around the action-space
    center, scaled by ``action_scale`` of the half-range."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(core.action_low, dtype=np.float64)
    hi = np.asarray(core.action_high, dtype=np.float64)
    center = (lo + hi) / 2.0
    half = (hi - lo) / 2.0
    u = rng.uniform(-1.0, 1.0, size=(T, B, lo.shape[0]))
    return (center + action_scale * half * u).astype(np.float32)


def make_s0(core, B: int, seed: int) -> np.ndarray:
    """Initial states from the task's own distribution (f32-rounded)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    s0 = jax.vmap(core.init_state_fn)(keys)
    return np.asarray(s0, dtype=np.float32)


def record_vars(core, s0, actions, seed: int) -> np.ndarray:
    """Roll the task forward once to record the internal-variable sequence
    ``[T, B, vars_n]`` (f32-rounded) that the check replays verbatim."""
    T, B = actions.shape[:2]
    dtype = core.spec.dtype
    es0 = core.env_state_from_s0(jnp.asarray(s0, dtype))
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), (T, B))

    def body(es, xs):
        action, ks = xs
        if core.stochastic_vars:
            vars = jax.vmap(core.next_vars_fn)(core.state_vec(es), ks)
        else:
            vars = jax.vmap(core.next_vars_fn, in_axes=(0, None))(core.state_vec(es), ks[0])
        es, _ = core.step(es, jnp.asarray(action, dtype), vars)
        return es, vars

    _, vars_seq = jax.lax.scan(body, es0, (jnp.asarray(actions, dtype), keys))
    return np.asarray(vars_seq, dtype=np.float32)


def stress_vars(core, vars_seq, stress: float) -> np.ndarray:
    """Ramp the load entries of a recorded vars sequence up to
    ``(1 + stress)x`` by the final step (f32-rounded)."""
    if not stress:
        return vars_seq
    T = vars_seq.shape[0]
    n_load = core.spec.n_load
    factor = (1.0 + stress * np.arange(1, T + 1) / T).astype(np.float32)
    out = np.array(vars_seq, dtype=np.float32)
    out[:, :, :n_load] *= factor[:, None, None]
    return out


def rollout_given(core, s0, actions, vars_seq):
    """Replay a fixed (s0, actions, vars) trajectory; one jitted scan.

    Returns (state_vec [T, B, n], reward [T, B], terminated [T, B]) as
    device arrays in the core's dtype.
    """
    dtype = core.spec.dtype
    s0 = jnp.asarray(s0, dtype)
    actions = jnp.asarray(actions, dtype)
    vars_seq = jnp.asarray(vars_seq, dtype)

    @jax.jit
    def run(s0, actions, vars_seq):
        es0 = core.env_state_from_s0(s0)
        def body(es, xs):
            action, vars = xs
            es, out = core.step(es, action, vars)
            return es, (out.state_vec, out.reward, out.terminated)
        _, traj = jax.lax.scan(body, es0, (actions, vars_seq))
        return traj

    return run(s0, actions, vars_seq)


def compare_trajectories(ref, got, term_tol=0.02, state_tol=5e-3, reward_tol=5e-3):
    """Step-by-step comparison of a device trajectory against the committed
    host-f64 reference.

    ref/got: dicts with state_vec [T, B, n], reward [T, B], terminated
    [T, B] (numpy).  States and rewards are compared only while a lane's
    termination history matches the reference (a lane that diverges at a
    different step legitimately holds a different absorbing state
    afterwards).  State divergence is measured relative to the per-feature
    dynamic range (max |state| over the reference trajectory, floored at 1).

    Returns a dict: term_mismatch_frac, max_state_div, max_reward_div,
    final_terminated_frac, n_compared, pass.
    """
    r_term = np.asarray(ref["terminated"], dtype=bool)
    g_term = np.asarray(got["terminated"], dtype=bool)
    T, B = r_term.shape

    # A lane counts as mismatched once its termination flag ever disagrees.
    disagree = np.cumsum(r_term != g_term, axis=0) > 0  # [T, B]
    term_mismatch_frac = float(disagree[-1].mean())

    # Valid comparison mask: termination history agrees so far AND the lane
    # is not yet terminated (absorbing zero states are trivially equal).
    valid = ~disagree & ~r_term  # [T, B]

    r_sv = np.asarray(ref["state_vec"], dtype=np.float64)
    g_sv = np.asarray(got["state_vec"], dtype=np.float64)
    scale = np.maximum(np.abs(r_sv).max(axis=(0, 1)), 1.0)  # [n]
    div = np.abs(g_sv - r_sv) / scale  # [T, B, n]
    div = np.where(valid[:, :, None], div, 0.0)
    max_state_div = float(div.max()) if valid.any() else 0.0

    r_rw = np.asarray(ref["reward"], dtype=np.float64)
    g_rw = np.asarray(got["reward"], dtype=np.float64)
    rw_scale = max(np.abs(r_rw).max(), 1.0)
    rdiv = np.where(valid, np.abs(g_rw - r_rw) / rw_scale, 0.0)
    max_reward_div = float(rdiv.max()) if valid.any() else 0.0

    ok = (
        term_mismatch_frac <= term_tol
        and max_state_div <= state_tol
        and max_reward_div <= reward_tol
    )
    return {
        "term_mismatch_frac": round(term_mismatch_frac, 6),
        "max_state_div": round(max_state_div, 8),
        "max_reward_div": round(max_reward_div, 8),
        "ref_final_terminated_frac": round(float(r_term[-1].mean()), 6),
        "got_final_terminated_frac": round(float(g_term[-1].mean()), 6),
        "n_compared_lane_steps": int(valid.sum()),
        "pass": bool(ok),
    }


def load_reference(env_name: str) -> dict:
    """Load the committed inputs + host-f64 trajectory for an env."""
    with np.load(ref_path(env_name)) as z:
        return {k: z[k] for k in z.files}


def run_check(env_name: str, make_core, methods=None, term_tol=0.02, state_tol=5e-3, reward_tol=5e-3) -> dict:
    """Replay the committed trajectory through each solver path on the
    default device and compare.  Returns {method: comparison_dict, "pass":
    all_passed}."""
    data = load_reference(env_name)
    cfg = CHECK_CONFIG[env_name]
    methods = dict(methods) if methods is not None else dict(cfg["methods"])
    out = {}
    all_ok = True
    for method, kw in methods.items():
        core = make_core(pf_method=method, **kw)
        sv, rw, tm = rollout_given(core, data["s0"], data["actions"], data["vars"])
        got = {
            "state_vec": np.asarray(sv),
            "reward": np.asarray(rw),
            "terminated": np.asarray(tm),
        }
        res = compare_trajectories(
            {"state_vec": data["state_vec"], "reward": data["reward"], "terminated": data["terminated"]},
            got,
            term_tol=term_tol,
            state_tol=state_tol,
            reward_tol=reward_tol,
        )
        out[method] = res
        all_ok = all_ok and res["pass"]
    out["pass"] = all_ok
    return out


def random_injections(core, B: int, seed: int = 0):
    """Non-slack bus injections ``(p, q)`` [B, n_bus - 1] (p.u., the core's
    dtype) as one step of the task would hand them to the power flow:
    initial states from the task's distribution, uniform-random actions,
    set-points projected onto the devices' operating regions.  Host NumPy,
    for comparing solvers on the same inputs."""
    from .core.transition import _map_set_points

    spec = core.spec
    dt = spec.dtype
    base = spec.baseMVA
    k_s0, k_act = jax.random.split(jax.random.PRNGKey(seed))
    s0 = jax.vmap(core.init_state_fn)(jax.random.split(k_s0, B))
    lo = jnp.asarray(core.action_low, dt)
    hi = jnp.asarray(core.action_high, dt)
    a = (lo + (hi - lo) * jax.random.uniform(k_act, (B, core.action_n), dt)) / base
    n_gen, n_des, d = spec.n_gen, spec.n_des, spec.n_dev
    P_dev = s0[:, :d] / base
    P_pot = s0[:, 2 * d + n_des : 2 * d + n_des + n_gen] / base
    soc = s0[:, 2 * d : 2 * d + n_des] / base
    dev_p, dev_q, _, _ = _map_set_points(
        spec, soc, P_dev[:, spec.load_pos], P_pot, a[:, :n_gen], a[:, n_gen : 2 * n_gen],
        a[:, 2 * n_gen : 2 * n_gen + n_des], a[:, 2 * n_gen + n_des :],
    )
    inc = np.asarray(spec.inc_bus_dev, np.float64)
    p = np.asarray(dev_p, np.float64) @ inc.T
    q = np.asarray(dev_q, np.float64) @ inc.T
    return p[:, 1:].astype(dt), q[:, 1:].astype(dt)


# Tolerances of one power-flow solver against another on the same
# injections (the CUDA tree kernel against the XLA tree solver in float32 and
# the float64 walk; chip_smoke.py, tests/test_tree_cuda.py):
#  * |dV| <= SOLVE_DV_TOL p.u. on lanes both call converged and whose
#    voltages stay >= SOLVE_V_FLOOR p.u.: NR stops once the mismatch is
#    <= x_tol, which leaves a voltage error of about x_tol times the norm of
#    the inverse Jacobian -- a few x_tol in the operating region, unbounded
#    as a lane nears voltage collapse (~0.5 p.u.).  Lanes below the floor
#    are held to the convergence flags only; their |dV| is reported.
#  * convergence flags differ on <= SOLVE_FLAG_TOL of lanes: only lanes
#    whose final mismatch sits within float32 rounding of x_tol may flip;
#  * iteration counts within +-1 on >= SOLVE_IT_SHARE of lanes both
#    converged: a lane whose mismatch plateaus at the float32 noise floor
#    near x_tol crosses it at a rounding-dependent iteration.
SOLVE_DV_TOL, SOLVE_V_FLOOR, SOLVE_FLAG_TOL, SOLVE_IT_SHARE = 1e-4, 0.8, 1e-3, 0.99


def compare_solves(got, ref, x_tol) -> dict:
    """Compare two solves ``(v_re, v_im, diff, n_iter)`` (``[B, n]``,
    ``[B, n]``, ``[B]``, ``[B]``) at the tolerances above."""
    vr, vi, diff, it = (np.asarray(x) for x in got)
    rvr, rvi, rdiff, rit = (np.asarray(x) for x in ref)
    c, rc = diff <= x_tol, rdiff <= x_tol
    both = c & rc
    dv = np.maximum(np.abs(vr - rvr), np.abs(vi - rvi)).max(axis=-1) if vr.size else np.zeros(0)
    with np.errstate(invalid="ignore"):
        in_region = np.hypot(rvr, rvi).min(axis=-1) >= SOLVE_V_FLOOR
    dv_region = float(dv[both & in_region].max()) if (both & in_region).any() else 0.0
    dv_all = float(dv[both].max()) if both.any() else 0.0
    flag = float((c != rc).mean()) if c.size else 0.0
    dit = np.abs(it.astype(np.int64) - rit.astype(np.int64))[both]
    it_share = float((dit <= 1).mean()) if dit.size else 1.0
    return {
        "max_dV": dv_region,
        "max_dV_below_floor": dv_all,
        "flag_mismatch": flag,
        "iters_within_1": it_share,
        "max_dit": int(dit.max()) if dit.size else 0,
        "pass": bool(dv_region <= SOLVE_DV_TOL and flag <= SOLVE_FLAG_TOL and it_share >= SOLVE_IT_SHARE),
    }
