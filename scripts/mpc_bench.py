#!/usr/bin/env python
"""Batched DC-OPF MPC throughput benchmark (BASELINE.md secondary metric).

Times ``MPCAgentConstant.act_batch`` — the fully on-device batched ADMM
DC-OPF solve (agents/mpc.py:_admm_batch_full, one jitted program with
per-lane adaptive rho) — over B environment lanes of ANM6Easy-v0 at a
given planning horizon.  The reference solves one CVXPY/ECOS program per
env per step (reference mpc.py:372-393); here a whole fleet is one XLA
program.

Prints ONE JSON line per (batch, horizon) config:

    {"metric": "mpc-solves/s", "value": N, "unit": "solves/s",
     "detail": {...}}
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _verify_lanes(agent, k):
    """Objective parity of K sampled lanes vs the scipy HiGHS LP optimum.

    Uses the banded solver's sparse assembly when available (scales to
    feeder141 horizon 20, where no dense A exists), else the dense mirror.
    Returns max/mean relative objective gap and a feasibility residual.
    """
    from scipy.optimize import linprog
    from scipy import sparse

    sol = getattr(agent, "last_batch_solution", None)
    if sol is None:
        return {"verify_error": "no batch solution recorded"}
    X, LV, UV = sol["x"], sol["lv"], sol["uv"]
    B = X.shape[0]
    lanes = np.linspace(0, B - 1, min(k, B)).astype(int)
    A = agent.sparse_A() if hasattr(agent, "sparse_A") else sparse.csr_matrix(agent.A)
    gaps, feas = [], []
    for b in lanes:
        x, lv, uv = X[b], LV[b], UV[b]
        Ax = agent.apply_A_host(x) if hasattr(agent, "apply_A_host") else A @ x
        feas.append(float(np.max(np.maximum(0.0, np.maximum(lv - Ax, Ax - uv)))))
        eq = (lv == uv) & np.isfinite(lv)
        ub = np.isfinite(uv) & ~eq
        lb = np.isfinite(lv) & ~eq
        res = linprog(
            agent.q,
            A_ub=sparse.vstack([A[ub], -A[lb]]),
            b_ub=np.concatenate([uv[ub], -lv[lb]]),
            A_eq=A[eq],
            b_eq=lv[eq],
            bounds=[(None, None)] * agent.nz,
            method="highs",
        )
        if res.status != 0:
            return {"verify_error": f"HiGHS status {res.status} on lane {int(b)}"}
        gaps.append(abs(float(agent.q @ x) - res.fun) / max(1.0, abs(res.fun)))
    return {
        "verify_lanes": len(lanes),
        "verify_max_rel_obj_gap": round(max(gaps), 8),
        "verify_mean_rel_obj_gap": round(float(np.mean(gaps)), 8),
        "verify_max_bound_violation": round(max(feas), 8),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1024])
    ap.add_argument("--horizon", type=int, nargs="+", default=[1, 3, 10])
    ap.add_argument("--iters", type=int, default=5, help="timed act_batch calls")
    ap.add_argument("--env-steps", type=int, default=8, help="random env steps before the bench state")
    ap.add_argument(
        "--warm",
        action="store_true",
        help="receding-horizon mode: step the fleet with the MPC action between "
        "timed solves and warm-start each solve from the previous ADMM iterate",
    )
    ap.add_argument(
        "--warm-shift",
        action="store_true",
        help="with --warm: realign the carried ADMM iterate by one stage each "
        "step (the receding-horizon shift; matters for time-varying forecasts)",
    )
    ap.add_argument(
        "--polish",
        action="store_true",
        help="mixed-precision accuracy mode: after the on-device f32 ADMM, run the "
        "host-side f64 sparse-KKT active-set polish per lane (banded solver; "
        "recovers the exact LP vertex -- pair with --verify to measure the "
        "objective gap vs HiGHS)",
    )
    ap.add_argument(
        "--f64",
        action="store_true",
        help="run the ADMM solver in float64 (scoped enable_x64; the accuracy "
        "mode -- closes the ~5-10%% f32 objective gap at feeder141 scale to ~1e-5)",
    )
    ap.add_argument(
        "--verify",
        type=int,
        default=0,
        metavar="K",
        help="cross-check K sampled lanes of the final batch solve against the "
        "scipy HiGHS LP optimum (sparse assembly for the banded solver, so it "
        "works at feeder141 horizon-20 scale); adds objective-gap fields to "
        "the JSON detail",
    )
    ap.add_argument(
        "--solver",
        default="dense",
        choices=["dense", "banded"],
        help="LP backend: dense (agents/mpc.py) or stage-banded "
        "(agents/mpc_banded.py; the scalable choice for long horizons / "
        "large networks)",
    )
    ap.add_argument(
        "--env",
        default="anm6easy",
        choices=["anm6easy", "feeder33", "feeder141"],
        help="environment/network to bench on (feeder141 requires --solver banded)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import gym_anm_tpu  # noqa: F401  (registers envs)
    from gym_anm_tpu.agents import MPCAgentConstant, MPCAgentConstantBanded

    if args.env == "feeder33":
        from gym_anm_tpu.envs import Feeder33Env as HostEnv
        from gym_anm_tpu.envs.feeder33 import make_core
    elif args.env == "feeder141":
        from gym_anm_tpu.envs import Feeder141Env as HostEnv
        from gym_anm_tpu.envs.feeder141 import make_core
    else:
        from gym_anm_tpu.envs import ANM6Easy as HostEnv
        from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    agent_cls = MPCAgentConstantBanded if args.solver == "banded" else MPCAgentConstant

    host_env = HostEnv()
    host_env.reset(seed=0)

    for B in args.batch:
        env = BatchedEnv(make_core(), batch_size=B)
        key = jax.random.PRNGKey(0)
        k_reset, k_run = jax.random.split(key)
        es, _ = env.reset(k_reset)
        run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=args.env_steps))
        es, _ = run(es, k_run)
        state_vecs = np.asarray(es.state_vec)

        for N in args.horizon:
            agent = agent_cls(
                host_env.simulator, host_env.action_space, host_env.gamma, planning_steps=N,
                solver_x64=args.f64,
            )
            t0 = time.time()
            acts = agent.act_batch(state_vecs, warm_start=args.warm, warm_shift=args.warm_shift, polish=args.polish)  # compile + cold solve
            compile_s = time.time() - t0

            times = []
            if args.warm:
                # Receding horizon: advance the fleet under the MPC policy and
                # warm-start each solve from the previous iterate (the actual
                # operating mode of an MPC fleet).
                es_run = es
                for t in range(args.iters):
                    es_run, out = env.step(es_run, jnp.asarray(acts), jax.random.fold_in(k_run, t))
                    sv = np.asarray(out.state_vec)
                    t0 = time.time()
                    acts = agent.act_batch(sv, warm_start=True, warm_shift=args.warm_shift, polish=args.polish)
                    times.append(time.time() - t0)
            else:
                for _ in range(args.iters):
                    t0 = time.time()
                    acts = agent.act_batch(state_vecs, polish=args.polish)
                    times.append(time.time() - t0)
            med = statistics.median(times)

            detail = {
                "batch": B,
                "horizon": N,
                "env": args.env,
                "solver": args.solver,
                "warm_start": bool(args.warm),
                "warm_shift": bool(args.warm_shift),
                "polish": bool(args.polish),
                "median_s_per_batch": round(med, 4),
                "first_call_s": round(compile_s, 2),
                "backend": jax.default_backend(),
                "mean_abs_action_mw": round(float(np.abs(acts).mean()), 3),
            }
            if args.verify:
                detail.update(_verify_lanes(agent, args.verify))
            print(
                json.dumps(
                    {
                        "metric": "mpc-solves/s",
                        "value": round(B / med, 1),
                        "unit": "solves/s",
                        "detail": detail,
                    }
                )
            )
            sys.stdout.flush()


if __name__ == "__main__":
    main()
