#!/usr/bin/env python
"""Calibrate NR/chord iteration budgets for warm-started power flows.

Rolls out each env with uniform-random actions, records every step's bus
injections and the previous step's solved voltages, then re-solves each
step's power flow twice -- cold (flat start) and warm (previous voltages)
-- with a generous iteration budget, reporting the per-step iteration-count
distribution.  The warm p100 (+margin) becomes the env's calibrated
``warm_start`` budget in ``make_core`` (the scan-based solvers execute a
*fixed* masked budget, so the win from warm starting is realized exactly by
lowering that budget).

Run on CPU (default; the solver math is backend-independent) or, with
``--device``, on the default JAX device.  Example:

    python scripts/warm_calib.py --env anm6easy --batch 512 --steps 256
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="anm6easy", choices=["anm6easy", "feeder33", "feeder141"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--budget", type=int, default=40, help="generous solve budget for measurement")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", action="store_true", help="run on the default backend instead of CPU")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax

    if not args.device:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    import numpy as np
    import jax.numpy as jnp

    if args.env == "feeder33":
        from gym_anm_tpu.envs.feeder33 import make_core
    elif args.env == "feeder141":
        from gym_anm_tpu.envs.feeder141 import make_core
    else:
        from gym_anm_tpu.envs.anm6.anm6_easy import make_core

    # Solve with the generic (scan or tree) XLA path -- the iteration count
    # is a property of the math, not of the kernel packaging.
    core = make_core(pf_method="scan" if args.env == "anm6easy" else "tree")
    spec = core.spec
    from gym_anm_tpu.envs.batched import BatchedEnv
    from gym_anm_tpu.ops.power_flow import solve_pfe
    from gym_anm_tpu.ops.tree_nr import build_tree_info, solve_pfe_tree

    env = BatchedEnv(core, batch_size=args.batch, auto_reset=True, auto_reset_mode="step")
    key = jax.random.PRNGKey(args.seed)
    k_reset, k_run = jax.random.split(key)
    es, _ = env.reset(k_reset)

    lo = np.asarray(core.action_low, dtype=spec.dtype)
    hi = np.asarray(core.action_high, dtype=spec.dtype)

    @jax.jit
    def collect(es, key):
        def body(carry, k):
            es = carry
            k_act, k_step = jax.random.split(k)
            u = jax.random.uniform(k_act, (args.batch, core.action_n), spec.dtype)
            actions = u * (hi - lo) + lo
            v_prev_re, v_prev_im = es.sim.bus_v_re, es.sim.bus_v_im
            live_prev = ~es.terminated
            es, out = env.step_fn(es, actions, k_step)
            rec = (
                es.sim.bus_p[:, 1:],
                es.sim.bus_q[:, 1:],
                v_prev_re,
                v_prev_im,
                live_prev & ~out.terminated,
            )
            return es, rec
        return jax.lax.scan(body, es, jax.random.split(key, args.steps))

    _, (bp, bq, vre, vim, live) = collect(es, k_run)
    bp, bq = np.asarray(bp), np.asarray(bq)
    vre, vim, live = np.asarray(vre), np.asarray(vim), np.asarray(live)
    T, B, m = bp.shape
    print(f"collected {T}x{B} steps, live(+prev-live) frac {live.mean():.3f}")

    # NB: bus_p[0] was overwritten by the slack solution, but only indices
    # 1: feed the solver, so these are exactly the injections it saw.
    flat = lambda a: jnp.asarray(a.reshape((-1,) + a.shape[2:]), spec.dtype)
    p_in, q_in = flat(bp), flat(bq)
    v0 = (flat(vre), flat(vim))
    live = live.reshape(-1)

    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)

    def solve(init):
        if args.env == "anm6easy":
            f = jax.jit(
                lambda p, q, init: solve_pfe(
                    jnp.asarray(spec.Y_re), jnp.asarray(spec.Y_im), p, q,
                    x_tol=core.x_tol, max_iter=args.budget, method="scan", init=init,
                )
            )
        else:
            f = jax.jit(
                lambda p, q, init: solve_pfe_tree(
                    tree, p, q, x_tol=core.x_tol, max_iter=args.budget, init=init
                )
            )
        _, _, _, n_iter, conv = f(p_in, q_in, init)
        return np.asarray(n_iter), np.asarray(conv)

    for name, init in (("cold", None), ("warm", v0)):
        n_iter, conv = solve(init)
        sel = live & conv  # converging solves of live lanes: the budget target
        it = n_iter[sel]
        pct = lambda q: int(np.percentile(it, q)) if it.size else -1
        print(
            f"{name}: live-converged {sel.sum()} | iters p50 {pct(50)} p99 {pct(99)} "
            f"p99.9 {pct(99.9)} p100 {it.max() if it.size else -1} | "
            f"unconverged(live) {int((live & ~conv).sum())}"
        )


if __name__ == "__main__":
    main()
