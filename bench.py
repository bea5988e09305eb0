#!/usr/bin/env python
"""Throughput benchmark: env-steps/s of batched lockstep environments.

Runs B lockstep environments for T scanned steps per program call with
uniform-random actions on the default JAX device, which must be a GPU
(``JAX_PLATFORMS=cpu`` runs a CPU rehearsal instead).  The headline number
is the pipelined steady-state rate (programs dispatched back-to-back,
blocked once -- what a continuous rollout loop sustains); the blocking
per-call median is reported in the detail line.  Prints ONE JSON line on
stdout:

    {"metric": "env-steps/s", "value": N, "unit": "steps/s", "vs_baseline": N / 1e6,
     "parity_pass": bool, "platform": ..., "device_kind": ..., "device_count": ...,
     "solver_path": ...}

and a ``{"detail": ...}`` line on stderr.  Baseline target (BASELINE.md):
>= 1M env-steps/s at B=4096.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np


def analytic_flops_per_step(core, solver_path, transitions_per_step):
    """Shape-derived FLOPs per env step of the power-flow loop, which XLA's
    cost analysis cannot see: it counts a loop body once, and a custom call
    not at all.  For the CUDA tree kernel this is an upper bound, since each
    lane stops at its own convergence."""
    spec = core.spec
    if solver_path == "xla":
        from gym_anm_tpu.ops.power_flow import nr_flops_per_lane

        chord = core.chord_iters if core.pf_method == "hybrid" else 0
        per = nr_flops_per_lane(spec.n_bus, core.max_iter, chord)
    else:
        from gym_anm_tpu.ops.tree_nr import build_tree_info, tree_nr_flops_per_lane

        tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
        per = tree_nr_flops_per_lane(spec.n_bus, core.max_iter, maxC=tree.ch_eo.shape[1], warm=core.warm_start)
    return per * transitions_per_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="anm6easy", choices=["anm6easy", "feeder33", "feeder141"])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64, help="scanned steps per program call")
    ap.add_argument("--iters", type=int, default=10, help="timed program calls")
    ap.add_argument("--trials", type=int, default=5, help="pipelined timing trials (median reported)")
    ap.add_argument("--profile", metavar="DIR", default=None, help="write a jax.profiler trace of the timed calls")
    ap.add_argument(
        "--pf",
        default="tree",
        choices=["scan", "while", "hybrid", "tree", "tree_xla"],
        help="power-flow solver: 'tree' = exact per-lane NR by radial tree elimination (the CUDA "
        "kernel on a GPU in float32), 'tree_xla' pins its XLA level sweep, 'scan'/'while' = dense "
        "NR, 'hybrid' = chord + NR tail",
    )
    warm_group = ap.add_mutually_exclusive_group()
    warm_group.add_argument(
        "--warm",
        action="store_true",
        dest="warm",
        default=None,
        help="warm-start each step's power flow from the previous step's solved voltages",
    )
    warm_group.add_argument("--no-warm", action="store_false", dest="warm")
    ap.add_argument("--json-out", default=None, metavar="PATH", help="also write result + detail JSON to PATH")
    ap.add_argument("--tail", type=int, default=None, help="NR iteration budget (tail for --pf hybrid)")
    ap.add_argument("--chord-iters", type=int, default=None, help="chord iteration budget for --pf hybrid")
    ap.add_argument("--chord-precision", default=None, choices=["highest", "default"])
    ap.add_argument(
        "--auto-reset",
        action="store_true",
        help="bench the RL-training configuration (BatchedEnv(auto_reset=True), as PPO/SAC use)",
    )
    ap.add_argument("--auto-reset-mode", default="pool", choices=["pool", "step"])
    check_group = ap.add_mutually_exclusive_group()
    check_group.add_argument(
        "--check",
        action="store_true",
        dest="check",
        default=True,
        help="replay the committed host-f64 trajectory through the benched solver on the device "
        "(gym_anm_tpu/check.py; default on)",
    )
    check_group.add_argument("--no-check", action="store_false", dest="check", help="skip the parity check")
    args = ap.parse_args()

    import jax

    from gym_anm_tpu import runtime

    device = runtime.require_gpu()
    cache_dir = runtime.enable_compile_cache()

    from gym_anm_tpu.core.transition import resolve_solver_path
    from gym_anm_tpu.envs.batched import BatchedEnv

    if args.env == "feeder33":
        from gym_anm_tpu.envs.feeder33 import make_core
    elif args.env == "feeder141":
        from gym_anm_tpu.envs.feeder141 import make_core
    else:
        from gym_anm_tpu.envs.anm6.anm6_easy import make_core

    kw = {}
    if args.chord_precision is not None:
        kw["chord_precision"] = args.chord_precision
    if args.chord_iters is not None:
        kw["chord_iters"] = args.chord_iters
    if args.warm is not None:
        kw["warm_start"] = bool(args.warm)
    if args.tail is not None:
        kw["pf_max_iter"] = args.tail
    core = make_core(pf_method=args.pf, **kw)
    env = BatchedEnv(core, batch_size=args.batch, auto_reset=args.auto_reset, auto_reset_mode=args.auto_reset_mode)
    spec = core.spec
    solver_path = resolve_solver_path(
        spec, args.pf, np.zeros((args.batch, spec.n_des), spec.dtype), np.zeros((args.batch, spec.n_load), spec.dtype)
    )

    key = jax.random.PRNGKey(0)
    k_reset, k_run = jax.random.split(key)
    t0 = time.time()
    es, _ = env.reset(k_reset)
    jax.block_until_ready(es)
    reset_s = time.time() - t0
    # The rollout carries (and returns) the lean state when observations
    # come from the state vector; compile for that signature once.
    if core.obs_from_state_vec:
        es = core.lean(es)
    t0 = time.time()
    run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=args.steps)).lower(es, k_run).compile()
    compile_s = time.time() - t0
    es_w, (rew, term) = run(es, k_run)  # warm-up
    jax.block_until_ready(rew)

    # FLOP accounting: XLA's cost analysis of the compiled program plus the
    # analytic count of the power-flow loop it cannot see.
    xla_flops = None
    ca = run.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if ca and "flops" in ca:
        xla_flops = float(ca["flops"])
    if args.auto_reset:
        # Pool mode runs one extra reset-transition per scan segment
        # (T + 1 transitions per T steps); step mode one per step (2T).
        transitions_per_step = (args.steps + 1) / args.steps if args.auto_reset_mode == "pool" else 2
    else:
        transitions_per_step = 1
    pf_flops_step = analytic_flops_per_step(core, solver_path, transitions_per_step)

    keys = list(jax.random.split(k_run, args.iters))  # materialized outside the timed region
    if args.profile:
        jax.profiler.start_trace(args.profile)

    # (a) Blocking per-call median: the latency of one program call.
    times = []
    for i in range(args.iters):
        t0 = time.perf_counter()
        es, (rew, term) = run(es, keys[i])
        jax.block_until_ready(rew)
        times.append(time.perf_counter() - t0)

    # (b) Pipelined steady state (the headline): dispatch all programs
    # back-to-back and block once; host dispatch overlaps device compute.
    trial_times = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        for i in range(args.iters):
            es, (rew, term) = run(es, keys[i])
        jax.block_until_ready(rew)
        trial_times.append(time.perf_counter() - t0)

    if args.profile:
        jax.profiler.stop_trace()

    elapsed = statistics.median(trial_times)
    sps_blocking = args.batch * args.steps / statistics.median(times)
    sps = args.batch * args.steps * args.iters / elapsed
    rew_h = np.asarray(rew)
    term_h = np.asarray(term)
    budget = core.max_iter + (core.chord_iters if args.pf == "hybrid" else 0)
    mem = run.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    detail = {
        "env": args.env,
        "batch": args.batch,
        "scan_steps": args.steps,
        "iters": args.iters,
        "auto_reset": bool(args.auto_reset),
        "auto_reset_mode": args.auto_reset_mode if args.auto_reset else None,
        "pf_method": args.pf,
        "solver_path": solver_path,
        "nr_iteration_budget": budget,
        "elapsed_s": elapsed,
        "blocking_steps_per_s": sps_blocking,
        "reset_s": reset_s,
        "compile_s": compile_s,
        "compile_cache": cache_dir,
        "device": device,
        "mean_reward": float(rew_h.mean()),
        "terminated_frac": float(term_h.mean()),
        "xla_flops_per_env_step": None if xla_flops is None else xla_flops / (args.batch * args.steps),
        "pf_analytic_flops_per_env_step": float(pf_flops_step),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    if args.check:
        # Replay the committed host-f64 (s0, actions, vars) trajectory
        # through the benched solver and compare states, rewards and
        # terminations step by step (gym_anm_tpu/check.py).
        from gym_anm_tpu import check as parity_check

        detail["parity"] = parity_check.run_check(args.env, make_core, methods={args.pf: dict(kw)})

    result = {
        "metric": "env-steps/s",
        "value": sps,
        "unit": "steps/s",
        "vs_baseline": sps / 1e6,
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "solver_path": solver_path,
    }
    if args.check:
        result["parity_pass"] = detail["parity"]["pass"]
    print(json.dumps(result))
    print(json.dumps({"detail": detail}), file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({**result, "argv": sys.argv[1:], "detail": detail}, fh, indent=1)
            fh.write("\n")
    if args.check and not detail["parity"]["pass"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
