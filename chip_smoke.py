#!/usr/bin/env python
"""Smoke check of the simulator's main path on a GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the dp=4 phase on four cards, and nothing else
    JAX_PLATFORMS=cpu python chip_smoke.py   # CPU rehearsal at tiny sizes (exits 1)

Phases, in one process:

1. device  -- the default JAX device must be a GPU.
2. kernel  -- the tree power-flow solver that ``pf_method="tree"`` dispatches
   to (the CUDA kernel on a GPU) against the XLA tree solver in float32 on
   the host CPU and the NumPy walk in float64, on the same injections, at
   full width on all three networks; plus a batch that is not a multiple of
   the kernel's block (tail masking).
3. rollout -- ``make_core()`` + ``BatchedEnv`` rollouts (B lanes x T steps,
   uniform-random actions) on anm6easy, feeder33 and feeder141.
4. parity  -- the committed host-float64 trajectories replayed through the
   default solver (``gym_anm_tpu.check``) on all three networks.
5. ppo     -- a few ``PPOTrainer`` steps at the ``rl/`` defaults on anm6easy.

Every phase prints one JSON line.  The card's ``nvidia-smi`` name and power
limit are printed as a line of their own, and the last line is
``{"ok": true, "device": {...}}`` -- only when every phase passed on a GPU.
Any failure raises, so the script exits non-zero without that line.
"""

import argparse
import json
import sys
import time

import numpy as np

T0 = time.time()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1), **fields}, default=str), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def sizes(rehearsal):
    # Full size on the card; a tiny rehearsal on the CPU.
    return dict(B=64, T=4, tail_B=65, ppo_B=64, ppo_steps=2) if rehearsal else dict(
        B=4096, T=64, tail_B=4097, ppo_B=4096, ppo_steps=3
    )


def makers():
    from gym_anm_tpu.envs.anm6.anm6_easy import make_core as anm6easy
    from gym_anm_tpu.envs.feeder33 import make_core as feeder33
    from gym_anm_tpu.envs.feeder141 import make_core as feeder141

    return {"anm6easy": anm6easy, "feeder33": feeder33, "feeder141": feeder141}


def memory(compiled):
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys}


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def compare(name, got, ref, tol):
    """Kernel against a reference at gym_anm_tpu.check's solver tolerances
    (stated there with their reasons)."""
    from gym_anm_tpu import check as parity

    res = parity.compare_solves(got, ref, tol)
    check(res["pass"], "%s: %s" % (name, res))
    return res


def phase_kernel(z, rehearsal):
    import jax
    import jax.numpy as jnp

    from gym_anm_tpu import check as parity
    from gym_anm_tpu.core.transition import resolve_solver_path
    from gym_anm_tpu.ops import tree_cuda
    from gym_anm_tpu.ops.tree_nr import build_tree_info, solve_pfe_tree

    cpu = jax.devices("cpu")[0]
    if not rehearsal:
        t0 = time.time()
        emit("kernel_build", library=tree_cuda.build(), seconds=time.time() - t0)
    for env, make in makers().items():
        core = make()
        spec = core.spec
        tol, mi = core.x_tol, core.max_iter
        tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
        sched = tree_cuda.pack_schedule(tree)
        path = resolve_solver_path(spec, "tree", np.zeros((1, spec.n_des), spec.dtype), np.zeros((1, spec.n_load), spec.dtype))
        check(rehearsal or path == "cuda_tree", "%s: tree dispatches to %s on the GPU" % (env, path))

        def solve(p, q):
            if path == "cuda_tree":
                return tree_cuda.solve_pfe_tree_cuda(sched, p, q, x_tol=tol, max_iter=mi)
            return solve_pfe_tree(tree, p, q, x_tol=tol, max_iter=mi)

        p, q = parity.random_injections(core, z["tail_B"], seed=1)
        B = z["B"]
        pd, qd = jax.device_put((p[:B], q[:B]))
        t0 = time.time()
        f = jax.jit(solve).lower(pd, qd).compile()
        compile_s = time.time() - t0
        out = jax.block_until_ready(f(pd, qd))
        run_s = []  # one solve, inputs and outputs on the device
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(pd, qd))
            run_s.append(time.perf_counter() - t0)
        run_s = min(run_s)
        got = tuple(np.asarray(x) for x in (out[0], out[1], out[2], out[3]))

        with jax.default_device(cpu):
            xo = jax.jit(lambda p, q: solve_pfe_tree(tree, p, q, x_tol=tol, max_iter=mi))(p[:B], q[:B])
            xla = tuple(np.asarray(x) for x in (xo[0], xo[1], xo[2], xo[3]))
        ref64 = tree_cuda.tree_walk_reference(sched, p[:B], q[:B], tol, mi, dtype=np.float64)

        # Tail: one lane past the block multiple; the first B lanes must be
        # bit-identical to the full-block run (lanes are independent).
        tail = jax.block_until_ready(jax.jit(solve)(jnp.asarray(p), jnp.asarray(q)))
        tail_vr = np.asarray(tail[0])
        check(np.array_equal(tail_vr[:B], got[0], equal_nan=True), "%s: tail batch changed the first %d lanes" % (env, B))
        t64 = tree_cuda.tree_walk_reference(sched, p[B:], q[B:], tol, mi, dtype=np.float64)
        tail_cmp = compare(env + " tail", tuple(np.asarray(x)[B:] for x in tail[:4]), t64, tol)

        emit(
            "kernel",
            env=env,
            solver_path=path,
            batch=B,
            compile_s=compile_s,
            run_s=run_s,
            converged=float((got[2] <= tol).mean()),
            iters_mean=float(got[3].mean()),
            vs_xla_tree_f32_cpu=compare(env + " vs xla_tree", got, xla, tol),
            vs_walk_f64=compare(env + " vs f64", got, ref64, tol),
            tail_batch=z["tail_B"],
            tail_vs_walk_f64=tail_cmp,
        )


def phase_rollout(z):
    import jax

    from gym_anm_tpu.core.transition import resolve_solver_path
    from gym_anm_tpu.envs.batched import BatchedEnv

    for env_name, make in makers().items():
        core = make()
        spec = core.spec
        env = BatchedEnv(core, batch_size=z["B"])
        key_reset, key_run = jax.random.split(jax.random.PRNGKey(0))
        t0 = time.time()
        es, _ = env.reset(key_reset)
        es = core.lean(es) if core.obs_from_state_vec else es
        jax.block_until_ready(es)
        reset_s = time.time() - t0
        t0 = time.time()
        run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=z["T"])).lower(es, key_run).compile()
        compile_s = time.time() - t0
        jax.block_until_ready(run(es, key_run))
        t0 = time.perf_counter()
        es, (rew, term) = run(es, jax.random.PRNGKey(1))
        rew = np.asarray(jax.block_until_ready(rew))
        seconds = time.perf_counter() - t0
        term = np.asarray(term)
        check(rew.shape == (z["T"], z["B"]) and np.isfinite(rew).all(), "%s: rewards not finite [T, B]" % env_name)
        check(term.mean() < 1.0, "%s: every lane terminated" % env_name)
        emit(
            "rollout",
            env=env_name,
            solver_path=resolve_solver_path(spec, core.pf_method, np.zeros((1, spec.n_des), spec.dtype), np.zeros((1, spec.n_load), spec.dtype)),
            batch=z["B"],
            steps=z["T"],
            reset_s=reset_s,
            compile_s=compile_s,
            seconds=seconds,
            env_steps_per_s=z["B"] * z["T"] / seconds,
            mean_reward=float(rew.mean()),
            terminated_frac=float(term.mean()),
            memory=memory(run),
            peak_bytes_in_use=peak_bytes(),
        )


def phase_parity():
    from gym_anm_tpu import check as parity

    for env, make in makers().items():
        t0 = time.time()
        res = parity.run_check(env, make, methods={"tree": {}})
        emit("parity", env=env, seconds=time.time() - t0, **res)
        check(res["pass"], "%s: parity check failed" % env)


def phase_ppo(z, rehearsal):
    import jax

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.rl import PPOConfig, PPOTrainer
    from gym_anm_tpu.rl import mlp

    cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1, hidden=(32, 32)) if rehearsal else PPOConfig()
    trainer = PPOTrainer(make_core(), batch_size=z["ppo_B"], config=cfg, seed=0)
    key = jax.random.PRNGKey(3)
    es = trainer.init_envs(jax.random.fold_in(key, 0))
    params, opt = trainer.params, trainer.opt_state
    t0 = time.time()
    compiled = trainer._train_step.lower(params, opt, es, key).compile()
    compile_s = time.time() - t0
    # The first step takes the reset's full EnvState and returns the
    # rollout's lean carry, so the jitted step compiles once per form; the
    # last step is steady state.
    losses, secs = [], []
    for i in range(z["ppo_steps"]):
        t0 = time.perf_counter()
        params, opt, es, metrics = trainer._train_step(params, opt, es, jax.random.fold_in(key, i + 1))
        loss = float(jax.block_until_ready(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        check(np.isfinite(loss), "ppo: non-finite loss")
    emit(
        "ppo",
        env="anm6easy",
        batch=z["ppo_B"],
        config={k: getattr(cfg, k) for k in ("rollout_steps", "minibatches", "epochs", "hidden")},
        matmul_precision=str(mlp.MATMUL_PRECISION),
        compile_s=compile_s,
        step_seconds=secs,
        losses=losses,
        mean_reward=float(metrics["mean_reward"]),
        memory=memory(compiled),
        peak_bytes_in_use=peak_bytes(),
    )


def phase_four_cards(rehearsal):
    """dp=4: a sharded feeder33 rollout compared lane by lane with the
    one-card run from the same keys, and a PPO train step whose gradient
    all-reduce is asserted in the HLO, its loss compared with one card."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core as make_anm6
    from gym_anm_tpu.envs.batched import BatchedEnv
    from gym_anm_tpu.envs.feeder33 import make_core as make_f33
    from gym_anm_tpu.rl import PPOConfig, PPOTrainer

    devices = jax.devices()
    check(len(devices) >= 4, "four cards needed, found %d" % len(devices))
    mesh = Mesh(np.asarray(devices[:4]), ("dp",))
    lanes = NamedSharding(mesh, P("dp"))
    one = devices[0]
    per_card, T = (16, 4) if rehearsal else (4096, 64)
    B = 4 * per_card

    def collectives(compiled):
        text = compiled.as_text()
        return {k: text.count(k + "(") + text.count(k + "-start(") for k in ("all-gather", "all-reduce", "all-to-all", "collective-permute")}

    core = make_f33()
    env = BatchedEnv(core, batch_size=B)
    k_reset, k_run = jax.random.split(jax.random.PRNGKey(0))
    run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=T))
    with jax.default_device(one):
        es1, _ = env.reset(k_reset)
        es1 = core.lean(es1)
        _, (r1, t1) = run(es1, k_run)
        r1, t1 = np.asarray(r1), np.asarray(t1)
    es4 = jax.device_put(es1, lanes)
    c4 = run.lower(es4, k_run).compile()
    t0 = time.perf_counter()
    _, (r4, t4) = c4(es4, k_run)
    r4 = jax.block_until_ready(r4)
    r4_sharding = str(r4.sharding)
    r4 = np.asarray(r4)
    seconds = time.perf_counter() - t0
    t4 = np.asarray(t4)
    # The same kernel on the same lanes: terminations must agree exactly and
    # rewards to float32 rounding (XLA may fuse the per-card program's
    # elementwise tail differently from the one-card program's).
    term_same = bool(np.array_equal(t1, t4))
    live = ~t1
    rdiff = float(np.abs(r1 - r4)[live].max()) if live.any() else 0.0
    coll = collectives(c4)
    emit(
        "dp4_rollout",
        env="feeder33",
        lanes=B,
        steps=T,
        seconds=seconds,
        terminations_identical=term_same,
        max_reward_diff=rdiff,
        collectives=coll,
        reward_sharding=r4_sharding,
    )
    check(term_same, "dp4 rollout: terminations differ from one card")
    check(rdiff <= 1e-4 * max(1.0, float(np.abs(r1).max())), "dp4 rollout: rewards differ by %g" % rdiff)
    check(sum(coll.values()) == 0, "dp4 rollout: collectives in an embarrassingly parallel rollout %s" % coll)

    cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1, hidden=(32, 32)) if rehearsal else PPOConfig()
    trainer = PPOTrainer(make_anm6(), batch_size=B, config=cfg, seed=0)
    key = jax.random.PRNGKey(5)
    with jax.default_device(one):
        es = trainer.init_envs(jax.random.fold_in(key, 0))
        _, _, _, m1 = trainer._train_step(trainer.params, trainer.opt_state, es, key)
        loss1 = float(m1["loss"])
    repl = NamedSharding(mesh, P())
    es_s = jax.device_put(es, lanes)
    params = jax.device_put(trainer.params, repl)
    opt = jax.device_put(trainer.opt_state, repl)
    c = trainer._train_step.lower(params, opt, es_s, key).compile()
    coll = collectives(c)
    _, _, _, m4 = c(params, opt, es_s, key)
    loss4 = float(m4["loss"])
    # Tolerance: the learner's matmuls run in TF32 (rl/mlp.py) and the dp
    # step sums gradients per card then all-reduces, a different summation
    # order than one card; 32 Adam updates compound both.
    rel = abs(loss4 - loss1) / max(abs(loss1), 1e-6)
    emit("dp4_ppo", env="anm6easy", lanes=B, loss_one_card=loss1, loss_dp4=loss4, rel_diff=rel, collectives=coll)
    check(coll["all-reduce"] > 0, "dp4 ppo: no gradient all-reduce in the HLO")
    check(rel <= 2e-2, "dp4 ppo: loss differs from one card by %.3g" % rel)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true", help="run only the dp=4 phase (needs four cards)")
    args = ap.parse_args()

    import jax

    from gym_anm_tpu import runtime

    rehearsal = runtime.cpu_rehearsal()
    print(runtime.card_identity(), flush=True)
    device = runtime.require_gpu()
    emit(
        "device",
        **device,
        rehearsal=rehearsal,
        jax=jax.__version__,
        compile_cache=runtime.enable_compile_cache(),
        x64=bool(jax.config.jax_enable_x64),
    )
    if args.four_cards:
        phase_four_cards(rehearsal)
    else:
        z = sizes(rehearsal)
        phase_kernel(z, rehearsal)
        phase_rollout(z)
        phase_parity()
        phase_ppo(z, rehearsal)
    if rehearsal:
        print("CPU rehearsal finished: not a GPU run, so no result line", file=sys.stderr)
        sys.exit(1)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
