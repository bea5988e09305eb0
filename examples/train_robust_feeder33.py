"""Long-horizon robust training on the 33-bus feeder: PPO and SAC over a
domain-randomized fleet.

One policy is trained against G grid variants (nominal + lognormal branch
impedance jitter) stepped inside a single XLA program — the setup the
reference cannot express at all (its envs bind one network dict each;
cf. /root/reference/gym_anm/envs/anm6_env/anm6.py:24-40).  Histories are
written as JSON so reward curves can be compared across runs.

Run on a GPU:  python -u examples/train_robust_feeder33.py --algo ppo
"""

import argparse
import json
import time

import jax

from gym_anm_tpu.envs import randomized_feeder33_cores, ppo_trainer_for_fleet, sac_trainer_for_fleet
from gym_anm_tpu.rl import PPOConfig, SACConfig


def run_ppo(iterations, n_variants, lanes, seed=0, out=None):
    cores = randomized_feeder33_cores(n_variants, seed=seed, r_sigma=0.15, x_sigma=0.15)
    trainer = ppo_trainer_for_fleet(cores, lanes, config=PPOConfig(rollout_steps=64))
    t0 = time.time()
    history = trainer.train(iterations, key=jax.random.PRNGKey(seed))
    elapsed = time.time() - t0
    steps = iterations * n_variants * lanes * trainer.cfg.rollout_steps
    _report("ppo", history, steps, elapsed, out)
    return history


def run_sac(iterations, n_variants, lanes, seed=0, out=None, warmup_rounds=2):
    cores = randomized_feeder33_cores(n_variants, seed=seed, r_sigma=0.15, x_sigma=0.15)
    trainer = sac_trainer_for_fleet(cores, lanes, config=SACConfig())
    t0 = time.time()
    history = trainer.train(iterations, key=jax.random.PRNGKey(seed), warmup_rounds=warmup_rounds)
    elapsed = time.time() - t0
    # The uniform-collect warmup rounds are real environment steps too;
    # elapsed also includes first-iteration compile time (noted in _report).
    steps = (iterations + warmup_rounds) * n_variants * lanes * trainer.cfg.collect_steps
    _report("sac", history, steps, elapsed, out)
    return history


def _report(algo, history, env_steps, elapsed, out):
    for i, m in enumerate(history):
        if i % max(1, len(history) // 25) == 0 or i == len(history) - 1:
            extra = f" term={m['terminated_frac']:.3f}" if "terminated_frac" in m else ""
            print(f"{algo} iter {i}: mean_reward={m['mean_reward']:+.3f}{extra}")
    rate = env_steps / elapsed
    print(
        f"{algo}: {env_steps} env steps in {elapsed:.1f}s "
        f"({rate:,.0f} steps/s incl. updates, warmup and compile time)"
    )
    if out:
        with open(out, "w") as f:
            json.dump({"algo": algo, "env_steps": env_steps, "elapsed_s": elapsed, "history": history}, f)
        print(f"wrote {out}")


if __name__ == "__main__":
    from gym_anm_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="ppo", choices=["ppo", "sac", "both"])
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--variants", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--out", default=None, help="JSON history path (prefix when --algo both)")
    args = ap.parse_args()
    if args.algo in ("ppo", "both"):
        run_ppo(args.iterations, args.variants, args.lanes, out=(args.out and args.out + "_ppo.json") or None)
    if args.algo in ("sac", "both"):
        run_sac(args.iterations, args.variants, args.lanes, out=(args.out and args.out + "_sac.json") or None)
