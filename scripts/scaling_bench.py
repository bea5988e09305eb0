#!/usr/bin/env python
"""Weak-scaling benchmark over a device mesh.

Shards the environment batch over 1..N devices (batch grows with the mesh)
and reports throughput + parallel efficiency. On a host without several
accelerators, run on a virtual host mesh for the scaling *shape*:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --platform cpu

Env stepping has no cross-device communication, so efficiency is bounded
only by compilation/partitioning overheads.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv
    from gym_anm_tpu.parallel.sharding import make_mesh, shard_batch

    n_total = len(jax.devices())
    results = []
    base_sps = None
    for nd in [d for d in (1, 2, 4, 8, 16) if d <= n_total]:
        B = args.per_device_batch * nd
        env = BatchedEnv(make_core(), batch_size=B)
        key = jax.random.PRNGKey(0)
        es, _ = env.reset(key)
        if nd > 1:
            es = shard_batch(es, make_mesh(nd))
        run = jax.jit(env.rollout_fn(n_steps=args.steps))
        es, (rew, _) = run(es, key)
        jax.block_until_ready(rew)
        times = []
        for i in range(args.iters):
            t0 = time.time()
            es, (rew, _) = run(es, jax.random.fold_in(key, i))
            jax.block_until_ready(rew)
            times.append(time.time() - t0)
        sps = B * args.steps / float(np.median(times))
        if base_sps is None:
            base_sps = sps
        eff = sps / (base_sps * nd)
        results.append({"devices": nd, "batch": B, "steps_per_s": round(sps), "efficiency": round(eff, 3)})
        print(json.dumps(results[-1]), flush=True)


if __name__ == "__main__":
    main()
