#!/usr/bin/env python
"""Multi-process ``jax.distributed`` scaling simulation.

Simulates a 2-host deployment on one machine: two OS processes, each
owning 4 virtual CPU devices, joined through ``jax.distributed.initialize``
into one 8-device global mesh.  Each process steps its shard of a batched
ANM6Easy fleet (data is process-local: ``jax.make_array_from_process_local_data``)
and the cross-process mean reward is produced by an XLA collective over the
process boundary -- the same program shape as a real multi-host deployment
(SURVEY.md §4: multi-host behavior via jax.distributed simulation).

Usage (coordinator spawns the workers):

    python scripts/multiproc_dist.py            # spawns 2 workers, checks results
    python scripts/multiproc_dist.py --worker I # internal: worker process I
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
DEV_PER_PROC = 4
PORT = 49717


def worker(proc_id: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", DEV_PER_PROC)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=N_PROC,
        process_id=proc_id,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.batched import BatchedEnv

    n_global = N_PROC * DEV_PER_PROC
    assert len(jax.devices()) == n_global, (proc_id, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()).reshape(n_global), ("dp",))
    sharding = NamedSharding(mesh, P("dp"))

    per_dev = 64
    B = per_dev * n_global
    core = make_core(pf_method="scan")
    env = BatchedEnv(core, batch_size=B)

    # Build the global sharded env state from process-local resets: each
    # process initializes only its own lanes (as a real host would).
    local_B = per_dev * DEV_PER_PROC
    local_env = BatchedEnv(core, batch_size=local_B)
    es_local, _ = local_env.reset(jax.random.fold_in(jax.random.PRNGKey(0), proc_id))
    es = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)), es_local
    )

    run = jax.jit(env.rollout_fn(policy_fn=None, n_steps=8))
    es, (rew, term) = run(es, jax.random.PRNGKey(42))
    # Cross-process reduction: mean over the dp-sharded [T, B] rewards.
    mean_r = float(np.asarray(jnp.mean(rew).reshape(1))[0])
    term_frac = float(np.asarray(jnp.mean(term.astype(jnp.float32)).reshape(1))[0])
    print(
        json.dumps(
            {
                "proc": proc_id,
                "global_devices": len(jax.devices()),
                "local_devices": len(jax.local_devices()),
                "batch": B,
                "mean_reward": round(mean_r, 6),
                "terminated_frac": round(term_frac, 6),
            }
        ),
        flush=True,
    )
    jax.distributed.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return

    procs = [
        subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--worker", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO,
        )
        for i in range(N_PROC)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    results = []
    for out, p in zip(outs, procs):
        lines = [l for l in out.splitlines() if l.startswith("{")]
        if p.returncode != 0 or not lines:
            print("WORKER FAILED:\n", out[-3000:])
            sys.exit(1)
        results.append(json.loads(lines[-1]))

    # Both processes must see the same global result (it is a collective).
    assert results[0]["mean_reward"] == results[1]["mean_reward"], results
    assert results[0]["global_devices"] == N_PROC * DEV_PER_PROC
    assert results[0]["local_devices"] == DEV_PER_PROC
    print(json.dumps({"multiprocess_ok": True, "procs": results}))


if __name__ == "__main__":
    main()
