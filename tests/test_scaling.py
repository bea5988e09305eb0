"""Enforced scaling checks.

The multi-device story is pure data parallelism over a 1-D ``env`` mesh
(parallel/sharding.py): env stepping is embarrassingly parallel, so weak
scaling (2x lanes on 2x devices in ~the same wall time) must hold.  These
tests turn the round-1/2 hand-run scaling evidence into suite-enforced
floors: sharding regressions (e.g. an op that silently gathers the batch
to one device) show up as an efficiency collapse here, and the 2-process
``jax.distributed`` simulation is exercised by the suite rather than by
hand.
"""

import json
import os
import subprocess
import sys
import time

import jax
import pytest

from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.envs.batched import BatchedEnv
from gym_anm_tpu.parallel.sharding import make_mesh, shard_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _best_time(run, es, key, n=3):
    """Best-of-n wall time of one compiled rollout call (robust to CI noise;
    the first call outside the loop absorbs compile + warmup)."""
    _, (rew, _) = run(es, key)
    jax.block_until_ready(rew)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _, (rew, _) = run(es, key)
        jax.block_until_ready(rew)
        ts.append(time.perf_counter() - t0)
    return min(ts)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
@pytest.mark.slow
def test_weak_scaling_efficiency_two_devices():
    """Weak-scaling floor: 2x lanes on a 2-device mesh must run at >= 0.65x
    the 1-device-per-lane-count rate (i.e. t(2B, 2 dev) <= t(B, 1 dev)/0.65).

    The floor is deliberately loose for CI hosts where virtual devices
    share physical cores (measured 0.79 standalone on this 2-core host,
    0.69 under full-suite contention); a sharding regression that gathers
    the batch onto one device costs ~2x (efficiency ~0.5) and still fails
    this clearly.
    """
    core = make_core(pf_max_iter=10)
    steps, B = 16, 512
    key = jax.random.PRNGKey(0)

    env1 = BatchedEnv(core, batch_size=B)
    es1, _ = env1.reset(key)
    es1 = shard_batch(es1, make_mesh(1))
    run1 = jax.jit(env1.rollout_fn(n_steps=steps))
    t1 = _best_time(run1, es1, key)

    env2 = BatchedEnv(core, batch_size=2 * B)
    es2, _ = env2.reset(key)
    es2 = shard_batch(es2, make_mesh(2))
    run2 = jax.jit(env2.rollout_fn(n_steps=steps))
    t2 = _best_time(run2, es2, key)

    efficiency = t1 / t2
    assert efficiency >= 0.65, (
        f"2-device weak-scaling efficiency {efficiency:.2f} < 0.65 "
        f"(t1={t1*1e3:.1f} ms for B={B} on 1 dev, t2={t2*1e3:.1f} ms for B={2*B} on 2 devs)"
    )


@pytest.mark.slow
def test_multiprocess_distributed_simulation():
    """The 2-process jax.distributed scaling sim (scripts/multiproc_dist.py)
    must pass: 2 OS processes x 4 virtual CPU devices joined into one
    8-device mesh, each stepping its own lanes, with the cross-process mean
    reward produced by an XLA collective and identical in both processes."""
    env = os.environ.copy()
    # The workers configure their own device counts; the suite's 8-virtual-
    # device XLA_FLAGS must not leak into them.
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-u", os.path.join(REPO, "scripts", "multiproc_dist.py")],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=REPO,
        env=env,
    )
    assert r.returncode == 0, f"multiproc_dist failed:\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}"
    lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    assert lines, r.stdout
    data = json.loads(lines[-1])
    assert data["multiprocess_ok"] is True
    assert data["procs"][0]["mean_reward"] == data["procs"][1]["mean_reward"]
