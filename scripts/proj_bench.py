#!/usr/bin/env python
"""Microbenchmark of the exact set-point projection on the default device.

Times :func:`gym_anm_tpu.ops.projection.project_polytope_lanes` (the one
projection form the transition runs) over a 64-step scan at ANM6's device
polytopes, so a change to it can be measured apart from the rest of the
step.  A GPU run reports device time; a CPU run only checks that it runs.

Usage: python -u scripts/proj_bench.py [--batch 4096] [--steps 64]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--iters", type=int, default=7)
    args = ap.parse_args()

    from gym_anm_tpu import runtime
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.envs.anm6.network import network
    from gym_anm_tpu.ops.projection import project_polytope_lanes

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    spec, _ = build_grid(network, 0.25, 100, dtype=np.float32)
    G = np.concatenate([np.asarray(spec.gen_G), np.asarray(spec.des_G)], axis=0)
    C, m, _ = G.shape
    B = args.batch
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.uniform(-1, 1, (C, B)).astype(np.float32))
    py = jnp.asarray(rng.uniform(-1, 1, (C, B)).astype(np.float32))
    h0 = np.concatenate([np.asarray(spec.gen_h0), np.asarray(spec.des_h0)], 0).astype(np.float32)
    h_np = np.broadcast_to(h0[:, :, None], (C, m, B)).copy()
    h_np[:, 2, :] = rng.uniform(0.0, 0.6, (C, B))
    h_np[:, 9, :] = rng.uniform(-0.1, 0.5, (C, B))
    h = jnp.asarray(h_np)

    def run(px, py, h):
        def body(c, _):
            x, y = project_polytope_lanes(c[0], c[1], G, h)
            return (x * 0.99 + 0.01 * px, y * 0.99 + 0.01 * py), None

        (x, y), _ = jax.lax.scan(body, (px, py), None, length=args.steps)
        return x, y

    jf = jax.jit(run)
    jax.block_until_ready(jf(px, py, h))
    ts = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(px, py, h))
        ts.append(time.perf_counter() - t0)
    med = sorted(ts)[len(ts) // 2]
    print(f"{device['kind']}: {med * 1e3:.3f} ms/call ({med / args.steps * 1e6:.2f} us/step) at B={B}")


if __name__ == "__main__":
    main()
