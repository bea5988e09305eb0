"""float32 (the accelerator dtype) vs float64 trajectory tolerance.

BASELINE.md: trajectories must match the reference bit-level in float64 and
tolerance-matched in float32.  Here the same action sequence drives an f32
core and an f64 core from the same initial state; observations must agree to
single-precision-appropriate tolerances over a 50-step rollout, and the
termination pattern must be identical.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gym_anm_tpu.envs.anm6.anm6_easy import make_core
from gym_anm_tpu.envs.batched import BatchedEnv


def test_f32_tracks_f64_trajectories():
    core64 = make_core(dtype=np.float64, pf_max_iter=10)
    core32 = make_core(dtype=np.float32, pf_max_iter=10)

    B, T = 16, 50
    env64 = BatchedEnv(core64, batch_size=B)
    env32 = BatchedEnv(core32, batch_size=B)
    key = jax.random.PRNGKey(0)
    # Identical initial states for both dtypes (the f32/f64 PRNG streams
    # draw different mantissa bits, so reset() sampling would diverge).
    s0 = jax.vmap(core64.init_state_fn)(jax.random.split(key, B))
    es64 = core64.env_state_from_s0(s0)
    es32 = core32.env_state_from_s0(np.asarray(s0, dtype=np.float32))
    o64 = core64.observation(es64)
    o32 = core32.observation(es32)
    np.testing.assert_allclose(np.asarray(o32), np.asarray(o64), atol=2e-3, rtol=1e-3)

    rng = np.random.default_rng(1)
    # Mildly-scaled actions (full random actions collapse lanes, where the
    # f32/f64 divergence step can differ by one due to the 1e-5 NR criterion
    # sitting near f32 resolution).
    mid = (core64.action_low + core64.action_high) / 2
    half = (core64.action_high - core64.action_low) / 2
    for t in range(T):
        a = mid + 0.3 * half * rng.uniform(-1, 1, (B, core64.action_n))
        k = jax.random.fold_in(key, t)
        es64, out64 = env64.step(es64, jnp.asarray(a), k)
        es32, out32 = env32.step(es32, jnp.asarray(a, dtype=np.float32), k)
        assert np.array_equal(np.asarray(out64.terminated), np.asarray(out32.terminated)), t
        np.testing.assert_allclose(
            np.asarray(out32.obs), np.asarray(out64.obs), atol=5e-3, rtol=1e-3, err_msg=f"t={t}"
        )
        np.testing.assert_allclose(
            np.asarray(out32.reward), np.asarray(out64.reward), atol=5e-3, rtol=1e-3, err_msg=f"t={t}"
        )
