#!/usr/bin/env python
"""Regenerate the committed feeder141 replay artifact
(docs/assets/replay_feeder141.html): a 24-step random-action episode on the
141-bus network, recorded through the offline replay path
(render/replay.py) into one standalone HTML file.  Structural verification
lives in tests/test_replay_artifact.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    from gym_anm_tpu.envs import Feeder141Env

    env = Feeder141Env(seed=3)
    env.reset(seed=3)
    env.render(mode="replay")
    rng = np.random.default_rng(0)
    lo, hi = env.action_space.low, env.action_space.high
    for _ in range(24):
        a = (lo + rng.uniform(0, 1, env.action_space.shape) * (hi - lo)).astype(np.float32)
        _, _, term, _, _ = env.step(a)
        env.render()
        if term:
            break
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "docs", "assets", "replay_feeder141.html")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    print("wrote", env.write_replay(out))


if __name__ == "__main__":
    main()
