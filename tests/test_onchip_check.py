"""The on-device trajectory-parity harness (gym_anm_tpu/check.py),
validated on CPU: in float64 the committed references must reproduce
exactly (they were generated by this very path), and in float32 -- the
production accelerator dtype -- every solver path must pass the calibrated
tolerances.  The GPU run of the same harness is ``bench.py --check``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gym_anm_tpu import check
from gym_anm_tpu.envs.anm6.anm6_easy import make_core as make_anm6
from gym_anm_tpu.envs.feeder33 import make_core as make_f33


def test_reference_artifacts_committed():
    for env_name in check.CHECK_CONFIG:
        data = check.load_reference(env_name)
        cfg = check.CHECK_CONFIG[env_name]
        assert data["state_vec"].shape[:2] == (cfg["T"], cfg["B"])
        assert data["terminated"].dtype == bool
        # The termination signal must discriminate (unlike the
        # throughput loop's 0.998 saturated signal); feeder141 is
        # feasible-by-construction so 0 is expected there.
        frac = float(data["terminated"][-1].mean())
        if env_name == "feeder141":
            assert frac == 0.0
        else:
            assert 0.2 <= frac <= 0.8, (env_name, frac)


def test_f64_scan_reproduces_reference_exactly():
    res = check.run_check("anm6easy", make_anm6, methods={"scan": {}})
    assert res["pass"]
    # f64 replay of the generating path: only f32-storage rounding remains.
    assert res["scan"]["term_mismatch_frac"] == 0.0
    assert res["scan"]["max_state_div"] < 1e-6
    assert res["scan"]["max_reward_div"] < 1e-6


def test_f32_all_paths_pass_anm6easy():
    methods = {m: dict(kw, dtype=jnp.float32) for m, kw in check.CHECK_CONFIG["anm6easy"]["methods"].items()}
    res = check.run_check("anm6easy", make_anm6, methods=methods)
    assert res["pass"], res


@pytest.mark.slow
def test_f32_paths_pass_feeder33():
    methods = {m: dict(kw, dtype=jnp.float32) for m, kw in check.CHECK_CONFIG["feeder33"]["methods"].items()}
    res = check.run_check("feeder33", make_f33, methods=methods)
    assert res["pass"], res


def test_compare_trajectories_flags_divergence():
    T, B, n = 4, 8, 3
    rng = np.random.default_rng(0)
    sv = rng.normal(size=(T, B, n))
    rw = rng.normal(size=(T, B))
    tm = np.zeros((T, B), dtype=bool)
    ref = {"state_vec": sv, "reward": rw, "terminated": tm}

    # Identical -> pass.
    res = check.compare_trajectories(ref, {k: v.copy() for k, v in ref.items()})
    assert res["pass"] and res["max_state_div"] == 0.0

    # A large state error on a live lane -> fail.
    sv2 = sv.copy()
    sv2[2, 3, 1] += 10.0
    res = check.compare_trajectories(ref, {"state_vec": sv2, "reward": rw, "terminated": tm})
    assert not res["pass"] and res["max_state_div"] > 0.1

    # The same error on a lane whose termination history already diverged
    # is not compared (the lane is excluded and counted as a mismatch).
    tm2 = tm.copy()
    tm2[1:, 3] = True
    res = check.compare_trajectories(ref, {"state_vec": sv2, "reward": rw, "terminated": tm2})
    assert res["max_state_div"] == 0.0
    assert res["term_mismatch_frac"] == pytest.approx(1 / 8)
    assert not res["pass"]  # 12.5% termination mismatch > 2% budget

    # Termination mismatch within budget still passes.
    big = np.zeros((T, 128), dtype=bool)
    ref_big = {
        "state_vec": np.zeros((T, 128, n)),
        "reward": np.zeros((T, 128)),
        "terminated": big,
    }
    got_tm = big.copy()
    got_tm[3, 0] = True  # 1/128 < 2%
    res = check.compare_trajectories(
        ref_big, {"state_vec": np.zeros((T, 128, n)), "reward": np.zeros((T, 128)), "terminated": got_tm}
    )
    assert res["pass"] and res["term_mismatch_frac"] == pytest.approx(1 / 128, abs=1e-6)
