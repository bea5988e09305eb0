"""The batched main path imports only JAX, NumPy, SciPy, Optax and Chex;
the Gymnasium adapter is a layer its own users import."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_main_path_without_gymnasium_or_flax():
    code = """
import sys
for name in ("gymnasium", "flax", "websocket", "requests"):
    sys.modules[name] = None  # any import of these now raises
import jax, jax.numpy as jnp
from gym_anm_tpu.envs.anm6.anm6_easy import make_core as m6
from gym_anm_tpu.envs.feeder33 import make_core as m33
from gym_anm_tpu.envs.feeder141 import make_core as m141
from gym_anm_tpu.envs.batched import BatchedEnv
from gym_anm_tpu import check, rl, runtime
from gym_anm_tpu.rl import PPOConfig, PPOTrainer
core = m6()
env = BatchedEnv(core, batch_size=4)
es, _ = env.reset(jax.random.PRNGKey(0))
es, out = env.step(es, jnp.zeros((4, core.action_n), core.spec.dtype), jax.random.PRNGKey(1))
m33(); m141()
PPOTrainer(core, batch_size=4, config=PPOConfig(hidden=(8,)))
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_adapter_classes_load_on_access():
    code = """
import sys
import gym_anm_tpu.envs as envs
assert "gym_anm_tpu.envs.anm_env" not in sys.modules
assert "gym_anm_tpu.envs.feeder_envs" not in sys.modules
cls = envs.Feeder141Env
assert "gym_anm_tpu.envs.feeder_envs" in sys.modules and cls.__name__ == "Feeder141Env"
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_gym_ids_registered_with_gymnasium():
    gym = pytest.importorskip("gymnasium")
    import gym_anm_tpu  # noqa: F401
    from gym_anm_tpu.envs import ANM6Easy, Feeder33Env, Feeder141Env

    for env_id, cls in (("ANM6Easy-v0", ANM6Easy), ("ANMFeeder33-v0", Feeder33Env), ("ANMFeeder141-v0", Feeder141Env)):
        spec = gym.spec(env_id)
        assert gym.envs.registration.load_env_creator(spec.entry_point) is cls
