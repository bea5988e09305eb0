"""gym-anm-tpu: a JAX framework for RL environments that model Active
Network Management tasks in AC electricity distribution networks.

A ground-up JAX/XLA redesign with the full capability surface of
robinhenry/gym-anm: the physics simulator is a pure-functional, jit-compiled
state transition that runs thousands of lockstep environments and shards
over device meshes, while the Gymnasium API, the network-dict input format,
the observation mini-language, and the MPC baseline agents remain drop-in
compatible with the reference.

The batched path (``make_core``, ``BatchedEnv``, ``rl``, ``check``) needs
only JAX, NumPy, SciPy, Optax and Chex.  The Gymnasium adapter classes load
on first access, and the ``gym.make`` ids are registered when Gymnasium is
installed.
"""

from .agents import MPCAgent, MPCAgentConstant, MPCAgentPerfect
from .simulator import Simulator


def __getattr__(name):
    if name in ("ANMEnv", "ANM6", "ANM6Easy"):
        from . import envs

        return getattr(envs, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


# Tag-derived version via setuptools-scm (see pyproject.toml); when running
# from a source checkout that was never pip-installed, fall back to a local
# marker rather than failing at import time.
try:
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("gym-anm-tpu")
except Exception:  # PackageNotFoundError, or stdlib metadata unavailable
    __version__ = "0.0.0+local"

try:
    from gymnasium.envs.registration import register
except ImportError:  # Gymnasium is an optional extra
    register = None
if register is not None:
    register(id="ANM6Easy-v0", entry_point="gym_anm_tpu.envs:ANM6Easy")
    register(id="ANMFeeder33-v0", entry_point="gym_anm_tpu.envs:Feeder33Env")
    register(id="ANMFeeder141-v0", entry_point="gym_anm_tpu.envs:Feeder141Env")

__all__ = [
    "ANMEnv",
    "ANM6",
    "ANM6Easy",
    "Simulator",
    "MPCAgent",
    "MPCAgentConstant",
    "MPCAgentPerfect",
]
