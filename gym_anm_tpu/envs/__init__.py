from .batched import BatchedEnv
from .randomized import (
    MultiBatchedEnv,
    perturb_branches,
    ppo_trainer_for_fleet,
    sac_trainer_for_fleet,
    randomized_anm6easy_cores,
    randomized_feeder33_cores,
)

# The Gymnasium adapter classes load on first access, so the batched fast
# path (``make_core``, ``BatchedEnv``) imports without Gymnasium.
_ADAPTERS = {
    "ANMEnv": ".anm_env",
    "ANM6": ".anm6.anm6",
    "ANM6Easy": ".anm6.anm6",
    "ANMVectorEnv": ".vector",
    "Feeder33Env": ".feeder_envs",
    "Feeder141Env": ".feeder_envs",
}


def __getattr__(name):
    if name in _ADAPTERS:
        import importlib

        return getattr(importlib.import_module(_ADAPTERS[name], __name__), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


__all__ = [
    "ANMEnv",
    "ANM6",
    "ANM6Easy",
    "BatchedEnv",
    "ANMVectorEnv",
    "Feeder33Env",
    "Feeder141Env",
    "MultiBatchedEnv",
    "perturb_branches",
    "ppo_trainer_for_fleet",
    "sac_trainer_for_fleet",
    "randomized_anm6easy_cores",
    "randomized_feeder33_cores",
]
