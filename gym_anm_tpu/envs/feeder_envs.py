"""Gymnasium environments on the synthetic feeders (33 and 141 buses).

The host-side adapters of :mod:`gym_anm_tpu.envs.feeder33` and
:mod:`gym_anm_tpu.envs.feeder141`; the batched fast path there
(``make_core``) does not need this module or Gymnasium.
"""

from __future__ import annotations

import numpy as np

from .anm_env import ANMEnv
from .feeder33 import _NETWORK, _daily_factor
from .feeder141 import _NETWORK as _NETWORK_141


class Feeder33Env(ANMEnv):
    """Gymnasium environment on the 33-bus feeder with stochastic loads
    (Ornstein-Uhlenbeck-like mean-reverting noise around a daily profile)
    and renewable potentials."""

    def __init__(self, seed=None, network=None):
        observation = "state"
        K = 1
        delta_t = 0.25
        gamma = 0.995
        lamb = 100
        aux_bounds = np.array([[0, 95]])
        costs_clipping = (1, 100)
        net = _NETWORK if network is None else network
        super().__init__(net, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed)
        spec = self.simulator.spec
        self._load_scale = -np.asarray(spec.load_p_min) * spec.baseMVA
        self._pv_scale = np.asarray(spec.gen_p_max) * spec.baseMVA

    def init_state(self):
        spec = self.simulator.spec
        n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)
        t0 = self.np_random.integers(0, 96)
        state[-1] = t0
        frac = _daily_factor(t0)
        loads = -self._load_scale * frac * self.np_random.uniform(0.3, 0.9, spec.n_load)
        pos = np.asarray(spec.load_pos)
        state[pos] = loads
        state[n_dev + pos] = loads * 0.25
        pots = self._pv_scale * self.np_random.uniform(0.2, 1.0, n_gen)
        state[np.asarray(spec.gen_pos)] = pots
        state[2 * n_dev + n_des :][:n_gen] = pots
        state[2 * n_dev : 2 * n_dev + n_des] = self.np_random.uniform(
            0, np.asarray(spec.des_soc_max) * spec.baseMVA
        )
        return state

    def next_vars(self, s_t):
        spec = self.simulator.spec
        aux = int((s_t[-1] + 1) % 96)
        frac = _daily_factor(aux)
        loads = -self._load_scale * frac * self.np_random.uniform(0.3, 0.9, spec.n_load)
        pots = self._pv_scale * self.np_random.uniform(0.2, 1.0, spec.n_gen)
        return np.concatenate([loads, pots, [aux]])


class Feeder141Env(Feeder33Env):
    """Gymnasium environment on the 141-bus multi-trunk network (same
    stochastic load/renewable dynamics as the 33-bus feeder)."""

    def __init__(self, seed=None):
        super().__init__(seed=seed, network=_NETWORK_141)
