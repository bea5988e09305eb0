"""The 6-bus, 7-device Gymnasium environments: ``ANM6`` and ``ANM6Easy``.

Equivalent of the reference ``ANM6`` (``envs/anm6_env/anm6.py:13-239``): the
fixed 6-bus network with wall-clock date simulation and the render/close
lifecycle.  In this framework the render machinery (web/replay servers,
simulated date clock) lives in :class:`~gym_anm_tpu.envs.anm_env.ANMEnv`
itself -- the browser client is topology-generic, so every environment
renders -- leaving this class as just the network binding.
"""

from __future__ import annotations

import numpy as np

from ..anm_env import ANMEnv
from .anm6_easy import _get_gen_time_series, _get_load_time_series, anm6easy_init_state, anm6easy_next_vars
from .network import network


class ANM6(ANMEnv):
    """Base class for 6-bus 7-device environments (rendering-capable).

    Network topology::

        Slack ----------------------------
                |            |           |
              -----       -------      -----
             |     |     |       |    |     |
            House  PV  Factory  Wind  EV   DES
    """

    metadata = {"render_modes": ["human", "replay"]}

    def __init__(self, observation, K, delta_t, gamma, lamb, aux_bounds=None, costs_clipping=(None, None), seed=None):
        super().__init__(network, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed)


class ANM6Easy(ANM6):
    """The ``ANM6Easy-v0`` task (anm6_easy.py:8-74)."""

    def __init__(self):
        observation = "state"  # fully observable
        K = 1
        delta_t = 0.25  # 15 minutes between timesteps
        gamma = 0.995
        lamb = 100
        aux_bounds = np.array([[0, 24 / delta_t - 1]])
        costs_clipping = (1, 100)
        super().__init__(observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping)

        self.P_loads = _get_load_time_series()
        self.P_maxs = _get_gen_time_series()
        # NB: numpy (not jnp) on purpose -- these tables are closed over by
        # traced hooks and fold into programs as host constants.
        self._P_loads_j = self.P_loads
        self._P_maxs_j = self.P_maxs

    # ------------------------------------------------------------------
    # Host (reference-RNG-order) hooks.
    # ------------------------------------------------------------------
    def init_state(self):
        """Sample s0 at a random time of day (anm6_easy.py:25-52).

        Reference quirks kept: the generator Q entries and storage SoC entry
        are sampled from the *p.u.* device bounds even though the state
        vector is in MVAr/MWh (anm6_easy.py:42-50).
        """
        n_dev, n_gen, n_des = 7, 2, 1
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)

        t_0 = self.np_random.integers(0, int(24 / self.delta_t))
        state[-1] = t_0

        for dev_id, p_load in zip([1, 3, 5], self.P_loads):
            state[dev_id] = p_load[t_0]
            state[n_dev + dev_id] = p_load[t_0] * self.simulator.devices[dev_id].qp_ratio

        for idx, (dev_id, p_max) in enumerate(zip([2, 4], self.P_maxs)):
            state[2 * n_dev + n_des + idx] = p_max[t_0]
            state[dev_id] = p_max[t_0]
            state[n_dev + dev_id] = self.np_random.uniform(
                self.simulator.devices[dev_id].q_min, self.simulator.devices[dev_id].q_max
            )

        for idx, dev_id in enumerate([6]):
            state[2 * n_dev + idx] = self.np_random.uniform(
                self.simulator.devices[dev_id].soc_min, self.simulator.devices[dev_id].soc_max
            )

        return state

    def next_vars(self, s_t):
        """Deterministic table lookup by time-of-day (anm6_easy.py:54-65)."""
        aux = int((s_t[-1] + 1) % (24 / self.delta_t))
        vars = [p_load[aux] for p_load in self.P_loads]
        vars += [p_max[aux] for p_max in self.P_maxs]
        vars.append(aux)
        return np.array(vars)

    def reset(self, **kwargs):
        obs, info = super().reset(**kwargs)

        # Advance the rendering clock to the sampled time of day
        # (anm6_easy.py:67-74).
        new_date = self.date + self.state[-1] * self.timestep_length
        super().reset_date(new_date)

        return obs, info

    # ------------------------------------------------------------------
    # Pure-JAX hooks for the batched fast path.
    # ------------------------------------------------------------------
    def init_state_jax(self, key):
        return anm6easy_init_state(key, self._P_loads_j, self._P_maxs_j)

    def next_vars_jax(self, s_t, key):
        return anm6easy_next_vars(s_t, self._P_loads_j, self._P_maxs_j)
