"""The functional environment core.

Pure-functional, jit/vmap/shard-able equivalent of the reference's
``ANMEnv.step``/``reset`` control flow (``anm_env.py:235-453``):

* action splitting [P_gen, Q_gen, P_des, Q_des] ordered by device ID
  (anm_env.py:393-410),
* ``next_vars`` -> [P_load, P_pot, aux] splitting (anm_env.py:376-391),
* cost clipping and the terminal reward ``-c2 / (1 - gamma)``
  (anm_env.py:423-432),
* terminal absorbing zero-states (anm_env.py:365-367, 444-448),
* reset rejection-sampling with the 100-attempt budget (anm_env.py:266-289).

Terminality is data, not control flow: a diverged power flow sets a per-lane
``terminated`` flag and the state is masked to the absorbing zero state, so
batches of environments stay in lockstep (terminated lanes keep stepping on
the zero state, which converges in 0 NR iterations and costs nothing).

The task hooks are pure functions:

* ``init_state_fn(key) -> s0``: the initial-state distribution, in the
  reference's MW/MVAr/MWh layout ``[dev_p, dev_q, des_soc, gen_p_max, aux]``;
* ``next_vars_fn(state_vec, key) -> [P_load (MW), P_pot (MW), aux]``.

The Gymnasium adapter drives this core with host-side numpy hooks for
drop-in reference compatibility; the batched API vmaps it directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .grid import GridSpec
from .obs import GatherSpec, compile_gather, pack_observables, state_values_spec
from .state import SimState, zeros_state
from .transition import sim_reset, transition


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-environment dynamic state.

    ``state_vec`` caches the canonical state vector s_t (computed once per
    step; zeros in the absorbing state)."""

    sim: SimState
    aux: jax.Array  # [K]
    terminated: jax.Array  # [] bool
    state_vec: jax.Array  # [state_n]


class LeanEnvState(NamedTuple):
    """Minimal rollout carry: exactly the ``EnvState`` content the next
    ``step()`` reads (``sim.des_soc``, ``aux``, ``terminated``,
    ``state_vec`` -- plus the solved bus voltages when the core
    warm-starts its power flows).

    Scanning over a full :class:`EnvState` forces XLA to compute, mask, and
    carry every diagnostic ``SimState`` field (branch currents/flows, bus
    currents/injections) on every step, because the final carry is a live
    program output.  Carrying this projection instead lets the while-loop
    simplifier dead-code-eliminate everything the dynamics don't actually
    depend on.  Only valid when observations are derived from the canonical
    state vector (see :attr:`EnvCore.obs_from_state_vec`); rebuild a full
    state with :meth:`EnvCore.unlean` (unread sim fields become zeros).
    """

    des_soc: jax.Array  # [n_des]
    aux: jax.Array  # [K]
    terminated: jax.Array  # [] bool
    state_vec: jax.Array  # [state_n]
    bus_v_re: Optional[jax.Array] = None  # [n] only when EnvCore.warm_start
    bus_v_im: Optional[jax.Array] = None  # [n]


class StepOut(NamedTuple):
    obs: jax.Array
    reward: jax.Array
    terminated: jax.Array
    state_vec: jax.Array
    e_loss: jax.Array
    penalty: jax.Array


class ResetOut(NamedTuple):
    obs: jax.Array
    state_vec: jax.Array
    failed: jax.Array  # True if the 100-attempt budget was exhausted
    n_tries: jax.Array


def _bmask(pred, x):
    """Broadcast a per-lane predicate against a per-lane array ``x`` whose
    trailing dims are feature dims (leading dims of ``x`` match ``pred``)."""
    pred = jnp.asarray(pred)
    extra = jnp.ndim(x) - pred.ndim
    return pred.reshape(pred.shape + (1,) * max(extra, 0))


def _select(pred, a, b):
    """Pytree select: pred ? a : b (pred is a bool per lane; leaves may have
    extra trailing feature dims)."""
    return jax.tree.map(lambda x, y: jnp.where(_bmask(pred, jnp.broadcast_to(x, jnp.shape(y))), x, y), a, b)


class EnvCore:
    """Static environment configuration + pure step/reset functions.

    Not a pytree: hold one per environment *class* and close over it in
    jitted callables (all array members are constants folded into the
    compiled program).
    """

    def __init__(
        self,
        spec: GridSpec,
        K: int,
        gamma: float,
        costs_clipping=(None, None),
        obs_values=None,
        aux_bounds=None,
        init_state_fn: Optional[Callable] = None,
        next_vars_fn: Optional[Callable] = None,
        obs_fn: Optional[Callable] = None,
        x_tol: float = 1e-5,
        max_iter: int = 100,
        pf_method: str = "scan",
        chord_iters: int = 16,
        chord_precision=None,
        stochastic_vars: bool = True,
        reset_attempts: int = 10,
        warm_start: bool = False,
    ):
        self.spec = spec
        self.K = int(K)
        self.gamma = float(gamma)
        c1 = np.inf if costs_clipping is None or costs_clipping[0] is None else float(costs_clipping[0])
        c2 = np.inf if costs_clipping is None or costs_clipping[1] is None else float(costs_clipping[1])
        self.costs_clipping = (c1, c2)
        self.aux_bounds = aux_bounds
        self.init_state_fn = init_state_fn
        self.next_vars_fn = next_vars_fn
        self.obs_fn = obs_fn
        self.x_tol = x_tol
        self.max_iter = max_iter
        self.pf_method = pf_method
        self.chord_iters = int(chord_iters)
        # Matmul precision of the chord phase's J0inv @ F update (None ->
        # ops.power_flow.CHORD_PRECISION, i.e. HIGHEST); "default" lets
        # the product round its inputs (TF32 on GPU tensor cores).
        self.chord_precision = chord_precision
        # Warm-start each step's power flow from the previous step's solved
        # bus voltages (per-lane best-of-{warm, flat} start; reborn and
        # absorbing lanes flat-start; the convergence decision is untouched
        # -- ops/power_flow.solve_pfe ``init``).  The reference flat-starts
        # every solve (solve_load_flow.py:42; docs/quirks.md); the payoff
        # is a smaller calibrated iteration budget per env.
        self.warm_start = bool(warm_start)
        # False => next_vars_fn ignores its PRNG key (deterministic process),
        # letting the batched path skip per-lane key splitting.
        self.stochastic_vars = stochastic_vars
        # Default rejection-sampling budget for reset(); tasks whose initial
        # states (virtually) always converge set 1, avoiding any retry
        # compute (each retry round is a full masked reset-transition).
        self.reset_attempts = int(reset_attempts)

        self.state_values = state_values_spec(spec, self.K)
        self.state_gather: GatherSpec = compile_gather(spec, self.state_values, self.K, aux_bounds)
        self.state_n = self.state_gather.n
        if obs_values is not None:
            self.obs_values = obs_values
            self.obs_gather: Optional[GatherSpec] = compile_gather(spec, obs_values, self.K, aux_bounds)
            self.obs_n = self.obs_gather.n
            # Fully-observable fast path: the observation is the canonical
            # state vector itself (same gather indices and scales), so the
            # packed-observables machinery can be bypassed entirely.
            self._obs_is_state = bool(
                np.array_equal(self.obs_gather.idx, self.state_gather.idx)
                and np.allclose(self.obs_gather.scale, self.state_gather.scale)
            )
        else:
            self.obs_values = None
            self.obs_gather = None
            # Callable-observation mode: size probed lazily by the adapter.
            self.obs_n = None
            self._obs_is_state = False

        # Action bounds [P_gen, Q_gen, P_des, Q_des] x baseMVA, each block
        # ordered by device ID (simulator.py:341-380, anm_env.py:475-495).
        base = spec.baseMVA
        lo = np.concatenate(
            [
                np.asarray(spec.gen_p_min) * base,
                np.asarray(spec.dev_q_min)[np.asarray(spec.gen_pos)] * base,
                np.asarray(spec.dev_p_min)[np.asarray(spec.des_pos)] * base,
                np.asarray(spec.dev_q_min)[np.asarray(spec.des_pos)] * base,
            ]
        )
        hi = np.concatenate(
            [
                np.asarray(spec.gen_p_max) * base,
                np.asarray(spec.dev_q_max)[np.asarray(spec.gen_pos)] * base,
                np.asarray(spec.dev_p_max)[np.asarray(spec.des_pos)] * base,
                np.asarray(spec.dev_q_max)[np.asarray(spec.des_pos)] * base,
            ]
        )
        self.action_low, self.action_high = lo, hi
        self.action_n = lo.shape[0]
        self.expected_s0_n = 2 * spec.n_dev + spec.n_des + spec.n_gen + self.K
        self.expected_vars_n = spec.n_load + spec.n_gen + self.K

    # ------------------------------------------------------------------
    @property
    def obs_from_state_vec(self) -> bool:
        """True when observations never read raw ``SimState`` fields (the
        fully-observable fast path, a callable ``obs_fn``, or host-side
        observations) -- the condition under which the lean rollout carry
        is exact."""
        return self.obs_gather is None or self._obs_is_state

    def lean(self, es) -> LeanEnvState:
        """Project an ``EnvState`` onto the minimal rollout carry."""
        if isinstance(es, LeanEnvState):
            return es
        return LeanEnvState(
            des_soc=es.sim.des_soc,
            aux=es.aux,
            terminated=es.terminated,
            state_vec=es.state_vec,
            # The solved voltages are dynamics state (the next solve's warm
            # start) only when warm-starting; otherwise leave them out so
            # XLA can DCE them from the rollout.
            bus_v_re=es.sim.bus_v_re if self.warm_start else None,
            bus_v_im=es.sim.bus_v_im if self.warm_start else None,
        )

    def unlean(self, lean) -> EnvState:
        """Rebuild a steppable ``EnvState`` from a lean carry.

        The sim fields ``step()`` never reads are filled with (broadcast)
        zeros; they must not be observed directly."""
        if isinstance(lean, EnvState):
            return lean
        sim = dataclasses.replace(zeros_state(self.spec), des_soc=lean.des_soc)
        if lean.bus_v_re is not None:
            sim = dataclasses.replace(sim, bus_v_re=lean.bus_v_re, bus_v_im=lean.bus_v_im)
        return EnvState(sim=sim, aux=lean.aux, terminated=lean.terminated, state_vec=lean.state_vec)

    def state_vec(self, es) -> jax.Array:
        """The canonical state vector s_t (cached on the EnvState)."""
        return es.state_vec

    def _compute_state_vec(self, sim, aux, terminated) -> jax.Array:
        # The canonical layout [dev_p (MW), dev_q (MVAr), des_soc (MWh),
        # gen_p_max (MW), aux] (anm_env.py:139-147) is a direct concat of
        # SimState fields -- no packing/gather needed.
        base = self.spec.baseMVA
        vec = jnp.concatenate(
            [
                sim.dev_p * base,
                sim.dev_q * base,
                sim.des_soc * base,
                sim.gen_p_pot * base,
                jnp.asarray(aux, dtype=self.spec.dtype),
            ],
            axis=-1,
        )
        return jnp.where(_bmask(terminated, vec), jnp.zeros_like(vec), vec)

    def observation(self, es: EnvState) -> jax.Array:
        """o_t = clip(extract(s_t)) (anm_env.py:313-331), zeros if terminal."""
        if self.obs_gather is not None and self._obs_is_state:
            # Fully-observable: clip the cached state vector.
            obs = jnp.clip(es.state_vec, self.obs_gather.low, self.obs_gather.high)
        elif self.obs_gather is not None:
            obs = self.obs_gather(pack_observables(self.spec, es.sim, es.aux), clip=True)
        elif self.obs_fn is not None:
            obs = jnp.atleast_1d(self.obs_fn(self.state_vec(es)))
        else:
            # Host-side callable-observation mode: the adapter computes the
            # observation itself; expose the state vector as a placeholder.
            obs = self.state_vec(es)
        return jnp.where(_bmask(es.terminated, obs), jnp.zeros_like(obs), obs)

    # ------------------------------------------------------------------
    def step(self, es: EnvState, action, vars) -> tuple[EnvState, StepOut]:
        """One environment step given pre-sampled internal variables.

        ``action`` is in MW/MVAr, ``vars = [P_load (MW), P_pot (MW), aux]``.
        """
        spec = self.spec
        base = spec.baseMVA
        n_gen, n_des, n_load = spec.n_gen, spec.n_des, spec.n_load
        vars = jnp.asarray(vars, dtype=spec.dtype)
        if vars.shape[-1] != self.expected_vars_n:
            raise ValueError(
                "Next vars vector has size %d but expected is %d" % (vars.shape[-1], self.expected_vars_n)
            )
        action = jnp.asarray(action, dtype=spec.dtype)

        P_load = vars[..., :n_load] / base
        P_pot = vars[..., n_load : n_load + n_gen] / base
        aux_new = vars[..., n_load + n_gen :]

        res = transition(
            spec,
            es.sim.des_soc,
            P_load=P_load,
            P_pot=P_pot,
            P_set_gen=action[..., :n_gen] / base,
            Q_set_gen=action[..., n_gen : 2 * n_gen] / base,
            P_set_des=action[..., 2 * n_gen : 2 * n_gen + n_des] / base,
            Q_set_des=action[..., 2 * n_gen + n_des :] / base,
            x_tol=self.x_tol,
            max_iter=self.max_iter,
            pf_method=self.pf_method,
            chord_iters=self.chord_iters,
            chord_precision=self.chord_precision,
            v_init=(es.sim.bus_v_re, es.sim.bus_v_im) if self.warm_start else None,
        )

        c1, c2 = self.costs_clipping
        newly_term = ~res.pfe_converged
        e_c = jnp.sign(res.e_loss) * jnp.clip(jnp.abs(res.e_loss), 0.0, c1)
        p_c = jnp.clip(res.penalty, 0.0, c2)
        r = jnp.where(newly_term, -c2 / (1.0 - self.gamma), -(e_c + p_c))

        prev = es.terminated
        term = prev | newly_term
        zero = zeros_state(spec)
        sim_new = _select(term, zero, res.state)
        aux_out = jnp.where(_bmask(term, aux_new), jnp.zeros_like(aux_new), aux_new)
        es_new = EnvState(
            sim=sim_new,
            aux=aux_out,
            terminated=term,
            state_vec=self._compute_state_vec(sim_new, aux_out, term),
        )

        r = jnp.where(prev, 0.0, r)
        e_out = jnp.where(term, jnp.asarray(c1, spec.dtype), e_c)
        p_out = jnp.where(term, jnp.asarray(c2, spec.dtype), p_c)

        return es_new, StepOut(
            obs=self.observation(es_new),
            reward=r,
            terminated=term,
            state_vec=self.state_vec(es_new),
            e_loss=e_out,
            penalty=p_out,
        )

    def step_with_key(self, es: EnvState, action, key) -> tuple[EnvState, StepOut]:
        """One step sampling the internal variables with ``next_vars_fn``."""
        vars = self.next_vars_fn(self.state_vec(es), key)
        return self.step(es, action, vars)

    # ------------------------------------------------------------------
    def env_state_from_s0(self, s0) -> EnvState:
        """Apply one initial-state vector (no retry loop); supports a
        leading batch axis.

        A lane whose load flow diverges on s0 comes back **terminated** with
        the absorbing zero state (the reference raises after its retry
        budget, anm_env.py:284-289; here divergence is data, so a failed
        reset can never enter a rollout as a live lane with inf/NaN sim
        state -- it is absorbed exactly like an in-episode grid collapse).
        """
        spec = self.spec
        s0 = jnp.asarray(s0, dtype=spec.dtype)
        if s0.shape[-1] != self.expected_s0_n:
            # Mirrors anm_env.py:274-277.
            from ..errors import EnvInitializationError

            raise EnvInitializationError(
                "Expected size of initial state s0 is %d but actual is %d" % (self.expected_s0_n, s0.shape[-1])
            )
        sim = sim_reset(
            spec,
            s0,
            x_tol=self.x_tol,
            max_iter=self.max_iter,
            pf_method=self.pf_method,
            chord_iters=self.chord_iters,
            chord_precision=self.chord_precision,
        )
        aux = s0[..., 2 * spec.n_dev + spec.n_des + spec.n_gen :]
        terminated = ~sim.pfe_converged
        sim = _select(terminated, zeros_state(spec), sim)
        aux = jnp.where(_bmask(terminated, aux), jnp.zeros_like(aux), aux)
        return EnvState(
            sim=sim,
            aux=aux,
            terminated=terminated,
            state_vec=self._compute_state_vec(sim, aux, terminated),
        )

    def reset(self, key, batch_shape=(), attempts: Optional[int] = None) -> tuple[EnvState, ResetOut]:
        """Rejection-sample initial states until the load flow converges.

        The reference retries up to 100 times and raises on exhaustion
        (anm_env.py:266-289); here attempt 1 runs inline and the remaining
        ``attempts - 1`` rounds are a ``lax.scan`` of masked retries, so the
        program traces at most **two** reset-transitions regardless of the
        budget (a statically-unrolled sweep made the reset program ~10x
        bigger and slower to compile).  Exhaustion is reported per lane via
        ``failed``; ``attempts=None`` uses the task's calibrated
        ``reset_attempts`` (1 for tasks whose initial states always
        converge -- then no retry round is traced or executed at all).
        ``batch_shape`` resets that many lockstep environments at once.
        """
        if attempts is None:
            attempts = self.reset_attempts
        init_one = self.init_state_fn
        for _ in batch_shape:
            init_one = jax.vmap(init_one)
        keys = jax.random.split(key, (attempts,) + tuple(batch_shape))

        es = self.env_state_from_s0(init_one(keys[0]))
        tries = jnp.ones(jnp.shape(es.terminated), dtype=jnp.int32)
        if attempts > 1:
            def attempt(carry, k):
                es, tries = carry
                retry = es.terminated  # only still-failed lanes retry
                es_i = self.env_state_from_s0(init_one(k))
                es = _select(retry, es_i, es)
                tries = tries + retry.astype(jnp.int32)
                return (es, tries), None

            (es, tries), _ = jax.lax.scan(attempt, (es, tries), keys[1:])
        failed = es.terminated
        return es, ResetOut(
            obs=self.observation(es), state_vec=self.state_vec(es), failed=failed, n_tries=tries
        )
