"""Batched lockstep environments: the accelerator fast path.

The reference steps one environment at a time in Python.  Here an
:class:`~gym_anm_tpu.core.env_core.EnvCore` executes a whole ``[B, ...]``
batch of :class:`EnvState` pytrees **natively** (the physics supports
leading batch axes; the NR solvers lay the batch on their innermost axis
-- see :mod:`gym_anm_tpu.ops.power_flow`), giving thousands of lockstep
environments per device; ``rollout_fn`` additionally
``lax.scan``s over time so an entire trajectory segment is a single XLA
program.

Multi-device scaling shards the batch axis over a
``jax.sharding.Mesh`` (see :mod:`gym_anm_tpu.parallel.sharding`): stepping
is embarrassingly parallel, so the only collectives are those XLA inserts
for cross-batch reductions (e.g. mean rewards in a learner).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.env_core import EnvCore, EnvState, StepOut


class BatchedStep(NamedTuple):
    obs: jax.Array  # [B, obs_n]
    reward: jax.Array  # [B]
    terminated: jax.Array  # [B] bool
    state_vec: jax.Array  # [B, state_n]


class BatchedEnv:
    """Vectorized lockstep environments over a leading batch axis.

    Parameters
    ----------
    core : EnvCore
        The functional environment (must have ``init_state_fn`` and
        ``next_vars_fn`` pure-JAX hooks).
    batch_size : int
        Number of lockstep environments B.
    auto_reset : bool
        If True, terminated lanes are re-initialized in the same step with a
        single-attempt reset (useful for RL training).  If False (default),
        terminated lanes stay in the absorbing zero state -- the reference's
        semantics (anm_env.py:365-367).
    auto_reset_mode : {"pool", "step"}
        How auto-reset fresh states are produced inside rollout segments.
        ``"pool"`` (default): one batch of B fresh converged states is
        sampled per rollout segment (:meth:`fresh_states`) and terminated
        lanes draw from it through a per-step randomly rotated gather --
        amortizing the reset-transition (a full extra physics solve) from
        every step to once per segment.  ``"step"``: an independent
        single-attempt reset every step (i.i.d. fresh states, ~2x the
        per-step transition cost).  Direct ``step``/``step_fn`` calls
        without a ``fresh`` pool always use per-step resets.
    reset_attempts : int | None
        Rejection-sampling rounds in :meth:`reset` (the reference's budget
        is 100).  None (default) uses the task's calibrated
        ``core.reset_attempts`` -- 1 for tasks whose initial states always
        converge (ANM6Easy), where retry rounds would only add masked
        reset-transitions that never fire.
    """

    def __init__(
        self,
        core: EnvCore,
        batch_size: int,
        auto_reset: bool = False,
        reset_attempts: Optional[int] = None,
        auto_reset_mode: str = "pool",
    ):
        self.core = core
        self.batch_size = int(batch_size)
        self.auto_reset = bool(auto_reset)
        if auto_reset_mode not in ("pool", "step"):
            raise ValueError("auto_reset_mode must be 'pool' or 'step'")
        self.auto_reset_mode = auto_reset_mode
        self.reset_attempts = int(core.reset_attempts if reset_attempts is None else reset_attempts)
        self._reset = jax.jit(
            lambda key: core.reset(key, batch_shape=(self.batch_size,), attempts=self.reset_attempts)
        )
        self._step = jax.jit(self.step_fn)

    # ------------------------------------------------------------------
    def fresh_states(self, key) -> EnvState:
        """One batch of B fresh (physics-reconciled) initial states -- the
        auto-reset pool sampled once per rollout segment in ``"pool"`` mode.
        Costs one full reset-transition (single attempt per lane)."""
        keys = jax.random.split(key, self.batch_size)
        s0 = jax.vmap(self.core.init_state_fn)(keys)
        return self.core.env_state_from_s0(s0)

    def step_fn(self, es: EnvState, actions, key, fresh: Optional[EnvState] = None) -> tuple[EnvState, StepOut]:
        """One batched step (jittable building block).

        ``actions [B, action_n]``; internal variables are sampled per lane
        from ``key``; with ``auto_reset`` terminated lanes are re-initialized
        in the same step (single attempt, keeping the batch lockstep).
        ``fresh`` optionally supplies a pre-sampled pool of fresh states
        (:meth:`fresh_states`): terminated lanes then draw from it through a
        randomly rotated gather instead of running a full reset-transition
        here -- the segment-amortized fast path rollouts and trainers use.
        """
        core = self.core
        B = self.batch_size
        es = core.unlean(es)  # accept lean rollout carries (no-op for full states)
        k_vars, k_reset = jax.random.split(key)
        if core.stochastic_vars:
            vars_keys = jax.random.split(k_vars, B)
            vars = jax.vmap(core.next_vars_fn)(core.state_vec(es), vars_keys)
        else:
            # Deterministic process: no per-lane keys needed.
            vars = jax.vmap(core.next_vars_fn, in_axes=(0, None))(core.state_vec(es), k_vars)
        es_new, out = core.step(es, actions, vars)
        if not self.auto_reset:
            return es_new, out

        if fresh is not None:
            # Per-lane random pool indices: lanes reborn in the same step
            # draw i.i.d. entries (a shared scalar rotation would hand
            # co-reborn lanes pool entries at fixed relative offsets -- a
            # structured correlation in the training data).  Entries may
            # still repeat across a segment (sampling with replacement from
            # a B-entry pool) -- the documented pool-mode tradeoff vs
            # ``"step"`` mode's fully i.i.d. per-step resets.  A gather is a
            # relayout, not a physics solve.
            idx = jax.random.randint(k_reset, (B,), 0, B)
            es_fresh = jax.tree.map(lambda x: x[idx], fresh)
        else:
            reset_keys = jax.random.split(k_reset, B)
            s0 = jax.vmap(core.init_state_fn)(reset_keys)
            es_fresh = core.env_state_from_s0(s0)
        reset_now = out.terminated
        bsel = lambda a, b: jax.tree.map(
            lambda x, y: jnp.where(reset_now.reshape(reset_now.shape + (1,) * (x.ndim - 1)), x, y), a, b
        )
        es_final = bsel(es_fresh, es_new)
        obs = jnp.where(reset_now[:, None], core.observation(es_fresh), out.obs)
        state_vec = jnp.where(reset_now[:, None], core.state_vec(es_fresh), out.state_vec)
        return es_final, StepOut(
            obs=obs,
            reward=out.reward,
            terminated=out.terminated,
            state_vec=state_vec,
            e_loss=out.e_loss,
            penalty=out.penalty,
        )

    # ------------------------------------------------------------------
    def reset(self, key, strict: bool = False) -> tuple[EnvState, BatchedStep]:
        """Reset all lanes.

        A lane whose ``init_state_fn`` samples fail to converge for every
        rejection-sampling round comes back **terminated** (absorbing zero
        state, reported in ``BatchedStep.terminated``) instead of silently
        entering the rollout with a diverged sim state.  With
        ``strict=True`` an exhausted lane raises
        :class:`~gym_anm_tpu.errors.EnvInitializationError` instead -- the
        reference's behavior after its 100-attempt budget
        (anm_env.py:284-289); this costs one host sync per reset.
        """
        es, out = self._reset(key)
        if strict:
            import numpy as np

            n_failed = int(np.asarray(out.failed).sum())
            if n_failed:
                from ..errors import EnvInitializationError

                raise EnvInitializationError(
                    "No non-terminal state found out of %d initial states for %d/%d lanes"
                    % (self.reset_attempts, n_failed, self.batch_size)
                )
        return es, BatchedStep(
            obs=out.obs,
            reward=jnp.zeros((self.batch_size,), dtype=self.core.spec.dtype),
            terminated=out.failed,
            state_vec=out.state_vec,
        )

    def step(self, es: EnvState, actions, key) -> tuple[EnvState, BatchedStep]:
        es, out = self._step(es, actions, key)
        return es, BatchedStep(
            obs=out.obs, reward=out.reward, terminated=out.terminated, state_vec=out.state_vec
        )

    # ------------------------------------------------------------------
    def rollout_fn(self, policy_fn: Optional[Callable] = None, n_steps: int = 1, lean: Optional[bool] = None):
        """Build a jittable rollout ``run(es, key, policy_args=None)``.

        ``policy_fn(policy_args, obs, key) -> [B, action_n]`` selects
        actions from batched observations; if None, actions are sampled
        uniformly from the action space (and per-step observations are not
        materialized -- the throughput-bench path).

        ``lean`` controls the scan carry: when True the loop carries only
        the :class:`~gym_anm_tpu.core.env_core.LeanEnvState` projection, so
        XLA dead-code-eliminates the diagnostic SimState fields (branch
        currents/flows, bus quantities) every step instead of computing,
        masking, and carrying all of them.  Defaults to automatic: lean
        whenever observations never read raw sim fields
        (``core.obs_from_state_vec``).  With lean on, ``run`` returns a
        ``LeanEnvState`` -- accepted back by ``run`` and by any ``EnvCore``
        API that only needs the dynamics state (``core.unlean`` rebuilds a
        full state with zeroed diagnostics).

        Returns ``(es, traj)`` where ``traj`` is ``(reward, terminated)``
        stacked over time for the uniform policy, and
        ``(obs, actions, reward, terminated)`` when a policy is given.
        """
        core = self.core
        # numpy constants: closed over by the traced rollout, so they fold
        # into the program without a device->host copy at lowering time.
        import numpy as np

        lo = np.asarray(core.action_low, dtype=core.spec.dtype)
        hi = np.asarray(core.action_high, dtype=core.spec.dtype)
        B = self.batch_size
        need_obs = policy_fn is not None
        if lean is None:
            lean = core.obs_from_state_vec

        def uniform_policy(_, obs, key):
            u = jax.random.uniform(key, (B, core.action_n), core.spec.dtype)
            return u * (hi - lo) + lo

        pol = policy_fn or uniform_policy

        use_pool = self.auto_reset and self.auto_reset_mode == "pool"

        def make_body(fresh):
            def body(carry, key):
                es, policy_args = carry
                if lean:
                    es = core.unlean(es)
                k_act, k_step = jax.random.split(key)
                obs = core.observation(es) if need_obs else None
                actions = pol(policy_args, obs, k_act)
                es, out = self.step_fn(es, actions, k_step, fresh=fresh)
                if lean:
                    es = core.lean(es)
                ys = (obs, actions, out.reward, out.terminated) if need_obs else (out.reward, out.terminated)
                return (es, policy_args), ys

            return body

        def run(es, key, policy_args=None):
            if lean:
                es = core.lean(es)
            if use_pool:
                # One reset-transition per segment instead of per step:
                # terminated lanes draw from this pool inside the scan.
                key, k_pool = jax.random.split(key)
                fresh = self.fresh_states(k_pool)
            else:
                fresh = None
            keys = jax.random.split(key, n_steps)
            (es, _), traj = jax.lax.scan(make_body(fresh), (es, policy_args), keys)
            return es, traj

        return run
