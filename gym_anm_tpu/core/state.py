"""The dynamic simulator state pytree.

Replaces the reference's in-place mutation of ``Bus``/``Device``/``Branch``
objects plus the nested ``{quantity: {unit: {id: value}}}`` state dict
(``simulator.py:551-636``) with a flat array-of-structs pytree that jits,
vmaps and shards.  All electrical quantities are stored once, in per-unit /
radians, in internal ordering; complex quantities are stored as (re, im)
real pairs (plain real arithmetic on every backend); unit conversions and
ID-keyed dict views are pure functions of this pytree (see
:mod:`gym_anm_tpu.core.obs` and the Simulator facade).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .grid import GridSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic state of the grid after one transition (p.u. / rad).

    Bus arrays use internal order (slack first); device arrays use ascending
    device-ID order; branch arrays use input order.
    """

    dev_p: jax.Array  # [d]
    dev_q: jax.Array  # [d]
    des_soc: jax.Array  # [n_des]
    gen_p_pot: jax.Array  # [n_gen] clipped potentials (state "gen_p_max")
    bus_v_re: jax.Array  # [n]
    bus_v_im: jax.Array  # [n]
    bus_i_re: jax.Array  # [n]
    bus_i_im: jax.Array  # [n]
    bus_p: jax.Array  # [n]
    bus_q: jax.Array  # [n]
    br_if_re: jax.Array  # [b] current i_from
    br_if_im: jax.Array  # [b]
    br_it_re: jax.Array  # [b] current i_to
    br_it_im: jax.Array  # [b]
    br_p_from: jax.Array  # [b]
    br_q_from: jax.Array  # [b]
    br_p_to: jax.Array  # [b]
    br_q_to: jax.Array  # [b]
    br_s: jax.Array  # [b] signed apparent-power flow (branch.py:198)
    pfe_converged: jax.Array  # [] bool


def zeros_state(spec: GridSpec) -> SimState:
    """An all-zeros SimState (used for terminal absorbing states)."""
    z = lambda k: jnp.zeros((k,), dtype=spec.dtype)
    return SimState(
        dev_p=z(spec.n_dev),
        dev_q=z(spec.n_dev),
        des_soc=z(spec.n_des),
        gen_p_pot=z(spec.n_gen),
        bus_v_re=z(spec.n_bus),
        bus_v_im=z(spec.n_bus),
        bus_i_re=z(spec.n_bus),
        bus_i_im=z(spec.n_bus),
        bus_p=z(spec.n_bus),
        bus_q=z(spec.n_bus),
        br_if_re=z(spec.n_branch),
        br_if_im=z(spec.n_branch),
        br_it_re=z(spec.n_branch),
        br_it_im=z(spec.n_branch),
        br_p_from=z(spec.n_branch),
        br_q_from=z(spec.n_branch),
        br_p_to=z(spec.n_branch),
        br_q_to=z(spec.n_branch),
        br_s=z(spec.n_branch),
        pfe_converged=jnp.asarray(False),
    )
