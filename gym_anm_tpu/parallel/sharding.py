"""Multi-device / multi-host scaling of environment batches.

Stepping ANM environments is embarrassingly parallel across the batch, so
the scaling strategy is pure data parallelism over a 1-D device mesh: the
``[B, ...]`` leading axis of every :class:`EnvState` leaf (and of actions /
PRNG keys) is sharded over the ``env`` mesh axis with
``jax.sharding.NamedSharding``; jit then compiles one SPMD program per
device and XLA inserts collectives only where cross-batch reductions appear
(e.g. a learner's gradient ``psum``, over NVLink between the cards of a
host).  The mesh follows the algorithm: one data-parallel axis.

The reference has no distributed capability at all (SURVEY.md section 2
preamble); this module is the scaling story replacing it.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all local devices)."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the ``env`` mesh axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    sh = batch_sharding(mesh)
    return jax.device_put(tree, sh)
