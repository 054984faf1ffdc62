"""Multi-device scaling: shard the world axis over a jax Mesh.

The reference is single-GPU (SURVEY §2.7 — no collectives anywhere);
its scale axis is nworld. Scale-out maps that same axis over devices
with ``NamedSharding``: physics is embarrassingly parallel over worlds,
so the step needs ZERO collectives — XLA partitions every per-world op
locally, and cross-device communication only appears at an RL learner
boundary (observation gather / stat psum), provided here as helpers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import Data, Model

WORLD_AXIS = 'world'


def make_mesh(devices=None, axis: str = WORLD_AXIS) -> Mesh:
  devices = list(devices if devices is not None else jax.devices())
  return Mesh(np.array(devices), (axis,))


def shard_batch(batch: Data, mesh: Mesh, axis: str = WORLD_AXIS) -> Data:
  """Place a batched Data with its leading (world) axis sharded."""
  sharding = NamedSharding(mesh, P(axis))
  return jax.tree_util.tree_map(
      lambda x: jax.device_put(x, sharding), batch)


def replicate_model(m: Model, mesh: Mesh) -> Model:
  sharding = NamedSharding(mesh, P())
  return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), m)


def make_batch(m: Model, d: Data, nworld: int, qpos_noise: float = 0.0,
               seed: int = 0) -> Data:
  """Tile a single-world Data into a batch (vmap-ready)."""
  batch = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x, (nworld,) + x.shape), d)
  if qpos_noise:
    key = jax.random.PRNGKey(seed)
    noise = qpos_noise * jax.random.normal(key, (nworld, m.nq))
    batch = batch.replace(qpos=batch.qpos + noise)
  return batch


def gather_observations(x: jax.Array) -> jax.Array:
  """Learner-boundary all-gather of per-world observations. Inside
  shard_map/pjit this lowers to one all_gather; the physics step itself
  never communicates."""
  return jax.lax.all_gather(x, WORLD_AXIS, tiled=True)


def psum_stats(x: jax.Array) -> jax.Array:
  """Learner-boundary scalar reduction (e.g. returns, episode stats)."""
  return jax.lax.psum(x, WORLD_AXIS)
