"""Task-outcome replay test: aloha_pot lift_pot (reference
unroll_test.py:35-55 — 'aloha lifts pot >= 6.9 cm, lid >= 16 cm').

Long-horizon trajectory replays catch slow numerical/stability
regressions that single-step oracle diffs miss. Slow-marked: ~350
steps of the aloha_pot scene; runs in the full tier and on the GPU
(MJWT_TEST_PLATFORM=cuda).
"""

import os

import mujoco
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import io as io_mod
from mujoco_warp_tpu import parallel

_SCENES = os.path.join(os.path.dirname(__file__), '..', 'benchmarks',
                       'scenes')


@pytest.mark.slow
def test_lift_pot_outcome():
  path = os.path.join(_SCENES, 'aloha_pot', 'scene.xml')
  if not os.path.exists(path):
    pytest.skip('aloha_pot scene not present')
  mjm = mujoco.MjModel.from_xml_path(path)
  keys = io_mod.find_keys(mjm, 'lift_pot')
  assert keys, 'lift_pot keyframes missing from the scene'
  traj = jnp.asarray(io_mod.make_trajectory(mjm, keys), jnp.float32)

  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  d = io_mod.reset_data(m, d, keyframe=keys[0])
  nworld = 4
  batch = parallel.make_batch(m, d, nworld)

  pot_body = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_BODY, 'pot')
  assert pot_body >= 0

  nkey = traj.shape[0]

  def one_step(dd, i):
    ctrl = jnp.broadcast_to(traj[jnp.minimum(i, nkey - 1)],
                            (nworld, traj.shape[1]))
    dd = mjwt.step_batched(m, dd.replace(ctrl=ctrl))
    return dd, i + 1

  run = jax.jit(one_step, donate_argnums=(0,))
  i = jnp.zeros((), jnp.int32)
  # the recorded trajectory is one ctrl per keyframe; replay it fully
  for _ in range(nkey):
    batch, i = run(batch, i)
  jax.block_until_ready(batch.qpos)

  z_pot = np.asarray(batch.xpos[:, pot_body, 2])
  assert np.isfinite(np.asarray(batch.qpos)).all(), 'NaNs in replay'
  # the reference's absolute task assertion (unroll_test.py:55):
  # pot z > 0.069 after the lift_pot trajectory
  assert (z_pot > 0.069).all(), f'pot z {z_pot} <= 0.069 after replay'
