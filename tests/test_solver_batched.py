"""The batch-native solve (one while_loop over all worlds, each world
frozen once its own `done` is set) against the same solve run one world
at a time, on landed states where contact, limit, friction-loss and
equality rows are active."""

import functools
import importlib

import jax
import numpy as np
import pytest

from mujoco_warp_tpu import models, parallel
from mujoco_warp_tpu.types import DisableBit

from fixtures import HOPPER, SPHERES, fixture

fwd = importlib.import_module('mujoco_warp_tpu.forward')
solver = importlib.import_module('mujoco_warp_tpu.solver')

# joint limits, joint frictionloss, an equality connect, and pyramidal
# contacts of condim 1 and 3
CONSTRAINED = """
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <geom type="plane" size="5 5 1"/>
    <body name="a" pos="0 0 0.3">
      <freejoint/>
      <geom type="box" size="0.1 0.08 0.05" mass="1"/>
      <body pos="0.15 0 0">
        <joint name="h" type="hinge" axis="0 1 0" range="-20 20"
               frictionloss="0.3"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.2 0 0" mass="0.3"
              condim="1"/>
      </body>
    </body>
    <body name="b" pos="0.5 0 0.25">
      <freejoint/>
      <geom type="sphere" size="0.06" mass="0.5"/>
    </body>
  </worldbody>
  <equality><connect body1="a" body2="b" anchor="0.3 0 0"/></equality>
</mujoco>
"""


def _xml(name):
  if name == 'humanoid':
    with open(models.HUMANOID) as f:
      return f.read()
  return {'hopper': HOPPER, 'spheres': SPHERES,
          'constrained': CONSTRAINED}[name]


@functools.lru_cache(maxsize=None)
def _landed(name, nworld=4):
  """(m, batch just before the solve) from states C MuJoCo stepped until
  the bodies landed."""
  _, _, m, d = fixture(_xml(name), qvel_noise=0.5, nstep=300, nconmax=24)
  b = parallel.make_batch(m, d, nworld, qpos_noise=0.01)
  stages = [fn for n, fn in fwd.batched_stages(m, b)
            if n not in ('solve', 'sensor_acc')]

  def pre(x):
    for fn in stages:
      x = fn(x)
    return x
  return m, jax.jit(pre)(b)


@pytest.mark.parametrize('warmstart', [True, False], ids=['ws', 'nows'])
@pytest.mark.parametrize('name',
                         ['hopper', 'spheres', 'constrained', 'humanoid'])
def test_batched_solve_matches_per_world_solve(name, warmstart):
  m, x = _landed(name)
  if not warmstart:
    m = m.replace(opt=m.opt.replace(
        disableflags=m.opt.disableflags | DisableBit.WARMSTART))
  out = jax.jit(lambda dd: solver.solve(m, dd))(x)
  assert np.abs(np.asarray(out.efc_force)).max() > 0  # constraints act
  one = jax.jit(jax.vmap(lambda dd: solver.solve(m, dd)))(x)
  for f in ('qacc', 'qfrc_constraint', 'efc_force'):
    a, b = np.asarray(getattr(out, f)), np.asarray(getattr(one, f))
    scale = np.maximum(np.abs(b).max(axis=-1), 1.0)
    assert (np.abs(a - b).max(axis=-1) / scale).max() <= 1e-4, f
