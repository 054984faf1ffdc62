"""Every f32 contraction the step traces asks for HIGHEST precision, so
no GPU runs it in TF32. The entry points trace under
jax.default_matmul_precision('highest') (forward.named); this lowers
them and reads every dot_general in the StableHLO."""

import jax
import mujoco
import pytest

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, parallel, snapshot

from fixtures import BALL_CHAIN, HOPPER, PENDULUM, SPHERES


def _model(name):
  if name == 'humanoid':
    return snapshot.load(models.snapshot_path('humanoid'))
  xml = {'pendulum': PENDULUM, 'ball_chain': BALL_CHAIN, 'hopper': HOPPER,
         'spheres': SPHERES,
         'pendulum_implicitfast': PENDULUM.replace(
             '<option ', '<option integrator="implicitfast" '),
         'pendulum_rk4': PENDULUM.replace(
             '<option ', '<option integrator="RK4" ')}[name]
  return mjwt.put_model(mujoco.MjModel.from_xml_string(xml))


def _f32_dots_below_highest(text):
  dots = [l for l in text.splitlines()
          if 'stablehlo.dot_general' in l and 'xf32>' in l]
  assert dots, 'no f32 dot_general traced'
  return [l.strip()[:200] for l in dots
          if 'precision = [HIGHEST, HIGHEST]' not in l]


@pytest.mark.parametrize('name', [
    'humanoid', 'pendulum', 'ball_chain', 'hopper', 'spheres',
    'pendulum_implicitfast', 'pendulum_rk4'])
def test_step_batched_contractions_are_highest(name):
  m = _model(name)
  b = parallel.make_batch(m, mjwt.make_data(m, nconmax=8), 2)
  text = jax.jit(lambda x: mjwt.step_batched(m, x)).lower(b).as_text()
  assert not _f32_dots_below_highest(text)


def test_vmapped_step_contractions_are_highest():
  m = _model('humanoid')
  b = parallel.make_batch(m, mjwt.make_data(m, nconmax=8), 2)
  step = jax.vmap(mjwt.step, in_axes=(None, 0))
  text = jax.jit(lambda x: step(m, x)).lower(b).as_text()
  assert not _f32_dots_below_highest(text)
