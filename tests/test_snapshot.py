"""Model snapshots (snapshot.py): a saved and reloaded Model equals
put_model's output leaf for leaf and static field for static field, the
shipped humanoid snapshot is current, and the package imports and steps
a snapshot with C MuJoCo unimportable."""

import os
import subprocess
import sys

import jax
import mujoco
import numpy as np
import pytest

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, snapshot

from fixtures import BALL_CHAIN, HOPPER, PENDULUM, SPHERES

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_models_equal(a, b):
  la, ta = jax.tree.flatten(a)
  lb, tb = jax.tree.flatten(b)
  assert ta == tb  # every static field, Option and Model meta included
  for x, y in zip(la, lb):
    assert type(x) is type(y)
    if hasattr(x, 'dtype'):
      assert x.dtype == y.dtype and x.shape == y.shape
      np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    else:
      assert x == y


@pytest.mark.parametrize(
    'xml', [PENDULUM, BALL_CHAIN, HOPPER, SPHERES, models.HUMANOID],
    ids=['pendulum', 'ball_chain', 'hopper', 'spheres', 'humanoid'])
def test_snapshot_roundtrip(xml, tmp_path):
  mjm = (mujoco.MjModel.from_xml_path(xml) if xml.endswith('.xml')
         else mujoco.MjModel.from_xml_string(xml))
  m = mjwt.put_model(mjm)
  path = str(tmp_path / 'm.npz')
  snapshot.save(m, path)
  assert_models_equal(m, snapshot.load(path))


def test_shipped_humanoid_snapshot_is_current():
  """Fails after a change to put_model until
  tools/write_model_snapshot.py is run again."""
  m = mjwt.put_model(mujoco.MjModel.from_xml_path(models.HUMANOID))
  assert_models_equal(m, snapshot.load(models.snapshot_path('humanoid')))


def test_import_and_step_without_mujoco():
  code = (
      "import sys; sys.modules['mujoco'] = None\n"
      "import jax; jax.config.update('jax_platforms', 'cpu')\n"
      "import numpy as np\n"
      "import mujoco_warp_tpu as mjwt\n"
      "from mujoco_warp_tpu import models, parallel, snapshot\n"
      "m = snapshot.load(models.snapshot_path('humanoid'))\n"
      "d = mjwt.make_data(m, nconmax=24)\n"
      "b = parallel.make_batch(m, d, 2, qpos_noise=0.01)\n"
      "b = jax.jit(lambda x: mjwt.step_batched(m, x))(b)\n"
      "assert np.isfinite(np.asarray(b.qpos)).all()\n"
      "print('stepped')\n")
  out = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stderr[-3000:]
  assert 'stepped' in out.stdout
