"""Out-of-bounds sweep for Model index fields — the JAX analogue
of the reference CI's debug-mode io sweep (`pytest -k io_test
--debug_mode`, ci.yml:114-117): Warp's debug compilation traps OOB array
indexing at runtime; JAX instead silently CLAMPS out-of-range gathers,
so a mis-built index field produces wrong physics with no error. This
sweep statically validates every index-typed Model field against its
target dimension for each shipped scene.
"""

import glob
import os

import mujoco
import numpy as np
import pytest

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models


def _bounds_table(mjm, m):
  """(field, lo, hi_exclusive) triples; -1 sentinels allowed at lo=-1.

  hi is the size of the dimension the field indexes INTO. Address+count
  pairs (X_adr/X_num) are validated as adr+num <= hi instead.
  """
  nq, nv, nb = mjm.nq, mjm.nv, mjm.nbody
  return [
      ('body_parentid', 0, nb),
      ('body_rootid', 0, nb),
      ('body_weldid', 0, nb),
      ('body_mocapid', -1, max(mjm.nmocap, 1)),
      ('jnt_qposadr', 0, max(nq, 1)),
      ('jnt_dofadr', 0, max(nv, 1)),
      ('jnt_bodyid', 0, nb),
      ('dof_bodyid', 0, nb),
      ('dof_jntid', 0, max(mjm.njnt, 1)),
      ('dof_parentid', -1, nv),
      ('geom_bodyid', 0, nb),
      ('site_bodyid', 0, nb),
      ('cam_bodyid', 0, nb),
      ('cam_targetbodyid', -1, nb),
      ('light_bodyid', 0, nb),
      ('light_targetbodyid', -1, nb),
      ('eq_obj1id', 0, max(nb, mjm.njnt, mjm.ntendon, mjm.nflex, 1)),
      ('eq_obj2id', 0, max(nb, mjm.njnt, mjm.ntendon, mjm.nflex, 1)),
      ('sensor_objid', -1, max(nb, mjm.ngeom, mjm.nsite, mjm.njnt,
                               mjm.ncam, mjm.nu, mjm.ntendon, 1)),
      ('sensor_refid', -1, max(nb, mjm.ngeom, mjm.nsite, mjm.ncam, 1)),
      ('sensor_adr', 0, max(mjm.nsensordata, 1)),
  ]


def _adr_num_table(mjm):
  return [
      ('body_jntadr', 'body_jntnum', mjm.njnt),
      ('body_dofadr', 'body_dofnum', mjm.nv),
      ('body_geomadr', 'body_geomnum', mjm.ngeom),
      ('actuator_actadr', 'actuator_actnum', mjm.na),
  ]


_SCENES = sorted(
    glob.glob(os.path.join(os.path.dirname(models.__file__), '*.xml')))
_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmarks', 'scenes')
_BIG_SCENES = [p for p in (
    os.path.join(_BENCH, 'apptronik_apollo', 'scene_flat.xml'),
    os.path.join(_BENCH, 'franka_emika_panda', 'scene.xml'),
    os.path.join(_BENCH, 'cloth', 'scene.xml'),
) if os.path.exists(p)]


@pytest.mark.parametrize(
    'xml', _SCENES + [pytest.param(p, marks=pytest.mark.slow)
                      for p in _BIG_SCENES],
    ids=[os.path.basename(p) for p in _SCENES + _BIG_SCENES])
def test_model_index_fields_in_bounds(xml):
  mjm = mujoco.MjModel.from_xml_path(xml)
  try:
    m = mjwt.put_model(mjm)
  except NotImplementedError:
    pytest.skip('model uses a feature put_model rejects')
  for field, lo, hi in _bounds_table(mjm, m):
    v = getattr(m, field, None)
    if v is None or not hasattr(v, 'shape') or v.size == 0:
      continue
    arr = np.asarray(v)
    if not np.issubdtype(arr.dtype, np.integer):
      continue
    assert arr.min() >= lo, f'{field}: min {arr.min()} < {lo}'
    assert arr.max() < hi, f'{field}: max {arr.max()} >= {hi}'
  for adr_f, num_f, hi in _adr_num_table(mjm):
    adr = getattr(m, adr_f, None)
    num = getattr(m, num_f, None)
    if adr is None or num is None:
      continue
    adr, num = np.asarray(adr), np.asarray(num)
    if adr.size == 0:
      continue
    used = adr[adr >= 0] + num[adr >= 0]
    if used.size:
      assert used.max() <= hi, f'{adr_f}+{num_f}: {used.max()} > {hi}'


def test_dof_parentid_is_strictly_decreasing_tree():
  """dof_parentid must form a forest with parent < child — level
  scheduling (smooth factor, sparse LDL) silently loops otherwise."""
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  pid = np.asarray(m.dof_parentid)
  for k, p in enumerate(pid):
    assert p < k, f'dof {k} has parent {p} >= itself'
