"""Write the C MuJoCo float64 reference that chip_smoke.py checks.

  python tools/write_golden.py

Runs C MuJoCo (float64) on the humanoid from a few seeded initial
states: per-world qvel noise and a constant per-world ctrl. It records
the state after one step (qpos, qvel, qacc, qfrc_constraint) and qpos
after 100 steps in tests/data/humanoid_mujoco_golden.npz. chip_smoke.py
starts the engine from the same states and compares.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

OUT = os.path.join(os.path.dirname(__file__), '..', 'tests', 'data',
                   'humanoid_mujoco_golden.npz')
NWORLD = 4
NSTEP = 100
SEED = 0


def initial_states(mjm):
  rng = np.random.default_rng(SEED)
  qpos = np.tile(mjm.qpos0, (NWORLD, 1))
  qvel = 0.05 * rng.standard_normal((NWORLD, mjm.nv))
  lo, hi = mjm.actuator_ctrlrange[:, 0], mjm.actuator_ctrlrange[:, 1]
  ctrl = lo + (hi - lo) * rng.uniform(0.4, 0.6, (NWORLD, mjm.nu))
  return qpos, qvel, ctrl


def main():
  import mujoco

  from mujoco_warp_tpu import models
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  qpos0, qvel0, ctrl = initial_states(mjm)
  out = {k: [] for k in ('qpos1', 'qvel1', 'qacc1', 'qfrc_constraint1',
                         'qpos100')}
  for w in range(NWORLD):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos0[w], qvel0[w], ctrl[w]
    mujoco.mj_step(mjm, mjd)
    out['qpos1'].append(mjd.qpos.copy())
    out['qvel1'].append(mjd.qvel.copy())
    out['qacc1'].append(mjd.qacc.copy())
    out['qfrc_constraint1'].append(mjd.qfrc_constraint.copy())
    for _ in range(NSTEP - 1):
      mujoco.mj_step(mjm, mjd)
    out['qpos100'].append(mjd.qpos.copy())
  np.savez_compressed(
      OUT, qpos0=qpos0, qvel0=qvel0, ctrl=ctrl, nstep=NSTEP,
      mujoco_version=mujoco.__version__,
      **{k: np.stack(v) for k, v in out.items()})
  print(OUT)


if __name__ == '__main__':
  main()
