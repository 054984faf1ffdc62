"""Write the Model snapshots the repo ships (needs C MuJoCo).

  python tools/write_model_snapshot.py

For each MJCF in ``SNAPSHOTS`` this runs ``put_model`` on the CPU and
saves the result next to the XML as ``<name>.npz``, which
``mujoco_warp_tpu.snapshot.load`` reads without C MuJoCo. Run it again
after a change to ``put_model`` or to the Model layout;
tests/test_snapshot.py fails until then.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

SNAPSHOTS = ('humanoid',)


def main():
  import jax
  jax.config.update('jax_platforms', 'cpu')
  import mujoco

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import models, snapshot
  for name in SNAPSHOTS:
    m = mjwt.put_model(mujoco.MjModel.from_xml_path(models.path(name)))
    out = models.snapshot_path(name)
    snapshot.save(m, out)
    print(out, os.path.getsize(out), 'bytes')


if __name__ == '__main__':
  main()
