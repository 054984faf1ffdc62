"""mjwt-viewer: interactive viewer bridge (reference:
mujoco_warp/viewer.py). Steps this engine on the accelerator and syncs
one world back into a host MjData rendered by MuJoCo's native passive
viewer each frame — the same host<->device-per-frame pattern as the
reference (viewer.py:98-140).

Usage: python -m mujoco_warp_tpu.viewer PATH.xml [-o opt....]
Requires a display (GLFW); headless environments can use testspeed.
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import mujoco
import numpy as np


def build(mjm, mjd, override=(), prev_d=None):
  """(m, d, jitted step) for the current mjm options; carries dynamic
  state across an option-change rebuild (the reference viewer
  re-captures its CUDA graph when UI options change, viewer.py:98-140)."""
  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import io as io_mod
  m = mjwt.put_model(mjm)
  if override:
    m = io_mod.override_model(m, list(override))
  d = mjwt.put_data(mjm, mjd, m)
  if prev_d is not None:
    d = d.replace(qpos=prev_d.qpos, qvel=prev_d.qvel, act=prev_d.act,
                  time=prev_d.time)
  step = jax.jit(lambda dd: mjwt.step(m, dd))
  return m, step(d), step  # compile before first frame


def opt_sig(mjm):
  """The UI-editable physics options watched for re-jit."""
  o = mjm.opt
  return (float(o.timestep), tuple(o.gravity), int(o.integrator),
          int(o.solver), int(o.cone), int(o.iterations),
          float(o.tolerance), int(o.ls_iterations),
          int(o.disableflags), int(o.enableflags), float(o.impratio))


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('mjcf')
  p.add_argument('-o', '--override', action='append', default=[])
  p.add_argument('--keyframe', type=int, default=None)
  args = p.parse_args(argv)

  import mujoco.viewer
  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import io as io_mod

  mjm = mujoco.MjModel.from_xml_path(args.mjcf)
  mjd = mujoco.MjData(mjm)
  if args.keyframe is not None:
    mujoco.mj_resetDataKeyframe(mjm, mjd, args.keyframe)
  m, d, step = build(mjm, mjd, args.override)
  sig = opt_sig(mjm)

  with mujoco.viewer.launch_passive(mjm, mjd) as v:
    while v.is_running():
      t0 = time.perf_counter()
      if opt_sig(mjm) != sig:       # UI changed physics options
        sig = opt_sig(mjm)
        m, d, step = build(mjm, mjd, args.override, prev_d=d)
      # user-injected state/ctrl from the viewer UI -> device
      d = d.replace(
          ctrl=jnp.asarray(mjd.ctrl, jnp.float32),
          qfrc_applied=jnp.asarray(mjd.qfrc_applied, jnp.float32),
          xfrc_applied=jnp.asarray(mjd.xfrc_applied, jnp.float32))
      d = step(d)
      mjwt.get_data_into(mjd, m, d)
      v.sync()
      # real-time pacing
      leftover = float(m.opt.timestep) - (time.perf_counter() - t0)
      if leftover > 0:
        time.sleep(leftover)


if __name__ == '__main__':
  main()
