"""Transmission-type oracle tests: site and slider-crank
(reference smooth.py:2042-2605)."""

import mujoco
import numpy as np

import mujoco_warp_tpu as mjwt

from fixtures import assert_close, fixture

SLIDERCRANK = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="crank" type="hinge" axis="0 0 1" damping="0.1"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.15 0 0" mass="0.3"
            contype="0" conaffinity="0"/>
      <site name="pin" pos="0.15 0 0"/>
    </body>
    <body pos="0.4 0 1">
      <joint name="push" type="slide" axis="1 0 0" damping="0.2"/>
      <geom type="box" size="0.04 0.04 0.04" mass="0.2" contype="0"
            conaffinity="0"/>
      <site name="slider" pos="0 0 0" euler="0 -90 0"/>
    </body>
  </worldbody>
  <actuator>
    <general cranksite="pin" slidersite="slider" cranklength="0.3"
             gainprm="10"/>
  </actuator>
</mujoco>
"""

SITE_TRN = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <freejoint/>
      <geom type="box" size="0.08 0.08 0.04" mass="1" contype="0"
            conaffinity="0"/>
      <site name="thruster" pos="0 0 -0.04" euler="10 5 0"/>
    </body>
  </worldbody>
  <actuator>
    <general site="thruster" gear="0 0 1 0 0 0" gainprm="5"/>
    <general site="thruster" gear="0 0 0 0 0 1" gainprm="2"/>
  </actuator>
</mujoco>
"""


def test_slidercrank():
  mjm, mjd, m, d = fixture(SLIDERCRANK, qpos_noise=0.3, qvel_noise=0.2,
                           ctrl_noise=0.8)
  d = mjwt.forward(m, d)
  assert_close(d.actuator_length, mjd.actuator_length, 'sc length',
               tol=1e-4)
  assert_close(d.actuator_velocity, mjd.actuator_velocity, 'sc velocity',
               tol=1e-3)
  assert_close(d.qfrc_actuator, mjd.qfrc_actuator, 'sc qfrc', tol=1e-3)
  assert_close(d.qacc, mjd.qacc, 'sc qacc', tol=1e-3)


def test_site_transmission():
  mjm, mjd, m, d = fixture(SITE_TRN, qpos_noise=0.2, ctrl_noise=0.9)
  d = mjwt.forward(m, d)
  assert_close(d.qfrc_actuator, mjd.qfrc_actuator, 'site qfrc', tol=1e-3)
  assert_close(d.qacc, mjd.qacc, 'site qacc', tol=1e-3)


ADHESION = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 1"/>
    <body name="pad" pos="0.02 0.01 0.098">
      <freejoint/>
      <geom type="box" size="0.1 0.1 0.1" mass="0.5"/>
    </body>
  </worldbody>
  <actuator>
    <adhesion body="pad" ctrlrange="0 10" gain="30"/>
  </actuator>
</mujoco>
"""


def test_adhesion_body_transmission():
  """BODY (adhesion) transmission: moment = -average contact-normal
  jacobian over the body's contacts (reference smooth.py:2448)."""
  mjm, mjd, m, d = fixture(ADHESION)
  assert mjd.ncon > 0
  d = mjwt.forward(m, d)
  assert_close(d.actuator_length, mjd.actuator_length, 'adh length')
  moment = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(moment, mjd.actuator_moment, mjd.moment_rownnz,
                          mjd.moment_rowadr, mjd.moment_colind)
  assert_close(d.actuator_moment, moment, 'adh moment', tol=1e-4)


def test_adhesion_holds_against_gravity():
  """With ctrl on, the pad must stick to the floor end-to-end (C and
  this engine agree on qacc)."""
  import jax
  mjm = mujoco.MjModel.from_xml_string(ADHESION)
  mjd = mujoco.MjData(mjm)
  mjd.ctrl[:] = 5.0
  for _ in range(10):
    mujoco.mj_step(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  m = mjwt.put_model(mjm)
  d = mjwt.put_data(mjm, mjd, m)
  d = mjwt.forward(m, d)
  assert_close(d.qfrc_actuator, mjd.qfrc_actuator, 'adh qfrc', tol=1e-3)
  assert_close(d.qacc, mjd.qacc, 'adh qacc', tol=5e-3)
