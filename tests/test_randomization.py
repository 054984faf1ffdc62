"""Per-world model variation: the JAX replacement for the
reference's batched "*" Model fields (io.py:42-64) is vmap over Model
numeric leaves."""

import jax
import jax.numpy as jnp
import numpy as np

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import io as io_mod

from fixtures import HOPPER, PENDULUM, fixture


def test_randomized_masses():
  mjm, mjd, m, d = fixture(PENDULUM, qpos_noise=0.1)
  nworld = 4
  scale = jnp.linspace(0.5, 2.0, nworld)
  masses = m.body_mass[None, :] * scale[:, None]
  axes_m = jax.tree_util.tree_map(lambda _: None, m)
  axes_m = axes_m.replace(body_mass=0)

  batch = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x, (nworld,) + x.shape), d)
  step = jax.jit(jax.vmap(mjwt.step, in_axes=(axes_m, 0)))
  ms = m.replace(body_mass=masses)
  out = step(ms, batch)
  q = np.asarray(out.qacc)
  # different masses must produce different accelerations per world
  assert not np.allclose(q[0], q[-1])
  assert not np.any(np.isnan(q))


def test_randomized_gravity():
  mjm, mjd, m, d = fixture(HOPPER)
  nworld = 3
  gravs = jnp.stack([jnp.array([0., 0., -g]) for g in (1.0, 9.81, 20.0)])
  axes_m = jax.tree_util.tree_map(lambda _: None, m)
  axes_m = axes_m.replace(opt=axes_m.opt.replace(gravity=0))
  ms = m.replace(opt=m.opt.replace(gravity=gravs))
  batch = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x, (nworld,) + x.shape), d)
  step = jax.jit(jax.vmap(mjwt.step, in_axes=(axes_m, 0)))
  out = step(ms, batch)
  # stronger gravity -> more negative initial z acceleration
  az = np.asarray(out.qacc[:, 2])
  assert az[0] > az[1] > az[2]


def test_set_const_after_mass_edit():
  mjm, mjd, m, d = fixture(PENDULUM)
  m2 = m.replace(body_mass=m.body_mass * 2.0)
  m2 = io_mod.set_const(m2)
  np.testing.assert_allclose(np.asarray(m2.body_subtreemass),
                             np.asarray(m.body_subtreemass) * 2.0,
                             rtol=1e-6)


def test_set_const_invweight():
  """dof_invweight0 recompute matches C mj_setConst after a mass edit."""
  import mujoco
  mjm, mjd, m, d = fixture(PENDULUM)
  mjm.body_mass[1:] *= 1.7
  mjm.body_inertia[1:] *= 1.7
  mujoco.mj_setConst(mjm, mjd)
  m2 = m.replace(body_mass=m.body_mass.at[1:].multiply(1.7),
                 body_inertia=m.body_inertia.at[1:].multiply(1.7))
  m2 = io_mod.set_const(m2)
  np.testing.assert_allclose(np.asarray(m2.dof_invweight0),
                             mjm.dof_invweight0, rtol=2e-4)
  np.testing.assert_allclose(np.asarray(m2.dof_M0), mjm.dof_M0, rtol=2e-4)
  np.testing.assert_allclose(float(m2.stat.meaninertia),
                             mjm.stat.meaninertia, rtol=2e-4)
