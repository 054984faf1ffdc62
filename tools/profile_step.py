"""Stage-level timing for the humanoid step: where does the time go?

Times each pipeline stage jitted+vmapped in isolation (stage boundaries
force materialization, so the sum exceeds the fused step, but ratios
identify the hot spots), then the whole step, then solver-iteration cost
vs iteration cap.
"""

import time

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models
from mujoco_warp_tpu import smooth, solver, constraint, collision_driver
from mujoco_warp_tpu import parallel

NWORLD = 2048


def timeit(name, fn, *args, n=20):
  out = fn(*args)
  jax.block_until_ready(out)
  t0 = time.perf_counter()
  for _ in range(n):
    out = fn(*args)
  jax.block_until_ready(out)
  dt = (time.perf_counter() - t0) / n
  print(f'{name:28s} {dt*1e3:9.3f} ms')
  return out


def main():
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  print('nv', mjm.nv, 'nbody', mjm.nbody, 'ngeom', mjm.ngeom,
        'iterations', mjm.opt.iterations, 'ls_iterations',
        mjm.opt.ls_iterations)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  batch = parallel.make_batch(m, d, NWORLD, qpos_noise=0.01)
  print('njmax', d.efc_J.shape[0])

  def stage(fn):
    return jax.jit(jax.vmap(lambda dd: fn(m, dd)))

  t0 = time.perf_counter()
  batch = stage(mjwt.fwd_position)(batch)
  jax.block_until_ready(batch.qpos)
  print(f'fwd_position compile {time.perf_counter()-t0:.1f}s')

  timeit('kinematics', stage(smooth.kinematics), batch)
  timeit('com_pos', stage(smooth.com_pos), batch)
  timeit('crb', stage(smooth.crb), batch)
  timeit('factor_m', stage(smooth.factor_m), batch)
  timeit('collision', stage(collision_driver.collision), batch)
  timeit('make_constraint', stage(constraint.make_constraint), batch)
  timeit('fwd_position(all)', stage(mjwt.fwd_position), batch)
  batch = stage(mjwt.fwd_velocity)(batch)
  timeit('fwd_velocity', stage(mjwt.fwd_velocity), batch)
  batch = stage(mjwt.fwd_actuation)(batch)
  batch = stage(mjwt.fwd_acceleration)(batch)
  timeit('fwd_acceleration', stage(mjwt.fwd_acceleration), batch)

  t0 = time.perf_counter()
  solved = stage(solver.solve)(batch)
  jax.block_until_ready(solved.qpos)
  print(f'solver compile {time.perf_counter()-t0:.1f}s')
  timeit('solver.solve', stage(solver.solve), batch)
  print('solver_niter mean/max:',
        float(jnp.mean(solved.solver_niter)),
        int(jnp.max(solved.solver_niter)))

  t0 = time.perf_counter()
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(m, dd)))
  out = step(batch)
  jax.block_until_ready(out.qpos)
  print(f'step compile {time.perf_counter()-t0:.1f}s')
  timeit('step(full)', step, batch, n=5)


def profile_batched():
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  batch = parallel.make_batch(m, d, NWORLD, qpos_noise=0.01)
  t0 = time.perf_counter()
  step = jax.jit(lambda b: mjwt.step_batched(m, b))
  out = step(batch)
  jax.block_until_ready(out.qpos)
  print(f'step_batched compile {time.perf_counter()-t0:.1f}s')
  timeit('step_batched(1st state)', step, batch, n=10)
  # warm state after 50 steps (contacts active, realistic niter)
  for _ in range(50):
    batch = step(batch)
  jax.block_until_ready(batch.qpos)
  timeit('step_batched(warm)', step, batch, n=10)
  print('solver_niter mean/max:', float(jnp.mean(out.solver_niter)),
        int(jnp.max(out.solver_niter)))


import os
if os.environ.get('BATCHED_ONLY'):
  profile_batched()
else:
  main()
  profile_batched()
