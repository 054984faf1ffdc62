"""Bisect warm-state step cost: solver iteration cap sweep + stage
ablations, on the default device."""

import time

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import io as io_mod
from mujoco_warp_tpu import models, parallel

NWORLD = 2048


def timeit(name, fn, *args, n=10):
  out = fn(*args)
  jax.block_until_ready(out)
  t0 = time.perf_counter()
  for _ in range(n):
    out = fn(*args)
  jax.block_until_ready(out)
  dt = (time.perf_counter() - t0) / n
  print(f'{name:34s} {dt*1e3:9.3f} ms')


def main():
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  batch = parallel.make_batch(m, d, NWORLD, qpos_noise=0.01)
  step = jax.jit(lambda b: mjwt.step_batched(m, b))
  batch = step(batch)
  for _ in range(50):
    batch = step(batch)
  jax.block_until_ready(batch.qpos)
  print('warm niter mean/max:',
        float(jnp.mean(batch.solver_niter)),
        int(jnp.max(batch.solver_niter)),
        'ncon mean:', float(jnp.mean(batch.ncon)))

  for iters in (0, 1, 5, 10, 25, 50, 100):
    m_i = io_mod.override_model(m, [f'opt.iterations={iters}'])
    step_i = jax.jit(lambda b, mm=m_i: mjwt.step_batched(mm, b))
    timeit(f'step warm iterations={iters}', step_i, batch)

  # no collision (pure smooth + limits)
  m_nc = io_mod.override_model(m, ['opt.run_collision_detection=false'])
  step_nc = jax.jit(lambda b: mjwt.step_batched(m_nc, b))
  timeit('step warm no-collision', step_nc, batch)

  # forward only (no integrator solve)
  fwd = jax.jit(lambda b: mjwt.forward_batched(m, b))
  timeit('forward_batched warm', fwd, batch)


if __name__ == '__main__':
  main()
