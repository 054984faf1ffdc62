"""Dispatch-strategy experiment: python-loop-with-donation vs chunked
on-device rollout (jitted lax.fori_loop of K steps per dispatch).

Where the profile (tools/xprof_step.py) shows wall time per step above
device time, the gap is host dispatch. A chunked rollout amortizes
dispatch over K steps, closer to the reference's CUDA-graph replay.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import mujoco

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, parallel
from mujoco_warp_tpu.utils.benchmark import ctrl_noise

NWORLD = int(os.environ.get('NWORLD', 8192))


def main():
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=24)
  batch = parallel.make_batch(m, d, NWORLD, qpos_noise=0.01)
  worldids = jnp.arange(NWORLD, dtype=jnp.int32)

  def one_step(d, step_i):
    noisy = jax.vmap(lambda c, w: ctrl_noise(m, c, w, step_i))(
        d.ctrl, worldids)
    d = d.replace(ctrl=noisy)
    d = mjwt.step_batched(m, d)
    return d, step_i + 1

  run_step = jax.jit(one_step, donate_argnums=(0,))

  def chunk_fn(K):
    def run(d, step_i):
      def body(_, carry):
        return one_step(*carry)
      return jax.lax.fori_loop(0, K, body, (d, step_i))
    return jax.jit(run, donate_argnums=(0,))

  # warm the single-step path
  t0 = time.perf_counter()
  dd, si = run_step(batch, jnp.zeros((), jnp.int32))
  jax.block_until_ready(dd.qpos)
  print(f'jit single: {time.perf_counter()-t0:.1f}s')
  for _ in range(20):
    dd, si = run_step(dd, si)
  jax.block_until_ready(dd.qpos)
  N = 100
  t0 = time.perf_counter()
  for _ in range(N):
    dd, si = run_step(dd, si)
  jax.block_until_ready(dd.qpos)
  dt = (time.perf_counter() - t0) / N
  print(f'python-loop: {dt*1e6:8.1f} us/step  '
        f'{NWORLD/dt:,.0f} steps/s')

  for K in (10, 50):
    runK = chunk_fn(K)
    t0 = time.perf_counter()
    dd2, si2 = runK(dd, si)
    jax.block_until_ready(dd2.qpos)
    print(f'jit chunk{K}: {time.perf_counter()-t0:.1f}s')
    t0 = time.perf_counter()
    reps = max(1, 200 // K)
    for _ in range(reps):
      dd2, si2 = runK(dd2, si2)
    jax.block_until_ready(dd2.qpos)
    dt = (time.perf_counter() - t0) / (reps * K)
    print(f'chunk K={K:3d}: {dt*1e6:8.1f} us/step  '
          f'{NWORLD/dt:,.0f} steps/s')
    dd, si = dd2, si2


if __name__ == '__main__':
  main()
