"""Headline benchmark: humanoid @ 8192 worlds, 1000 steps, OU-Halton
ctrl noise — the reference's protocol (benchmarks/config.txt:22,
testspeed.py:53-54). Prints ONE JSON line.

Baseline: reference mujoco_warp on its nightly GPU rig: 2,729,192
steps/s (BASELINE.md).
"""

import json
import os

import jax


BASELINE = 2_729_192.0


def main():
  nworld = int(os.environ.get('BENCH_NWORLD', 8192))
  nstep = int(os.environ.get('BENCH_NSTEP', 1000))

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import models, parallel, snapshot
  from mujoco_warp_tpu.utils.benchmark import benchmark

  m = snapshot.load(models.snapshot_path('humanoid'))
  # protocol-faithful default: the reference config runs nconmax=24
  # (benchmarks/config.txt:22, benchmarks/README.md:56); BENCH_NCONMAX
  # overrides for tuned secondary runs
  d = mjwt.make_data(m, nconmax=int(os.environ.get('BENCH_NCONMAX', 24)))
  batch = parallel.make_batch(m, d, nworld)

  # shard the world axis over all local devices (the step itself has
  # no collectives)
  mesh = parallel.make_mesh()
  batch = parallel.shard_batch(batch, mesh)

  metrics = benchmark(None, m, batch, nstep=nstep)  # None = step_batched

  value = metrics['steps_per_sec']
  result = {
      'metric': 'humanoid_steps_per_sec',
      'value': round(value, 1),
      'unit': 'env-steps/s',
      'vs_baseline': round(value / BASELINE, 4),
      'nworld': nworld,
      'nstep': metrics['nstep'],
      'jit_time_s': round(metrics['jit_time'], 2),
      'step_time_us': round(metrics['step_time_us'], 1),
      'converged_worlds': metrics['converged_worlds'],
      'ncon_mean': round(metrics['ncon_mean'], 2),
      'solver_niter_mean': round(metrics['solver_niter_mean'], 2),
      'device': {'platform': jax.devices()[0].platform,
                 'kind': jax.devices()[0].device_kind,
                 'count': len(jax.devices())},
  }
  print(json.dumps(result))


if __name__ == '__main__':
  main()
