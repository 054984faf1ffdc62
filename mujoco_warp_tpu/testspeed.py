"""mjwt-testspeed: benchmark CLI (reference: mujoco_warp/
testspeed.py). Loads an MJCF, applies string overrides, steps a world
batch with OU-Halton ctrl noise, and reports the reference's metric
shape (steps/s, jit time, ncon/nefc stats, solver iterations, per-stage
times, memory) as human text or one-line JSON.

Usage:
  python -m mujoco_warp_tpu.testspeed PATH.xml [--nworld N] [--nstep N]
      [--nconmax N] [-o opt.solver=cg ...] [--output human|json]
      [--event_trace] [--keyframe K]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import mujoco
import numpy as np


def _stage_times(m, batch, nrep=20):
  """Per-stage timings of the REAL step_batched pipeline: the stage
  list comes from forward.batched_stages, i.e. the exact sequence (and
  solver choice) that step_batched executes, plus the integrator. Stage boundaries force
  materialization, so each stage exceeds its fused share — ratios
  matter (the reference's event_trace has the same caveat)."""
  import importlib
  fwd = importlib.import_module(f'{__package__}.forward')
  from .types import IntegratorType

  out = {}

  def timeit(name, fn, arg):
    jitted = jax.jit(fn)
    res = jitted(arg)
    jax.block_until_ready(jax.tree_util.tree_leaves(res)[0])
    t0 = time.perf_counter()
    for _ in range(nrep):
      res = jitted(arg)
    jax.block_until_ready(jax.tree_util.tree_leaves(res)[0])
    out[name] = (time.perf_counter() - t0) / nrep * 1e6
    return res

  b = batch
  stages = fwd.batched_stages(m, batch)
  for name, fn in stages:
    b = timeit(f'step.forward.{name}', fn, b)
  integ = {IntegratorType.EULER: ('euler', fwd._euler_batched),
           IntegratorType.RK4: ('rk4', fwd._rk4_batched),
           IntegratorType.IMPLICITFAST: ('implicitfast',
                                         fwd._implicit_batched)}
  iname, ifn = integ[m.opt.integrator]
  timeit(f'step.{iname}', lambda bb: ifn(m, bb), b)
  return out


def _benchmark_function(m, batch, name: str, nrep: int):
  """Benchmark ONE pipeline stage by name (reference testspeed
  --function benchmarks any public mjwarp function). The batch is
  warmed through a full forward first so the stage sees a realistic
  regime (contacts active, efc rows populated)."""
  import importlib
  fwd = importlib.import_module(f'{__package__}.forward')

  stages = fwd.batched_stages(m, batch)
  names = [n for n, _ in stages]
  if name not in names:
    raise SystemExit(f'unknown stage {name!r}; choices: {names}')
  b = batch
  for n, fn in stages:         # warm forward: realistic input state
    b = jax.jit(fn)(b)
  fn = dict(stages)[name]
  jitted = jax.jit(fn)
  t0 = time.perf_counter()
  res = jitted(b)
  jax.block_until_ready(jax.tree_util.tree_leaves(res)[0])
  jit_time = time.perf_counter() - t0
  nrep = max(min(nrep, 1000), 10)
  t0 = time.perf_counter()
  for _ in range(nrep):
    res = jitted(b)
  jax.block_until_ready(jax.tree_util.tree_leaves(res)[0])
  dt = (time.perf_counter() - t0) / nrep
  return {
      'function': name,
      'nworld': int(batch.qpos.shape[0]),
      'nrep': nrep,
      'jit_time_s': round(jit_time, 2),
      'time_us': round(dt * 1e6, 1),
      'per_world_ns': round(dt * 1e9 / batch.qpos.shape[0], 2),
  }


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('mjcf')
  p.add_argument('--nworld', type=int, default=8192)
  p.add_argument('--nstep', type=int, default=1000)
  p.add_argument('--nconmax', type=int, default=None)
  p.add_argument('-o', '--override', action='append', default=[])
  p.add_argument('--output', choices=('human', 'json'), default='human')
  p.add_argument('--event_trace', action='store_true')
  p.add_argument('--keyframe', type=int, default=None)
  p.add_argument('--ctrlnoise_std', type=float, default=0.01)
  p.add_argument('--replay', default=None, metavar='PREFIX',
                 help='replay keyframe ctrl sequence (name prefix match,'
                      ' reference testspeed --replay)')
  p.add_argument('--function', default='step', metavar='NAME',
                 help='benchmark one pipeline stage by name instead of '
                      'the full step (reference testspeed --function); '
                      'stage names as printed by --event_trace, e.g. '
                      'fwd_position, solve[xla]')
  args = p.parse_args(argv)

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import parallel
  from mujoco_warp_tpu.utils.benchmark import benchmark
  from mujoco_warp_tpu.utils.benchmark import benchmark_replay

  mjm = mujoco.MjModel.from_xml_path(args.mjcf)
  m = mjwt.put_model(mjm)
  if args.override:
    from mujoco_warp_tpu import io as io_mod
    m = io_mod.override_model(m, args.override)
  d = mjwt.make_data(m, nconmax=args.nconmax)
  if args.keyframe is not None:
    from mujoco_warp_tpu import io as io_mod
    d = io_mod.reset_data(m, d, keyframe=args.keyframe)
  batch = parallel.make_batch(m, d, args.nworld)
  mesh = parallel.make_mesh()
  batch = parallel.shard_batch(batch, mesh)

  if args.function != 'step':
    metrics = _benchmark_function(m, batch, args.function, args.nstep)
    print(json.dumps(metrics) if args.output == 'json' else
          '\n'.join(f'{k:28s} {v}' for k, v in metrics.items()))
    return

  if args.replay is not None:
    from mujoco_warp_tpu import io as io_mod
    keys = io_mod.find_keys(mjm, args.replay)
    if not keys:
      raise SystemExit(f'no keyframes match prefix {args.replay!r}')
    traj = jnp.asarray(io_mod.make_trajectory(mjm, keys))
    batch = batch.replace(qpos=jnp.broadcast_to(
        jnp.asarray(mjm.key_qpos[keys[0]], batch.qpos.dtype),
        batch.qpos.shape))
    metrics = benchmark_replay(m, batch, traj, nstep=args.nstep)
  else:
    metrics = benchmark(None, m, batch, nstep=args.nstep,
                        ctrlnoise_std=args.ctrlnoise_std)
  final = metrics.pop('final')
  metrics.pop('memory_analysis', None)

  # memory report (reference testspeed.py:101-141)
  def nbytes(tree):
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, 'size'))
  metrics['model_memory_mb'] = round(nbytes(m) / 1e6, 2)
  metrics['data_memory_mb'] = round(nbytes(final) / 1e6, 2)
  metrics['nefc_mean'] = float(jnp.mean(final.nefc))
  metrics['ncon_p95'] = float(jnp.percentile(
      final.ncon.astype(jnp.float32), 95))
  metrics['solver_niter_p95'] = float(jnp.percentile(
      final.solver_niter.astype(jnp.float32), 95))

  if args.event_trace:
    # `batch` was donated into the benchmark loop; trace on the final
    # state (same shapes, warm regime — contacts/efc active)
    metrics['event_trace_us'] = {k: round(v, 1) for k, v in
                                 _stage_times(m, final).items()}

  if args.output == 'json':
    print(json.dumps(metrics))
  else:
    for k, v in metrics.items():
      print(f'{k:28s} {v}')


if __name__ == '__main__':
  main()
