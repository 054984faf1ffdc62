"""Reference benchmark suite runner: executes the configs from the
reference's benchmarks/config.txt (copied to scenes/config.txt) on the
engine and emits one JSON line per config — the analogue of the
reference's run.sh over mjwarp-testspeed (reference benchmarks/run.sh,
testspeed.py:46-161).

Usage:
  python benchmarks/suite.py humanoid franka_emika_panda ...
  python benchmarks/suite.py --all
  BENCH_NWORLD=1024 python benchmarks/suite.py humanoid   # override
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

_SCENES = os.path.join(os.path.dirname(__file__), 'scenes')


def parse_config(path: str | None = None) -> dict:
  path = path or os.path.join(_SCENES, 'config.txt')
  out = {}
  for line in open(path):
    line = line.strip()
    if not line or line.startswith('#'):
      continue
    parts = line.split()
    name, mjcf, nworld, nconmax, njmax = parts[:5]
    nstep = parts[5] if len(parts) > 5 else '-'
    replay = parts[6] if len(parts) > 6 else '-'
    out[name] = dict(
        mjcf=os.path.join(_SCENES, mjcf),
        nworld=int(nworld), nconmax=int(nconmax), njmax=int(njmax),
        nstep=1000 if nstep == '-' else int(nstep),
        replay=None if replay == '-' else replay)
  # kitchen ships as a scene (ref benchmarks/kitchen) without a
  # config.txt row; give it one so the suite can record a number for
  # the large-scene (SAP-role) broadphase path
  if 'kitchen' not in out:
    out['kitchen'] = dict(
        mjcf=os.path.join(_SCENES, 'kitchen', 'kitchen.xml'),
        nworld=256, nconmax=64, njmax=256, nstep=100, replay=None)
  return out


def run_config(name: str, cfg: dict, nworld: int | None = None,
               nstep: int | None = None) -> dict:
  import jax
  import jax.numpy as jnp
  import mujoco
  import numpy as np

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import io as io_mod
  from mujoco_warp_tpu import parallel
  import importlib
  bench_mod = importlib.import_module('mujoco_warp_tpu.utils.benchmark')

  nworld = nworld or int(os.environ.get('BENCH_NWORLD', cfg['nworld']))
  nstep = nstep or int(os.environ.get('BENCH_NSTEP', cfg['nstep']))

  mjm = mujoco.MjModel.from_xml_path(cfg['mjcf'])
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=cfg['nconmax'])
  if mjm.nkey > 0 and cfg['replay'] is None:
    d = io_mod.reset_data(m, d, keyframe=0)
  batch = parallel.make_batch(m, d, nworld)

  if cfg['replay']:
    keys = io_mod.find_keys(mjm, cfg['replay'])
    traj = jnp.asarray(io_mod.make_trajectory(mjm, keys), jnp.float32)
    d = io_mod.reset_data(m, d, keyframe=keys[0])
    batch = parallel.make_batch(m, d, nworld)
    metrics = bench_mod.benchmark_replay(m, batch, traj, nstep=nstep)
  else:
    metrics = bench_mod.benchmark(None, m, batch, nstep=nstep)

  metrics.pop('final', None)
  return dict(
      metric=f'{name}_steps_per_sec',
      value=round(metrics['steps_per_sec'], 1),
      unit='env-steps/s',
      nworld=nworld, nstep=metrics['nstep'],
      jit_time_s=round(metrics['jit_time'], 2),
      step_time_us=round(metrics['step_time_us'], 1),
      converged_worlds=metrics['converged_worlds'],
      ncon_mean=round(metrics['ncon_mean'], 2),
      nefc_mean=round(metrics['nefc_mean'], 2),
      solver_niter_mean=round(metrics['solver_niter_mean'], 2),
  )


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('configs', nargs='*')
  ap.add_argument('--all', action='store_true')
  ap.add_argument('--nworld', type=int, default=None)
  ap.add_argument('--nstep', type=int, default=None)
  ap.add_argument('--out', default=None,
                  help='append each result as a JSONL line (with commit '
                       '+ timestamp) to this file')
  args = ap.parse_args()
  table = parse_config()
  names = list(table) if args.all else args.configs
  commit = None
  if args.out:
    import subprocess
    try:
      commit = subprocess.run(['git', 'rev-parse', '--short', 'HEAD'],
                              capture_output=True, text=True,
                              cwd=os.path.dirname(__file__)).stdout.strip()
    except Exception:
      pass
  for name in names:
    if name not in table:
      print(json.dumps({'metric': name, 'error': 'unknown config'}))
      continue
    try:
      t0 = time.time()
      res = run_config(name, table[name], args.nworld, args.nstep)
      res['total_s'] = round(time.time() - t0, 1)
    except Exception as e:  # keep the suite going past one bad scene
      res = {'metric': name, 'error': f'{type(e).__name__}: '
             f'{str(e)[:300]}'}
    print(json.dumps(res), flush=True)
    if args.out:
      with open(args.out, 'a') as f:
        f.write(json.dumps({**res, 'commit': commit,
                            'ts': time.strftime('%Y-%m-%dT%H:%M:%S')}) +
                '\n')


if __name__ == '__main__':
  main()
