"""Per-kernel device timing for the real step_batched hot path.

Runs N warm steps under jax.profiler.trace and aggregates device-side op
durations from the trace-viewer JSON (plugins/profile/*/*.trace.json.gz).
Unlike --event_trace (which forces stage materialization), this reports
what the XLA scheduler actually runs. Reference analogue:
mujoco_warp benchmarks use NSight for the same purpose.
"""

import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import mujoco

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, parallel

NWORLD = int(os.environ.get('NWORLD', 8192))
NSTEP = 20


def main():
  xml = sys.argv[1] if len(sys.argv) > 1 else models.HUMANOID
  mjm = mujoco.MjModel.from_xml_path(xml)
  m = mjwt.put_model(mjm)
  d = mjwt.make_data(m, nconmax=int(os.environ.get('NCONMAX', 24)))
  batch = parallel.make_batch(m, d, NWORLD, qpos_noise=0.01)
  step = jax.jit(lambda b: mjwt.step_batched(m, b), donate_argnums=0)
  batch = step(batch)
  for _ in range(30):
    batch = step(batch)
  jax.block_until_ready(batch.qpos)

  tmp = tempfile.mkdtemp(prefix='xprof_')
  with jax.profiler.trace(tmp):
    for _ in range(NSTEP):
      batch = step(batch)
    jax.block_until_ready(batch.qpos)

  files = glob.glob(os.path.join(tmp, '**', '*.trace.json.gz'),
                    recursive=True)
  if not files:
    print('no trace file found under', tmp)
    return
  with gzip.open(files[0], 'rt') as f:
    trace = json.load(f)
  events = trace.get('traceEvents', [])
  # device lanes: on a GPU the trace names them /device:GPU:<n>, one
  # thread per CUDA stream; host threads are the other pids
  proc_names = {}
  for e in events:
    if e.get('ph') == 'M' and e.get('name') == 'process_name':
      proc_names[e['pid']] = e['args'].get('name', '')
  thread_names = {}
  for e in events:
    if e.get('ph') == 'M' and e.get('name') == 'thread_name':
      thread_names[(e['pid'], e.get('tid'))] = e['args'].get('name', '')
  # aggregate per (pid, tid) lane so nesting/duplication across lanes
  # is visible instead of silently double-counted
  lanes = collections.defaultdict(lambda: (collections.Counter(),
                                           collections.Counter()))
  for e in events:
    if e.get('ph') != 'X':
      continue
    key = (e.get('pid'), e.get('tid'))
    agg, cnt = lanes[key]
    agg[e.get('name', '?')] += e.get('dur', 0)
    cnt[e.get('name', '?')] += 1
  for key, (agg, cnt) in sorted(lanes.items(),
                                key=lambda kv: -sum(kv[1][0].values())):
    pname = proc_names.get(key[0], '?')
    tname = thread_names.get(key, '?')
    total = sum(agg.values())
    if total < 1000:
      continue
    where = 'device' if '/device:GPU' in pname else 'host'
    print(f'\n=== {where} lane pid={key[0]} [{pname}] tid={key[1]} [{tname}] '
          f'total {total/NSTEP:.0f} us/step ===')
    print(f'{"us/step":>10} {"%":>6} {"count":>6}  op')
    for name, dur in agg.most_common(25):
      print(f'{dur/NSTEP:10.1f} {100*dur/total:6.2f} {cnt[name]//NSTEP:6d}'
            f'  {name[:100]}')


if __name__ == '__main__':
  main()
