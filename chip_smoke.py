"""Drive the batched MuJoCo step on one NVIDIA GPU and check its output.

  python chip_smoke.py                # one GPU: the phases below
  python chip_smoke.py --four-cards   # four GPUs: the sharded step only

One GPU: the humanoid at its protocol row (benchmarks/scenes/config.txt:
8192 worlds, nconmax 24) is built from the shipped Model snapshot with
make_data -> parallel.make_batch and stepped through
utils.benchmark.benchmark (jitted step_batched with donated buffers,
OU-Halton control noise). It prints the stage path, compile seconds,
us/step, env-steps/s and the compiled step's memory analysis, then checks
the output: no NaN world in the timed run; 64 sampled worlds against the
same step jitted for JAX's CPU backend in this process; four worlds
against C MuJoCo's float64 trajectories in tests/data (written by
tools/write_golden.py); and the repo's tests marked `gpu`, run in this
process. Any failed check makes the exit code nonzero.

--four-cards: the humanoid at 4 x 8192 worlds sharded over four GPUs
(parallel.make_mesh / shard_batch) plus the learner-boundary all_gather
and psum under shard_map, compared world for world with the same worlds
stepped one GPU at a time.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}, printed only when every check passed.
"""

import argparse
import concurrent.futures
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NWORLD = 8192
NCONMAX = 24
NSTEP = 300          # timed benchmark steps
NSAMPLE = 64         # worlds compared with the CPU reference
NROLL = 100          # steps of the trajectory comparisons
GOLDEN = os.path.join(REPO, 'tests', 'data', 'humanoid_mujoco_golden.npz')

# Tolerances, each relative to the world's largest |reference| entry
# (floored at 1) unless marked absolute.
# GPU f32 against CPU f32: the same arithmetic in another summation
# order, so a world may stop one Newton iteration earlier or later (the
# stopping tests compare f32 cost changes with the tolerance). On the
# card qacc differed by up to 3.8e-4 and the forces by up to 6.9e-5;
# TF32 products (about 5e-4 relative each) would move the forces past
# their limit.
TOL_CPU = {'qacc': 1e-3, 'qfrc_constraint': 3e-4, 'efc_force': 3e-4}
# qpos after 100 steps, absolute: these worlds fall and land inside the
# window, and a contact that opens or closes one step apart moves qpos
# by ~1e-3 (two CPU runs of the same states at 32 and 8 worlds differ
# by 1.3e-3).
TOL_CPU_QPOS = 1e-2
# Against C MuJoCo (float64, solver tolerance 1e-8 against our f32
# floor of 1e-6): CPU f32 runs of this engine reach 6.1e-4 (qacc),
# 5.9e-5 (qfrc_constraint), 3.3e-6 (qpos, one step) and 1.5e-4 (qpos,
# 100 steps, absolute) on these four worlds; the limits leave ~3x room.
TOL_MJ = {'qacc': 2e-3, 'qfrc_constraint': 2e-4, 'qpos': 1e-5}
TOL_MJ_QPOS100 = 5e-4


def world_err(a, ref) -> np.ndarray:
  """Per-world max |a - ref| over the world's largest |ref| (>= 1)."""
  a = np.asarray(a, np.float64).reshape(len(a), -1)
  ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
  scale = np.maximum(np.abs(ref).max(axis=1, initial=0.0), 1.0)
  return np.abs(a - ref).max(axis=1, initial=0.0) / scale


def check(name: str, err, tol: float) -> bool:
  """Print one comparison line; True when every entry is within tol."""
  err = np.asarray(err, np.float64)
  ok = bool(np.all(np.isfinite(err)) and np.all(err <= tol))
  print(f'check {name}: max {err.max():.3e} (tol {tol:.1e}, '
        f'{err.size} worlds) {"ok" if ok else "FAIL"}', flush=True)
  return ok


def take(tree, idx):
  """The worlds idx of a batched pytree."""
  import jax
  return jax.tree.map(
      lambda x: x[idx] if hasattr(x, 'ndim') and x.ndim else x, tree)


def to_device(tree, device):
  import jax
  return jax.tree.map(
      lambda x: jax.device_put(x, device) if isinstance(x, jax.Array)
      else x, tree)


def _gpu_or_exit():
  """JAX with CUDA as the default backend and the CPU beside it, or exit
  nonzero: this script does not run on the CPU alone."""
  import jax
  jax.config.update('jax_platforms', 'cuda,cpu')
  try:
    dev = jax.devices()[0]
  except RuntimeError as e:
    sys.exit(f'chip_smoke: no GPU ({e})')
  if dev.platform != 'gpu':
    sys.exit(f'chip_smoke: default device is {dev.platform}, not gpu')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  print(f'nvidia-smi: {smi}')
  print(f'jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}')
  return jax


def _humanoid():
  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import models, snapshot
  m = snapshot.load(models.snapshot_path('humanoid'))
  d = mjwt.make_data(m, nconmax=NCONMAX)
  print(f'humanoid: nq {m.nq} nv {m.nv} nu {m.nu}; nconmax {NCONMAX} '
        f'gives {d.efc_J.shape[-2]} fixed efc rows (the config row\'s '
        f'njmax 64 is a pool size; rows here live at fixed addresses)')
  return m, d


def one_card(jax) -> bool:
  import jax.numpy as jnp

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import parallel
  from mujoco_warp_tpu.utils.benchmark import benchmark

  kind = jax.devices()[0].device_kind
  m, d = _humanoid()
  log = logging.getLogger('mujoco_warp_tpu.forward')
  log.setLevel(logging.INFO)
  log.addHandler(logging.StreamHandler(sys.stdout))

  # The correctness phase needs the plain step (no control noise) for the
  # GPU and for the CPU: compile both in threads while the timed run
  # compiles its own step
  batch = parallel.make_batch(m, d, NWORLD)
  cpu = jax.devices('cpu')[0]
  ng = len(np.load(GOLDEN)['qpos0'])
  idx = np.sort(np.random.default_rng(0).choice(
      np.arange(ng, NWORLD), NSAMPLE, replace=False))
  m_cpu = to_device(m, cpu)
  t0 = time.perf_counter()
  lowered = [
      jax.jit(lambda x: mjwt.step_batched(m, x)).lower(batch),
      jax.jit(lambda x: mjwt.step_batched(m_cpu, x)).lower(
          to_device(take(batch, idx), cpu))]
  pool = concurrent.futures.ThreadPoolExecutor(len(lowered))
  compiling = [pool.submit(lo.compile) for lo in lowered]

  # timed run
  res = benchmark(None, m, batch, nstep=NSTEP)
  print(f'compile+first step: {res["jit_time"]:.2f} s')
  print(f'humanoid@{NWORLD} on {kind}: {res["step_time_us"]:.1f} us/step, '
        f'{res["steps_per_sec"]:.1f} env-steps/s over {res["nstep"]} '
        f'steps; ncon mean {res["ncon_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f}')
  print(f'memory_analysis: {res["memory_analysis"]}')
  ok = check('nan_worlds', [NWORLD - res['converged_worlds']], 0)

  # correctness: worlds 0-3 restart from the C MuJoCo golden states,
  # the others continue from the timed run; one full-width GPU step
  # function serves both comparisons
  golden = np.load(GOLDEN)
  step, step_cpu = [c.result() for c in compiling]
  pool.shutdown()
  print(f'plain steps for GPU and CPU compiled '
        f'{time.perf_counter() - t0:.2f} s after they started')
  gb = parallel.make_batch(m, d, ng).replace(
      qpos=jnp.asarray(golden['qpos0'], jnp.float32),
      qvel=jnp.asarray(golden['qvel0'], jnp.float32),
      ctrl=jnp.asarray(golden['ctrl'], jnp.float32))
  x0 = jax.tree.map(
      lambda x, g: x.at[:ng].set(g) if hasattr(x, 'ndim') and x.ndim
      else x, res['final'], gb)
  x1 = step(x0)
  xn = x1
  for _ in range(NROLL - 1):
    xn = step(xn)
  nan = int(jnp.sum(jnp.any(jnp.isnan(xn.qpos), axis=-1)))
  ok &= check('nan_worlds_rollout', [nan], 0)

  # the plain reference: the same step jitted for the CPU backend
  r1 = step_cpu(to_device(take(x0, idx), cpu))
  g1 = take(x1, idx)
  for f, tol in TOL_CPU.items():
    ok &= check(f'cpu_ref_{f}_1step',
                world_err(getattr(g1, f), getattr(r1, f)), tol)
  rn = r1
  for _ in range(NROLL - 1):
    rn = step_cpu(rn)
  ok &= check(f'cpu_ref_qpos_{NROLL}steps_abs',
              np.abs(np.asarray(take(xn, idx).qpos) -
                     np.asarray(rn.qpos)).max(axis=1), TOL_CPU_QPOS)

  # C MuJoCo float64
  for f, tol in TOL_MJ.items():
    ok &= check(f'mujoco_{f}_1step',
                world_err(np.asarray(getattr(x1, f))[:ng],
                          golden[f + '1']), tol)
  ok &= check(f'mujoco_qpos_{NROLL}steps_abs',
              np.abs(np.asarray(xn.qpos)[:ng] -
                     golden['qpos100']).max(axis=1), TOL_MJ_QPOS100)

  # the repo's tests marked gpu, in this process (one process per card)
  import pytest
  os.environ['MJWT_TEST_PLATFORM'] = 'cuda,cpu'
  rc = pytest.main(['-q', '-p', 'no:cacheprovider', '-m', 'gpu',
                    os.path.join(REPO, 'tests', 'test_gpu.py')])
  ok &= check('gpu_marked_tests_exit_code', [int(rc)], 0)
  return ok


def four_cards(jax) -> bool:
  import jax.numpy as jnp
  from jax import shard_map
  from jax.sharding import NamedSharding, PartitionSpec as P

  import mujoco_warp_tpu as mjwt
  from mujoco_warp_tpu import parallel

  devices = jax.devices()
  if len(devices) < 4:
    sys.exit(f'chip_smoke --four-cards: {len(devices)} GPUs, need 4')
  devices = devices[:4]
  m, d = _humanoid()
  nw = 4 * NWORLD
  nstep = 20
  batch = parallel.make_batch(m, d, nw, qpos_noise=0.01)
  mesh = parallel.make_mesh(devices)
  xs = parallel.shard_batch(batch, mesh)
  shards = [to_device(take(batch, np.arange(k * NWORLD, (k + 1) * NWORLD)),
                      devices[0]) for k in range(4)]
  worlds = NamedSharding(mesh, P(parallel.WORLD_AXIS))
  t0 = time.perf_counter()
  lowered = [
      jax.jit(lambda x: mjwt.step_batched(m, x), in_shardings=worlds,
              out_shardings=worlds).lower(xs),
      jax.jit(lambda x: mjwt.step_batched(m, x)).lower(shards[0])]
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    sharded, single = pool.map(lambda lo: lo.compile(), lowered)
  print(f'sharded and one-card steps compiled: '
        f'{time.perf_counter() - t0:.2f} s')

  xs = sharded(xs)
  jax.block_until_ready(xs.qpos)
  t0 = time.perf_counter()
  for _ in range(nstep - 1):
    xs = sharded(xs)
  jax.block_until_ready(xs.qpos)
  dt = time.perf_counter() - t0
  print(f'humanoid@{nw} over 4 x {devices[0].device_kind}: '
        f'{1e6 * dt / (nstep - 1):.1f} us/step, '
        f'{nw * (nstep - 1) / dt:.1f} env-steps/s')

  def boundary(qpos):
    return (parallel.gather_observations(qpos),
            parallel.psum_stats(jnp.sum(qpos[:, 2])))
  obs, total = jax.jit(shard_map(
      boundary, mesh=mesh, in_specs=(P(parallel.WORLD_AXIS),),
      out_specs=(P(), P()), check_vma=False))(xs.qpos)
  qpos_s = np.asarray(xs.qpos)
  ok = check('all_gather', [np.abs(np.asarray(obs) - qpos_s).max()], 0)
  ok &= check('psum', [abs(float(total) - qpos_s[:, 2].astype(
      np.float64).sum()) / nw], 1e-5)

  # the same worlds, one GPU at a time
  for k, x1 in enumerate(shards):
    for _ in range(nstep):
      x1 = single(x1)
    ok &= check(f'shard{k}_qpos_vs_one_card_abs',
                np.abs(np.asarray(x1.qpos) -
                       qpos_s[k * NWORLD:(k + 1) * NWORLD]).max(axis=1),
                1e-5)
  return ok


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--four-cards', action='store_true',
                  help='run only the sharded step on four GPUs')
  args = ap.parse_args()
  jax = _gpu_or_exit()
  sys.path.insert(0, REPO)
  ok = four_cards(jax) if args.four_cards else one_card(jax)
  if not ok:
    sys.exit('chip_smoke: a check failed')
  dev = jax.devices()[0]
  print(json.dumps({'ok': True, 'device': {
      'platform': dev.platform, 'kind': dev.device_kind,
      'count': len(jax.devices())}}))


if __name__ == '__main__':
  main()
