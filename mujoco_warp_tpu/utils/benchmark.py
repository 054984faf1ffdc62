"""Benchmark harness (reference: mujoco_warp/_src/benchmark.py).

The reference captures one CUDA graph and replays it nstep times; here
one jitted step with donated buffers is dispatched nstep times, with the
same Ornstein-Uhlenbeck Halton control noise protocol
(benchmark.py:41-83) so numbers are comparable.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Data, Model


def halton(index: jax.Array, base: int) -> jax.Array:
  """Radical-inverse Halton sequence (reference util_misc.py:60) with a
  STATIC integer base: the digit loop unrolls and every % and // is by
  a constant, so the whole digit sum is one fused elementwise kernel
  (a lax.fori_loop would emit one small kernel per digit, and a traced
  base would make every division a dynamic integer division)."""
  base = int(base)
  idx = index.astype(jnp.int32)
  # enough digits to cover any int32 index: base**d <= 2^31
  ndig = int(np.floor(31 / np.log2(base))) + 1
  bpow = np.power(float(base), -np.arange(1, ndig + 1))  # 1/b^(d+1)
  r = jnp.zeros(idx.shape, jnp.float32)
  for d in range(ndig):
    digit = (idx % base).astype(jnp.float32)
    r = r + jnp.float32(bpow[d]) * digit
    idx = idx // base
  return r


def ctrl_noise(m: Model, ctrl: jax.Array, worldid: jax.Array,
               step: jax.Array, std: float = 0.01,
               rate_s: float = 0.1) -> jax.Array:
  """OU control noise with Halton quasirandomness (deterministic across
  runs, like the reference)."""
  nu = ctrl.shape[-1]
  if nu == 0:  # passive scene (cloth): nothing to perturb
    return ctrl
  rate = jnp.exp(-m.opt.timestep / rate_s)
  scale = std * jnp.sqrt(1.0 - rate * rate)
  limited = jnp.array(m.actuator_ctrllimited, dtype=bool)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  midpoint = jnp.where(limited, 0.5 * (lo + hi), 0.0)
  halfrange = jnp.where(limited, 0.5 * (hi - lo), 1.0)
  idx = (step + 1) * (worldid + 1)
  # static python base per actuator → strength-reduced int division
  h = jnp.stack([halton(idx, a + 2) for a in range(nu)], axis=0)
  new = rate * ctrl + (1.0 - rate) * midpoint
  new = new + scale * halfrange * (2.0 * h - 1.0)
  return jnp.where(limited, jnp.clip(new, lo, hi), new)


def benchmark(step_fn: Callable[[Model, Data], Data], m: Model,
              batch: Data, nstep: int, ctrlnoise_std: float = 0.01,
              ctrlnoise_rate: float = 0.1,
              chunk: int = 100) -> dict:
  """Run nstep batched steps with ctrl noise; return the reference's
  metric dict shape (steps/s, jit time, convergence), plus the compiled
  step's memory_analysis()."""
  nworld = batch.qpos.shape[0]
  worldids = jnp.arange(nworld, dtype=jnp.int32)

  from ..forward import step_batched

  def one_step(d, ids, step_i):
    noisy = jax.vmap(
        lambda c, w: ctrl_noise(m, c, w, step_i, ctrlnoise_std,
                                ctrlnoise_rate))(d.ctrl, ids)
    d = d.replace(ctrl=noisy)
    if step_fn is None:
      d = step_batched(m, d)
    else:
      d = jax.vmap(step_fn, in_axes=(None, 0))(m, d)
    return d, ids, step_i + 1

  # python-loop dispatch with donated buffers beats lax.scan here: the
  # scan carry copies the full Data pytree every step, while donation
  # reuses it in place (the analogue of the reference replaying one
  # CUDA graph on fixed buffers, benchmark.py:128-157)
  run_step = jax.jit(one_step, donate_argnums=(0,))

  ids = worldids
  t0 = time.perf_counter()
  step0 = jnp.zeros((), jnp.int32)
  compiled = run_step.lower(batch, ids, step0).compile()
  d, ids, step_i = compiled(batch, ids, step0)
  jax.block_until_ready(d.qpos)
  jit_time = time.perf_counter() - t0

  warmup = min(20, nstep)
  for _ in range(warmup):
    d, ids, step_i = compiled(d, ids, step_i)
  jax.block_until_ready(d.qpos)
  t0 = time.perf_counter()
  steps_done = max(nstep - warmup - 1, 1)
  for _ in range(steps_done):
    d, ids, step_i = compiled(d, ids, step_i)
  jax.block_until_ready(d.qpos)
  run_time = time.perf_counter() - t0
  del chunk

  nan_worlds = int(jnp.sum(jnp.any(jnp.isnan(d.qpos), axis=-1)))
  return dict(
      nworld=nworld,
      nstep=steps_done,
      jit_time=jit_time,
      run_time=run_time,
      steps_per_sec=steps_done * nworld / max(run_time, 1e-9),
      step_time_us=1e6 * run_time / max(steps_done, 1),
      converged_worlds=nworld - nan_worlds,
      ncon_mean=float(jnp.mean(d.ncon)),
      nefc_mean=float(jnp.mean(d.nefc)),
      solver_niter_mean=float(jnp.mean(d.solver_niter)),
      memory_analysis=compiled.memory_analysis(),
      final=d,
  )


def benchmark_replay(m: Model, batch: Data, traj: jax.Array,
                     nstep: int) -> dict:
  """Replay a keyframe ctrl trajectory (reference testspeed --replay:
  ctrl comes from recorded keyframes, clamped to the last frame, instead
  of noise)."""
  nworld = batch.qpos.shape[0]
  nkey = traj.shape[0]

  from ..forward import step_batched

  def one_step(d, step_i):
    idx = jnp.minimum(step_i, nkey - 1)
    ctrl = jnp.broadcast_to(traj[idx], (nworld, traj.shape[1]))
    d = d.replace(ctrl=ctrl)
    d = step_batched(m, d)
    return d, step_i + 1

  run_step = jax.jit(one_step, donate_argnums=(0,))
  t0 = time.perf_counter()
  d, step_i = run_step(batch, jnp.zeros((), jnp.int32))
  jax.block_until_ready(d.qpos)
  jit_time = time.perf_counter() - t0

  warmup = min(20, nstep)
  for _ in range(warmup):
    d, step_i = run_step(d, step_i)
  jax.block_until_ready(d.qpos)
  t0 = time.perf_counter()
  steps_done = max(nstep - warmup - 1, 1)
  for _ in range(steps_done):
    d, step_i = run_step(d, step_i)
  jax.block_until_ready(d.qpos)
  run_time = time.perf_counter() - t0

  nan_worlds = int(jnp.sum(jnp.any(jnp.isnan(d.qpos), axis=-1)))
  return dict(
      nworld=nworld,
      nstep=steps_done,
      jit_time=jit_time,
      run_time=run_time,
      steps_per_sec=steps_done * nworld / max(run_time, 1e-9),
      step_time_us=1e6 * run_time / max(steps_done, 1),
      converged_worlds=nworld - nan_worlds,
      ncon_mean=float(jnp.mean(d.ncon)),
      nefc_mean=float(jnp.mean(d.nefc)),
      solver_niter_mean=float(jnp.mean(d.solver_niter)),
      final=d,
  )
