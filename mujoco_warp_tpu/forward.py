"""Step orchestration: forward dynamics pipeline + integrators.

Counterpart of mujoco_warp/_src/forward.py. Every function is pure
``(Model, Data) -> Data``; ``step`` composes the full pipeline and is
designed to be wrapped as ``jax.jit(jax.vmap(step, in_axes=(None, 0)))`` —
the XLA analogue of the reference's CUDA-graph-captured batched step
(forward.py:1004; benchmark.py:128-137).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import collision_driver
from . import constraint
from . import linalg
from . import math
from . import muscle as muscle_mod
from . import passive as passive_mod
from . import sensor as sensor_mod
from . import smooth
from . import solver as solver_mod
from . import support
from .types import (BiasType, Data, DisableBit, DynType, GainType,
                    IntegratorType, JointType, Model)

_EINSUM = dict(precision=jax.lax.Precision.HIGHEST)


def named(name):
  """Trace fn under a named scope (the stage name in profiler traces) and
  at HIGHEST matmul precision: every f32 contraction on the step path is
  full f32, never TF32, which GPUs would otherwise pick for unqualified
  products. Every public step entry point carries this decorator."""
  def deco(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
      with jax.named_scope(name), jax.default_matmul_precision('highest'):
        return fn(*args, **kw)
    return wrapped
  return deco


@named('fwd_position')
def fwd_position(m: Model, d: Data, factorize: bool = True) -> Data:
  """Position-dependent computations (reference forward.py:514).
  factorize=False defers the mass-matrix factorization to the batched
  fused factor+solve in _fwd_acceleration_batched."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  if m.flex_meta.nflex:
    from . import flex as flex_mod
    d = flex_mod.kinematics(m, d)
  d = smooth.camlight(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  d = smooth.tendon_armature(m, d)
  if factorize:
    d = smooth.factor_m(m, d)
  if m.opt.run_collision_detection:
    d = collision_driver.collision(m, d)
  d = constraint.make_constraint(m, d)
  d = smooth.transmission(m, d)
  return d


@named('fwd_velocity')
def fwd_velocity(m: Model, d: Data) -> Data:
  """Velocity-dependent computations (reference forward.py:593)."""
  if m.nu:
    actuator_velocity = jnp.einsum('un,n->u', d.actuator_moment, d.qvel,
                                   **_EINSUM)
    d = d.replace(actuator_velocity=actuator_velocity)
  if m.ntendon:
    d = d.replace(ten_velocity=jnp.einsum('tn,n->t', d.ten_J, d.qvel,
                                          **_EINSUM))
  d = smooth.com_vel(m, d)
  d = passive_mod.passive(m, d)
  d = smooth.rne(m, d)
  d = smooth.tendon_bias(m, d)
  return d


@named('fwd_actuation')
def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces (reference forward.py:837; C mj_fwdActuation)."""
  dtype = d.qpos.dtype
  if m.nu == 0 or m.opt.disableflags & DisableBit.ACTUATION:
    return d.replace(qfrc_actuator=jnp.zeros(m.nv, dtype),
                     actuator_force=jnp.zeros(m.nu, dtype),
                     act_dot=jnp.zeros(m.na, dtype))

  # clamp ctrl
  ctrl = d.ctrl
  if not m.opt.disableflags & DisableBit.CLAMPCTRL:
    limited = jnp.array(m.actuator_ctrllimited, dtype=bool)
    ctrl = jnp.where(limited,
                     jnp.clip(ctrl, m.actuator_ctrlrange[:, 0],
                              m.actuator_ctrlrange[:, 1]), ctrl)

  # fast path: stateless affine actuators (motors/position/velocity
  # servos — the RL benchmark regime) in one fused vector expression
  # instead of a per-actuator trace loop
  import numpy as np
  gts = np.asarray(m.actuator_gaintype)
  bts = np.asarray(m.actuator_biastype)
  simple = (m.na == 0 and
            np.all((gts == GainType.FIXED) | (gts == GainType.AFFINE)) and
            np.all((bts == BiasType.NONE) | (bts == BiasType.AFFINE)))
  if simple:
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    length, velocity = d.actuator_length, d.actuator_velocity
    gain = jnp.where(jnp.asarray(gts == GainType.AFFINE),
                     gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity,
                     gp[:, 0])
    bias = jnp.where(jnp.asarray(bts == BiasType.AFFINE),
                     bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity,
                     0.0)
    force = gain * ctrl + bias
    flimited = jnp.array(m.actuator_forcelimited, dtype=bool)
    force = jnp.where(flimited,
                      jnp.clip(force, m.actuator_forcerange[:, 0],
                               m.actuator_forcerange[:, 1]), force)
    qfrc_actuator = jnp.einsum('un,u->n', d.actuator_moment, force,
                               **_EINSUM)
    if any(m.jnt_actfrclimited):
      dj = np.asarray(m.dof_jntid)
      lo = jnp.asarray(m.jnt_actfrcrange[dj, 0])
      hi = jnp.asarray(m.jnt_actfrcrange[dj, 1])
      lim = jnp.asarray(np.asarray(m.jnt_actfrclimited)[dj].astype(bool))
      qfrc_actuator = jnp.where(lim, jnp.clip(qfrc_actuator, lo, hi),
                                qfrc_actuator)
    return d.replace(act_dot=jnp.zeros(m.na, dtype), actuator_force=force,
                     qfrc_actuator=qfrc_actuator, ctrl=d.ctrl)

  # activation dynamics act_dot
  act_dot = jnp.zeros(m.na, dtype)
  for u in range(m.nu):
    dyntype = m.actuator_dyntype[u]
    if dyntype == DynType.NONE:
      continue
    aadr = m.actuator_actadr[u] + m.actuator_actnum[u] - 1
    if dyntype == DynType.INTEGRATOR:
      act_dot = act_dot.at[aadr].set(ctrl[u])
    elif dyntype in (DynType.FILTER, DynType.FILTEREXACT):
      tau = jnp.maximum(m.actuator_dynprm[u, 0], 1e-8)
      act_dot = act_dot.at[aadr].set((ctrl[u] - d.act[aadr]) / tau)
    elif dyntype == DynType.MUSCLE:
      act_dot = act_dot.at[aadr].set(muscle_mod.muscle_dynamics(
          ctrl[u], d.act[aadr], m.actuator_dynprm[u]))
    else:
      raise NotImplementedError(f'dyntype {dyntype}')

  # force = gain * input + bias
  forces = []
  for u in range(m.nu):
    if m.actuator_dyntype[u] == DynType.NONE:
      inp = ctrl[u]
    else:
      aadr = m.actuator_actadr[u] + m.actuator_actnum[u] - 1
      if m.actuator_actearly[u]:
        inp = d.act[aadr] + m.opt.timestep * act_dot[aadr]
      else:
        inp = d.act[aadr]
    length, velocity = d.actuator_length[u], d.actuator_velocity[u]
    gaintype, biastype = m.actuator_gaintype[u], m.actuator_biastype[u]
    gp, bp = m.actuator_gainprm[u], m.actuator_biasprm[u]
    if gaintype == GainType.FIXED:
      gain = gp[0]
    elif gaintype == GainType.AFFINE:
      gain = gp[0] + gp[1] * length + gp[2] * velocity
    elif gaintype == GainType.MUSCLE:
      gain = muscle_mod.muscle_gain(length, velocity,
                                    m.actuator_lengthrange[u],
                                    m.actuator_acc0[u], gp)
    else:
      raise NotImplementedError(f'gaintype {gaintype}')
    if biastype == BiasType.NONE:
      bias = jnp.zeros((), dtype)
    elif biastype == BiasType.AFFINE:
      bias = bp[0] + bp[1] * length + bp[2] * velocity
    elif biastype == BiasType.MUSCLE:
      bias = muscle_mod.muscle_bias(length, m.actuator_lengthrange[u],
                                    m.actuator_acc0[u], bp)
    else:
      raise NotImplementedError(f'biastype {biastype}')
    forces.append(gain * inp + bias)
  force = jnp.stack(forces)

  flimited = jnp.array(m.actuator_forcelimited, dtype=bool)
  force = jnp.where(flimited,
                    jnp.clip(force, m.actuator_forcerange[:, 0],
                             m.actuator_forcerange[:, 1]), force)

  qfrc_actuator = jnp.einsum('un,u->n', d.actuator_moment, force, **_EINSUM)
  # per-dof actuator force clamp (jnt_actfrclimited)
  if any(m.jnt_actfrclimited):
    lo = jnp.array([m.jnt_actfrcrange[m.dof_jntid[i], 0]
                    for i in range(m.nv)])
    hi = jnp.array([m.jnt_actfrcrange[m.dof_jntid[i], 1]
                    for i in range(m.nv)])
    lim = jnp.array([bool(m.jnt_actfrclimited[m.dof_jntid[i]])
                     for i in range(m.nv)])
    qfrc_actuator = jnp.where(lim, jnp.clip(qfrc_actuator, lo, hi),
                              qfrc_actuator)
  return d.replace(act_dot=act_dot, actuator_force=force,
                   qfrc_actuator=qfrc_actuator, ctrl=d.ctrl)


@named('fwd_acceleration')
def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth accelerations (reference forward.py:950)."""
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_applied +
                 d.qfrc_actuator + support.xfrc_accumulate(m, d))
  qacc_smooth = smooth.solve_m(m, d, qfrc_smooth)
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


@named('fwd_acceleration')
def _fwd_acceleration_batched(m: Model, d: Data) -> Data:
  """Batch-native acceleration: batched factor + solve, qLD cached for
  the CG solver's preconditioner."""
  qfrc_smooth = jax.vmap(
      lambda dd: (dd.qfrc_passive - dd.qfrc_bias + dd.qfrc_applied +
                  dd.qfrc_actuator + support.xfrc_accumulate(m, dd)))(d)
  qacc_smooth, qld = solver_mod.m_solve_factor(m, d.qM, qfrc_smooth)
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth,
                   qLD=qld)


@named('forward')
def forward(m: Model, d: Data, control_fn=None, passive_fn=None,
            sensor_fn=None) -> Data:
  """Full forward dynamics (reference forward.py:973).

  Optional user hooks (the reference's Callback surface,
  types.py:810-830): each is a jittable ``(Model, Data) -> Data`` called
  at the same pipeline points as the reference (control before
  actuation, passive after built-in passive forces, sensor after
  sensor_acc)."""
  if control_fn or passive_fn or sensor_fn:
    d = fwd_position(m, d)
    d = sensor_mod.sensor_pos(m, d)
    d = fwd_velocity(m, d)
    if passive_fn is not None:
      d = passive_fn(m, d)
    d = sensor_mod.sensor_vel(m, d)
    if control_fn is not None:
      d = control_fn(m, d)
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = solver_mod.solve(m, d)
    d = sensor_mod.sensor_acc(m, d)
    if sensor_fn is not None:
      d = sensor_fn(m, d)
    return d
  d = fwd_position(m, d)
  d = sensor_mod.sensor_pos(m, d)
  if m.opt.enableflags & 2:  # EnableBit.ENERGY
    d = sensor_mod.energy_pos(m, d)
  d = fwd_velocity(m, d)
  d = sensor_mod.sensor_vel(m, d)
  if m.opt.enableflags & 2:
    d = sensor_mod.energy_vel(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = solver_mod.solve(m, d)
  d = sensor_mod.sensor_acc(m, d)
  return d


def _integrate_pos(m: Model, qpos: jax.Array, qvel: jax.Array,
                   dt) -> jax.Array:
  """mj_integratePos: joint-type-aware position integration, vectorized
  with static index tables (linear dofs: one gather/scatter; quaternion
  joints: one vmapped exact quat integration)."""
  import numpy as np
  out = qpos
  # linear qpos entries (slide/hinge scalars + free translations)
  lin_q, lin_d = [], []
  quat_q, quat_d = [], []
  for j in range(m.njnt):
    jtype = m.jnt_type[j]
    qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
    if jtype == JointType.FREE:
      lin_q += [qadr, qadr + 1, qadr + 2]
      lin_d += [dadr, dadr + 1, dadr + 2]
      quat_q.append(qadr + 3)
      quat_d.append(dadr + 3)
    elif jtype == JointType.BALL:
      quat_q.append(qadr)
      quat_d.append(dadr)
    else:
      lin_q.append(qadr)
      lin_d.append(dadr)
  if lin_q:
    lq = np.asarray(lin_q)
    ld = np.asarray(lin_d)
    out = out.at[lq].set(qpos[lq] + dt * qvel[ld])
  if quat_q:
    qidx = np.asarray(quat_q)[:, None] + np.arange(4)[None, :]
    didx = np.asarray(quat_d)[:, None] + np.arange(3)[None, :]
    quats = jax.vmap(math.quat_integrate, in_axes=(0, 0, None))(
        qpos[qidx], qvel[didx], dt)
    out = out.at[qidx.reshape(-1)].set(quats.reshape(-1))
  return out


def _advance_act(m: Model, d: Data, act_dot: jax.Array) -> jax.Array:
  """Activation integration with FILTEREXACT + actrange clamping."""
  if m.na == 0:
    return d.act
  h = m.opt.timestep
  act = d.act + act_dot * h
  for u in range(m.nu):
    if m.actuator_dyntype[u] == DynType.FILTEREXACT:
      aadr = m.actuator_actadr[u] + m.actuator_actnum[u] - 1
      tau = jnp.maximum(m.actuator_dynprm[u, 0], 1e-8)
      act = act.at[aadr].set(
          d.act[aadr] + act_dot[aadr] * tau * (1.0 - jnp.exp(-h / tau)))
  for u in range(m.nu):
    if m.actuator_actlimited[u]:
      aadr = m.actuator_actadr[u] + m.actuator_actnum[u] - 1
      act = act.at[aadr].set(jnp.clip(act[aadr], m.actuator_actrange[u, 0],
                                      m.actuator_actrange[u, 1]))
  return act


def _advance(m: Model, d: Data, act_dot: jax.Array, qacc: jax.Array,
             qvel: jax.Array | None = None) -> Data:
  """mj_advance (reference forward.py:213): semi-implicit update."""
  act = _advance_act(m, d, act_dot)
  qvel_new = d.qvel + qacc * m.opt.timestep if qvel is None else qvel
  qpos = _integrate_pos(m, d.qpos, qvel_new, m.opt.timestep)
  return d.replace(act=act, qvel=qvel_new, qpos=qpos,
                   time=d.time + m.opt.timestep,
                   qacc_warmstart=d.qacc)


@named('euler')
def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit-in-velocity joint damping
  (reference forward.py:327; C mj_Euler)."""
  qacc = d.qacc
  # implicit damping: (M + h diag(B)) qacc' = qfrc_smooth + qfrc_constraint
  if m.has_damping and not (m.opt.disableflags & DisableBit.EULERDAMP):
    qfrc = d.qfrc_smooth + d.qfrc_constraint
    if m.qm_meta is not None:
      from . import sparse as sparse_mod
      qacc, _ = sparse_mod.factor_solve(
          m.qm_meta, d.qM, qfrc, diag=m.opt.timestep * m.dof_damping)
    else:
      mh = d.qM + jnp.diag(m.opt.timestep * m.dof_damping)
      qacc = linalg.spd_solve(mh, qfrc)
  return _advance(m, d, d.act_dot, qacc)


@named('rungekutta4')
def rungekutta4(m: Model, d: Data) -> Data:
  """RK4 (reference forward.py:458; C mj_RungeKutta). 3 extra forward()
  evaluations, as in the reference."""
  h = m.opt.timestep
  a = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
  b = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)
  qpos0, qvel0, act0, time0 = d.qpos, d.qvel, d.act, d.time

  fs = [(d.qvel, d.qacc, d.act_dot)]
  d_i = d
  for i in range(3):
    dqvel = sum(a[i][j] * fs[j][1] for j in range(i + 1) if a[i][j])
    dqpos_vel = sum(a[i][j] * fs[j][0] for j in range(i + 1) if a[i][j])
    dact = sum(a[i][j] * fs[j][2] for j in range(i + 1) if a[i][j])
    qpos_i = _integrate_pos(m, qpos0, dqpos_vel, h)
    d_i = d_i.replace(qpos=qpos_i, qvel=qvel0 + h * dqvel,
                      act=act0 + h * dact if m.na else act0,
                      time=time0)
    d_i = forward(m, d_i)
    fs.append((d_i.qvel, d_i.qacc, d_i.act_dot))

  vel_b = sum(b[i] * fs[i][0] for i in range(4))
  acc_b = sum(b[i] * fs[i][1] for i in range(4))
  actd_b = sum(b[i] * fs[i][2] for i in range(4))
  qpos = _integrate_pos(m, qpos0, vel_b, h)
  act = act0 + h * actd_b if m.na else act0
  qvel = qvel0 + h * acc_b
  # restore pre-stage dynamics outputs from stage-0 call, advance state
  d = d_i.replace(qpos=qpos, qvel=qvel, act=act, time=time0 + h,
                  qacc=acc_b, qacc_warmstart=d.qacc)
  return d


@named('implicitfast')
def implicit(m: Model, d: Data) -> Data:
  """implicitfast integrator (reference forward.py:495): analytic
  d(force)/d(vel) via derivative.py."""
  from . import derivative
  qderiv = derivative.deriv_smooth_vel(m, d)
  mh = d.qM - m.opt.timestep * qderiv
  # symmetrize: MuJoCo uses (A + A^T)/2 on qDeriv contributions? It
  # factorizes the asymmetric matrix with LU; we use the symmetric part,
  # which matches mjx's implicitfast formulation.
  mh = 0.5 * (mh + mh.T)
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  return _advance(m, d, d.act_dot, linalg.spd_solve(mh, qfrc))


@named('step')
def step(m: Model, d: Data, control_fn=None, passive_fn=None,
         sensor_fn=None) -> Data:
  """Forward dynamics + integration (reference forward.py:1004)."""
  d = forward(m, d, control_fn=control_fn, passive_fn=passive_fn,
              sensor_fn=sensor_fn)
  if m.opt.integrator == IntegratorType.EULER:
    return euler(m, d)
  elif m.opt.integrator == IntegratorType.RK4:
    return rungekutta4(m, d)
  elif m.opt.integrator == IntegratorType.IMPLICITFAST:
    return implicit(m, d)
  raise NotImplementedError(f'integrator {m.opt.integrator}')


# ---------------------------------------------------------------------------
# Batch-native perf path: vmapped stages + batched linear algebra
# (the analogue of the reference's single captured CUDA graph over the
# whole nworld batch, benchmark.py:128-137)
# ---------------------------------------------------------------------------


def batched_stages(m: Model, d: Data) -> list:
  """[(name, fn)] for the exact stage sequence forward_batched executes
  for this (m, d). testspeed --event_trace times the same list, so the
  trace describes the real hot path."""
  vm = lambda fn, **kw: jax.vmap(lambda dd: fn(m, dd, **kw))
  stages = []
  add = lambda name, fn: stages.append((name, fn))
  add('fwd_position', vm(fwd_position, factorize=False))
  add('sensor_pos', vm(sensor_mod.sensor_pos))
  if m.opt.enableflags & 2:  # EnableBit.ENERGY
    add('energy_pos', vm(sensor_mod.energy_pos))
  add('fwd_velocity', vm(fwd_velocity))
  add('sensor_vel', vm(sensor_mod.sensor_vel))
  if m.opt.enableflags & 2:
    add('energy_vel', vm(sensor_mod.energy_vel))
  add('fwd_actuation', vm(fwd_actuation))
  add('fwd_acceleration', lambda dd: _fwd_acceleration_batched(m, dd))
  add('solve', lambda dd: solver_mod.solve(m, dd))
  add('sensor_acc', vm(sensor_mod.sensor_acc))
  return stages


_PATH_LOGGED: set = set()


def _fold_stages(stages: list, d: Data) -> Data:
  names = tuple(n for n, _ in stages)
  if names not in _PATH_LOGGED:
    # one line per distinct stage sequence, so users can see the path
    # their model takes
    _PATH_LOGGED.add(names)
    import logging
    logging.getLogger(__name__).info(
        'step_batched path: %s', ' -> '.join(names))
  for _, fn in stages:
    d = fn(d)
  return d


@named('forward')
def forward_batched(m: Model, d: Data) -> Data:
  """forward() over a leading world axis: vmapped stages, batched linear
  solves and a batch-native constraint solve."""
  return _fold_stages(batched_stages(m, d), d)


@named('euler')
def _euler_batched(m: Model, d: Data) -> Data:
  qacc = d.qacc
  if m.has_damping and not (m.opt.disableflags & DisableBit.EULERDAMP):
    qfrc = d.qfrc_smooth + d.qfrc_constraint
    qacc, _ = solver_mod.m_solve_factor(
        m, d.qM, qfrc, diag=m.opt.timestep * m.dof_damping)
  return jax.vmap(lambda dd, qa: _advance(m, dd, dd.act_dot, qa))(d, qacc)


@named('implicitfast')
def _implicit_batched(m: Model, d: Data) -> Data:
  from . import derivative
  qderiv = jax.vmap(lambda dd: derivative.deriv_smooth_vel(m, dd))(d)
  mh = d.qM - m.opt.timestep * qderiv
  mh = 0.5 * (mh + jnp.swapaxes(mh, -1, -2))
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  qacc = solver_mod.spd_solve(mh, qfrc)
  return jax.vmap(lambda dd, qa: _advance(m, dd, dd.act_dot, qa))(d, qacc)


@named('rk4')
def _rk4_batched(m: Model, d: Data) -> Data:
  h = m.opt.timestep
  a = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
  b = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)
  qpos0, qvel0, act0, time0 = d.qpos, d.qvel, d.act, d.time
  integrate = jax.vmap(lambda q, v: _integrate_pos(m, q, v, h))

  fs = [(d.qvel, d.qacc, d.act_dot)]
  d_i = d
  for i in range(3):
    dqvel = sum(a[i][j] * fs[j][1] for j in range(i + 1) if a[i][j])
    dqpos_vel = sum(a[i][j] * fs[j][0] for j in range(i + 1) if a[i][j])
    dact = sum(a[i][j] * fs[j][2] for j in range(i + 1) if a[i][j])
    d_i = d_i.replace(qpos=integrate(qpos0, dqpos_vel),
                      qvel=qvel0 + h * dqvel,
                      act=act0 + h * dact if m.na else act0, time=time0)
    d_i = forward_batched(m, d_i)
    fs.append((d_i.qvel, d_i.qacc, d_i.act_dot))

  vel_b = sum(b[i] * fs[i][0] for i in range(4))
  acc_b = sum(b[i] * fs[i][1] for i in range(4))
  actd_b = sum(b[i] * fs[i][2] for i in range(4))
  return d_i.replace(qpos=integrate(qpos0, vel_b), qvel=qvel0 + h * acc_b,
                     act=act0 + h * actd_b if m.na else act0,
                     time=time0 + h, qacc=acc_b, qacc_warmstart=d.qacc)


@named('step')
def step_batched(m: Model, d: Data) -> Data:
  """Batched step: the perf path. d carries a leading world axis.

  MJWT_STEP_CHUNK=<w>: run the step over <w>-world microbatches via
  ``lax.map`` — bounds peak HBM at ~W/w of the full-batch step for
  giant-nv scenes (aloha_cloth: nv=2716 makes dense efc_J alone 2.2 GB
  at 32 worlds; the solver's J-sized temporaries then exceed the chip).
  Applied only when it divides the batch evenly; off by default."""
  import os as _os
  w = int(_os.environ.get('MJWT_STEP_CHUNK', '0'))
  W = d.qpos.shape[0] if d.qpos.ndim == 2 else 0
  if 0 < w < W and W % w == 0:
    dc = jax.tree.map(
        lambda x: x.reshape((W // w, w) + x.shape[1:])
        if hasattr(x, 'ndim') and x.ndim >= 1 and x.shape[0] == W
        else x, d)
    out = jax.lax.map(lambda dd: _step_batched(m, dd), dc)
    return jax.tree.map(
        lambda x: x.reshape((W,) + x.shape[2:])
        if hasattr(x, 'ndim') and x.ndim >= 2 and
        x.shape[:2] == (W // w, w) else x, out)
  return _step_batched(m, d)


def _step_batched(m: Model, d: Data) -> Data:
  d = forward_batched(m, d)
  if m.opt.integrator == IntegratorType.EULER:
    return _euler_batched(m, d)
  elif m.opt.integrator == IntegratorType.RK4:
    return _rk4_batched(m, d)
  elif m.opt.integrator == IntegratorType.IMPLICITFAST:
    return _implicit_batched(m, d)
  raise NotImplementedError(f'integrator {m.opt.integrator}')


@named('step1')
def step1(m: Model, d: Data) -> Data:
  """Position/velocity stages only, for user ctrl injection between
  step1/step2 (reference forward.py:1022)."""
  d = fwd_position(m, d)
  d = sensor_mod.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  d = sensor_mod.sensor_vel(m, d)
  return d


@named('step2')
def step2(m: Model, d: Data) -> Data:
  """Actuation onward + integrate (reference forward.py:1050)."""
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = solver_mod.solve(m, d)
  d = sensor_mod.sensor_acc(m, d)
  if m.opt.integrator == IntegratorType.EULER:
    return euler(m, d)
  elif m.opt.integrator == IntegratorType.RK4:
    raise NotImplementedError('step1/step2 split with RK4')
  return implicit(m, d)
