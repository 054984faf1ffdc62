"""Smooth (unconstrained) dynamics: kinematics, COM frames, CRB mass
matrix, factorization, RNE bias forces, actuator transmission.

Vectorized restructuring of the reference's kernels
(mujoco_warp/_src/smooth.py):

* Forward kinematics unrolls a static Python loop over bodies at trace
  time (bodies are topologically sorted); after ``vmap`` each step is a
  fused (nworld,)-wide VPU op. The reference instead launches a
  branch-parallel CUDA kernel per root->leaf chain (smooth.py:44-358).

* All tree *accumulations* (subtree COM, composite inertia, force
  backward pass, velocity forward pass) are masked matmuls against
  precomputed 0/1 ancestry/subtree masks — sums along tree paths commute,
  so a level-order scan (reference smooth.py:463-509,807-826) is just a
  matrix product.

* The mass matrix is assembled densely in one masked einsum:
  qM[i,j] = cdof[j] . (crb[body(i)] * cdof[i]) masked by dof ancestry
  (reference scatters per-dof-pair, smooth.py:826-886). Dense-only for
  now, matching the reference's own nv<=60 dense regime (io.py:142-144).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import linalg
from . import math
from . import wrap as wrap_mod
from .types import Data, DisableBit, GeomType, JointType, Model, TrnType

# einsum precision: physics needs full f32 products; a GPU may run
# unqualified f32 matmuls in TF32, which loses contact-scale precision.
_EINSUM = dict(precision=jax.lax.Precision.HIGHEST)


def _normalize_qpos(m: Model, qpos: jax.Array) -> jax.Array:
  """Normalize ball/free quaternions in qpos (mj_kinematics does this),
  vectorized over all quaternion joints at once."""
  import numpy as np
  qadrs = [m.jnt_qposadr[j] + (3 if m.jnt_type[j] == JointType.FREE else 0)
           for j in range(m.njnt)
           if m.jnt_type[j] in (JointType.FREE, JointType.BALL)]
  if not qadrs:
    return qpos
  idx = np.asarray(qadrs)[:, None] + np.arange(4)[None, :]
  quats = jax.vmap(math.quat_normalize)(qpos[idx])
  return qpos.at[idx.reshape(-1)].set(quats.reshape(-1))


def kinematics(m: Model, d: Data) -> Data:
  """Forward kinematics, level-synchronous: all bodies at one tree depth
  advance together with per-joint-type masks. The per-level batching
  replaces the reference's branch-parallel per-chain kernel
  (smooth.py:44-358) and keeps the traced op count ~O(depth), not
  O(nbody) — important for XLA compile time and kernel count."""
  import numpy as np
  qpos = _normalize_qpos(m, d.qpos)
  dtype = qpos.dtype

  xpos = jnp.zeros((m.nbody, 3), dtype)
  xquat = jnp.zeros((m.nbody, 4), dtype).at[:, 0].set(1.0)
  xanchor = jnp.zeros((max(m.njnt, 1), 3), dtype)
  xaxis = jnp.zeros((max(m.njnt, 1), 3), dtype)

  jnt_type = np.asarray(m.jnt_type)
  jnt_qposadr = np.asarray(m.jnt_qposadr)

  for level in m.body_levels:
    B = np.asarray(level)
    pids = np.asarray([m.body_parentid[b] for b in level])
    jadr = np.asarray([m.body_jntadr[b] for b in level])
    jnum = np.asarray([m.body_jntnum[b] for b in level])
    nb = len(B)

    pq = xquat[pids]
    xq = jax.vmap(math.mul_quat)(pq, m.body_quat[B])
    xp = xpos[pids] + jax.vmap(math.rot_vec_quat)(m.body_pos[B], pq)

    # mocap bodies (jointless): override from mocap state
    mocapids = np.asarray([m.body_mocapid[b] for b in level])
    if (mocapids >= 0).any():
      mids = np.where(mocapids >= 0, mocapids, 0)
      is_mocap = jnp.asarray((mocapids >= 0) & (jnum == 0))[:, None]
      xp = jnp.where(is_mocap, d.mocap_pos[mids], xp)
      xq = jnp.where(is_mocap, jax.vmap(math.quat_normalize)(
          d.mocap_quat[mids]), xq)

    # free joints: pose straight from qpos
    is_free = np.asarray([
        jnum[i] == 1 and jnt_type[jadr[i]] == JointType.FREE
        for i in range(nb)])
    if is_free.any():
      qadr = np.where(is_free, jnt_qposadr[jadr], 0)
      fidx = qadr[:, None] + np.arange(7)[None, :]
      q7 = qpos[fidx]
      mfree = jnp.asarray(is_free)[:, None]
      xp = jnp.where(mfree, q7[:, :3], xp)
      xq = jnp.where(mfree, q7[:, 3:], xq)
      # free-joint anchor/axis convention: xanchor = xpos, xaxis = local
      jidx = np.where(is_free, jadr, m.njnt)  # drop where not free
      xanchor = xanchor.at[jidx].set(q7[:, :3], mode='drop')
      xaxis = xaxis.at[jidx].set(m.jnt_axis[np.where(is_free, jadr, 0)],
                                 mode='drop')

    # non-free joints, one slot at a time (bodies with multiple joints
    # apply them sequentially, as in C MuJoCo)
    for k in range(int(jnum.max()) if nb else 0):
      has = (jnum > k) & ~is_free
      if not has.any():
        continue
      jids = np.where(has, jadr + k, 0)
      jt = jnt_type[jids]
      qadr = jnt_qposadr[jids]
      is_slide = jnp.asarray(has & (jt == JointType.SLIDE))
      is_ball = jnp.asarray(has & (jt == JointType.BALL))
      is_hinge = jnp.asarray(has & (jt == JointType.HINGE))
      mhas = jnp.asarray(has)

      jpos = m.jnt_pos[jids]
      jaxis_loc = m.jnt_axis[jids]
      anchor = xp + jax.vmap(math.rot_vec_quat)(jpos, xq)
      axis = jax.vmap(math.rot_vec_quat)(jaxis_loc, xq)

      # scalar joint coordinate (slide/hinge)
      qs = qpos[qadr] - m.qpos0[qadr]
      # ball quaternion
      bidx = qadr[:, None] + np.arange(4)[None, :]
      qball = qpos[bidx]
      qhinge = jax.vmap(math.axis_angle_to_quat)(jaxis_loc, qs)
      qloc = jnp.where(is_ball[:, None], qball,
                       jnp.where(is_hinge[:, None], qhinge,
                                 jnp.zeros_like(qball).at[:, 0].set(1.0)))
      xq_rot = jax.vmap(math.mul_quat)(xq, qloc)
      rot = is_ball | is_hinge
      xq = jnp.where(rot[:, None], xq_rot, xq)
      xp_rot = anchor - jax.vmap(math.rot_vec_quat)(jpos, xq)
      xp_slide = xp + axis * qs[:, None]
      xp = jnp.where(rot[:, None], xp_rot,
                     jnp.where(is_slide[:, None], xp_slide, xp))

      sidx = np.where(has, jids, m.njnt)
      xanchor = xanchor.at[sidx].set(
          jnp.where(mhas[:, None], anchor, 0.0), mode='drop')
      xaxis = xaxis.at[sidx].set(
          jnp.where(mhas[:, None], axis, 0.0), mode='drop')

    xq = jax.vmap(math.quat_normalize)(xq)
    xpos = xpos.at[B].set(xp)
    xquat = xquat.at[B].set(xq)

  xmat = jax.vmap(math.quat_to_mat)(xquat)
  xanchor = xanchor[:m.njnt]
  xaxis = xaxis[:m.njnt]

  # inertial, geom, site frames: pure gathers + batched quaternion math
  iquat = jax.vmap(math.mul_quat)(xquat, m.body_iquat)
  xipos = xpos + jax.vmap(math.rot_vec_quat)(m.body_ipos, xquat)
  ximat = jax.vmap(math.quat_to_mat)(iquat)

  def frames(bodyid, pos, quat, n):
    if n == 0:
      return jnp.zeros((0, 3), dtype), jnp.zeros((0, 3, 3), dtype)
    bodyid = list(bodyid)
    bq = xquat[bodyid, :]
    p = xpos[bodyid, :] + jax.vmap(math.rot_vec_quat)(pos, bq)
    q = jax.vmap(math.mul_quat)(bq, quat)
    return p, jax.vmap(math.quat_to_mat)(q)

  geom_xpos, geom_xmat = frames(m.geom_bodyid, m.geom_pos, m.geom_quat,
                                m.ngeom)
  site_xpos, site_xmat = frames(m.site_bodyid, m.site_pos, m.site_quat,
                                m.nsite)

  return d.replace(qpos=qpos, xpos=xpos, xquat=xquat, xmat=xmat,
                   xipos=xipos, ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   geom_xpos=geom_xpos, geom_xmat=geom_xmat,
                   site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree COM, COM-frame inertia, and dof motion axes
  (reference smooth.py:602; C mj_comPos)."""
  # subtree com: one matmul against the subtree mask
  mass = m.body_mass
  weighted = d.xipos * mass[:, None]
  subtree_sum = jnp.einsum('bc,ci->bi', m.body_subtree_mask, weighted,
                           **_EINSUM)
  subtreemass = jnp.maximum(m.body_subtreemass, 1e-12)
  subtree_com = subtree_sum / subtreemass[:, None]
  # world body: MuJoCo leaves subtree_com[0] as total-mass com
  # (mass[0] = 0 so formula above already handles it when nbody>1)

  # cinert: spatial inertia of each body about subtree_com of its root
  root_com = subtree_com[list(m.body_rootid), :]
  offset = d.xipos - root_com
  cinert = jax.vmap(math.inert_from_body)(mass, m.body_inertia, offset,
                                          d.ximat)
  cinert = cinert.at[0].set(0.0)

  # cdof: per-dof spatial motion axes about the root subtree com —
  # vectorized over all dofs with static per-dof classification tables
  # (the reference walks joints in a kernel, smooth.py:602)
  dtype = d.qpos.dtype
  if m.nv == 0:
    return d.replace(subtree_com=subtree_com, cinert=cinert)
  import numpy as np
  jnt_of = np.asarray(m.dof_jntid)
  body_of = np.asarray(m.dof_bodyid)
  jt = np.asarray(m.jnt_type)[jnt_of]
  dadr_of = np.asarray(m.jnt_dofadr)[jnt_of]
  k_in = np.arange(m.nv) - dadr_of                   # index within joint
  is_freelin = (jt == JointType.FREE) & (k_in < 3)
  is_rotmat = ((jt == JointType.FREE) & (k_in >= 3)) | (
      jt == JointType.BALL)
  col = np.where(jt == JointType.FREE, k_in - 3, k_in)  # xmat column
  is_slide = jt == JointType.SLIDE
  is_hinge = jt == JointType.HINGE

  off = d.xanchor[jnt_of] - subtree_com[
      np.asarray(m.body_rootid)[body_of]]             # (nv, 3)
  ax_mat = d.xmat[body_of, :, np.clip(col, 0, 2)]     # (nv, 3)
  ax_jnt = d.xaxis[jnt_of]
  e_lin = jnp.asarray(np.eye(3)[np.clip(k_in, 0, 2)] *
                      is_freelin[:, None], dtype)

  ang = jnp.where(jnp.asarray(is_rotmat)[:, None], ax_mat,
                  jnp.where(jnp.asarray(is_hinge)[:, None], ax_jnt, 0.0))
  lin_rot = jnp.cross(ang, -off)
  lin = jnp.where(jnp.asarray(is_rotmat | is_hinge)[:, None], lin_rot,
                  jnp.where(jnp.asarray(is_slide)[:, None], ax_jnt,
                            e_lin))
  cdof = jnp.concatenate([ang, lin], axis=1)

  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def _lookat(pos, target):
  """Camera matrix with -z toward target, like mj_camlight's target
  modes."""
  z = math.normalize(pos - target)            # camera looks along -z
  up = jnp.array([0.0, 0.0, 1.0], pos.dtype)
  x = jnp.cross(up, z)
  xn = math.norm(x)
  x = jnp.where(xn < 1e-8, jnp.array([1.0, 0.0, 0.0], pos.dtype),
                x / jnp.where(xn < 1e-8, 1.0, xn))
  y = jnp.cross(z, x)
  return jnp.stack([x, y, z], axis=1)


def camlight(m: Model, d: Data) -> Data:
  """Camera/light frames incl. tracking modes
  (reference smooth.py:762; C mj_camlight). mjtCamLight:
  0=FIXED, 1=TRACK, 2=TRACKCOM, 3=TARGETBODY, 4=TARGETBODYCOM."""
  if m.ncam == 0 and m.nlight == 0:
    return d
  if m.ncam:
    bodyid = list(m.cam_bodyid)
    bq = d.xquat[bodyid, :]
    pos = d.xpos[bodyid, :] + jax.vmap(math.rot_vec_quat)(m.cam_pos, bq)
    mat = jax.vmap(math.quat_to_mat)(jax.vmap(math.mul_quat)(bq,
                                                             m.cam_quat))
    poss, mats = [], []
    for c in range(m.ncam):
      mode = m.cam_mode[c]
      b = m.cam_bodyid[c]
      tb = m.cam_targetbodyid[c]
      p, R = pos[c], mat[c]
      if mode == 1:    # TRACK: world-fixed orientation, offset from body
        p = d.xpos[b] + m.cam_pos0[c]
        R = m.cam_mat0[c]
      elif mode == 2:  # TRACKCOM
        p = d.subtree_com[b] + m.cam_poscom0[c]
        R = m.cam_mat0[c]
      if mode in (3, 4) and tb >= 0:
        target = d.subtree_com[tb] if mode == 4 else d.xpos[tb]
        R = _lookat(p, target)
      poss.append(p)
      mats.append(R)
    d = d.replace(cam_xpos=jnp.stack(poss), cam_xmat=jnp.stack(mats))
  if m.nlight:
    bodyid = list(m.light_bodyid)
    bq = d.xquat[bodyid, :]
    light_xpos = d.xpos[bodyid, :] + jax.vmap(math.rot_vec_quat)(
        m.light_pos, bq)
    light_xdir = jax.vmap(math.rot_vec_quat)(m.light_dir, bq)
    poss, dirs = [], []
    for c in range(m.nlight):
      mode = m.light_mode[c]
      b = m.light_bodyid[c]
      tb = m.light_targetbodyid[c]
      p, dr = light_xpos[c], light_xdir[c]
      if mode == 1:
        p = d.xpos[b] + m.light_pos0[c]
        dr = m.light_dir0[c]
      elif mode == 2:
        p = d.subtree_com[b] + m.light_poscom0[c]
        dr = m.light_dir0[c]
      if mode in (3, 4) and tb >= 0:
        target = d.subtree_com[tb] if mode == 4 else d.xpos[tb]
        dr = target - p
      poss.append(p)
      dirs.append(math.normalize(dr))
    d = d.replace(light_xpos=jnp.stack(poss), light_xdir=jnp.stack(dirs))
  return d


def crb(m: Model, d: Data) -> Data:
  """Composite rigid body inertia + dense mass matrix
  (reference smooth.py:889; C mj_crb). qM assembly is one masked einsum."""
  crb_ = jnp.einsum('bc,ci->bi', m.body_subtree_mask, d.cinert, **_EINSUM)
  crb_ = crb_.at[0].set(0.0)  # MuJoCo never accumulates into the world body

  if m.nv == 0:
    return d.replace(crb=crb_)

  crb_dof = crb_[list(m.dof_bodyid), :]             # (nv, 10)
  buf = jax.vmap(math.inert_mul)(crb_dof, d.cdof)   # (nv, 6)
  if m.qm_meta is not None:
    # packed tree-sparse values: O(nnz), never materializes (nv, nv)
    from . import sparse as sparse_mod
    vals = sparse_mod.qm_from_crb(m.qm_meta, d.cdof, buf, m.dof_armature)
    return d.replace(crb=crb_, qM=vals)
  qm_full = jnp.einsum('ik,jk->ij', buf, d.cdof, **_EINSUM)
  # mask[i, j] = dof j ancestor-or-self of i → strictly lower + diag
  qm = qm_full * m.dof_ancestor_mask
  qm = qm + jnp.tril(qm, -1).T                      # symmetrize
  qm = qm + jnp.diag(m.dof_armature)
  return d.replace(crb=crb_, qM=qm)


def tendon_armature(m: Model, d: Data) -> Data:
  """qM += armature_t * ten_J^T ten_J restricted to the qM sparsity
  pattern — only (i, j) pairs on a common ancestor chain, matching the
  reference's sparse-structure walk (smooth.py:916-1003;
  C mj_tendonArmature)."""
  if m.ntendon == 0 or not m.has_tendon_armature:
    return d
  jj = jnp.einsum('t,tn,tk->nk', m.tendon_armature, d.ten_J, d.ten_J,
                  **_EINSUM)
  sym = jnp.clip(m.dof_ancestor_mask + m.dof_ancestor_mask.T, 0.0, 1.0)
  return d.replace(qM=d.qM + jj * sym)


def _qpos_dot(m: Model, qpos: jax.Array, qvel: jax.Array) -> jax.Array:
  """Tangent dqpos/dt from qvel (quaternion-aware: qdot = q/2 * (0, w)
  with w the joint-local angular velocity, as in mj_integratePos)."""
  import numpy as np
  qd = jnp.zeros_like(qpos)
  for j in range(m.njnt):
    jtype = m.jnt_type[j]
    qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
    if jtype == JointType.FREE:
      qd = qd.at[qadr:qadr + 3].set(qvel[dadr:dadr + 3])
      q = qpos[qadr + 3:qadr + 7]
      w = qvel[dadr + 3:dadr + 6]
      qd = qd.at[qadr + 3:qadr + 7].set(
          0.5 * math.mul_quat(q, jnp.concatenate([jnp.zeros(1, q.dtype),
                                                  w])))
    elif jtype == JointType.BALL:
      q = qpos[qadr:qadr + 4]
      w = qvel[dadr:dadr + 3]
      qd = qd.at[qadr:qadr + 4].set(
          0.5 * math.mul_quat(q, jnp.concatenate([jnp.zeros(1, q.dtype),
                                                  w])))
    else:
      qd = qd.at[qadr].set(qvel[dadr])
  return qd


def tendon_bias(m: Model, d: Data) -> Data:
  """qfrc_bias += armature_t * ten_J^T (dten_J/dt . qvel) — the bias
  force of the tendon-armature inertia (reference smooth.py:1609-1878;
  C mj_tendonDot + tendon bias). Computed exactly via a jvp of the
  tendon Jacobian along the quaternion-aware qpos tangent (covers wrap
  geometry too, which the reference leaves TODO)."""
  if m.ntendon == 0 or not m.has_tendon_armature:
    return d

  def jqvel(qpos):
    dd = d.replace(qpos=qpos)
    dd = kinematics(m, dd)
    dd = com_pos(m, dd)
    dd = tendon(m, dd)
    return jnp.einsum('tn,n->t', dd.ten_J, d.qvel, **_EINSUM)

  qd = _qpos_dot(m, d.qpos, d.qvel)
  _, coef = jax.jvp(jqvel, (d.qpos,), (qd,))     # (ntendon,) Jdot.qvel
  qfrc = jnp.einsum('t,tn,t->n', m.tendon_armature, d.ten_J, coef,
                    **_EINSUM)
  return d.replace(qfrc_bias=d.qfrc_bias + qfrc)


def factor_m(m: Model, d: Data) -> Data:
  """Factor qM: dense Cholesky, or level-scheduled sparse LDL in
  sparse-qM mode (reference tiled wp.tile_cholesky / sparse
  smooth.py:1017-1104)."""
  if m.qm_meta is not None:
    from . import sparse as sparse_mod
    return d.replace(qLD=sparse_mod.factor(m.qm_meta, d.qM))
  return d.replace(qLD=linalg.cholesky(d.qM))


def solve_m(m: Model, d: Data, x: jax.Array) -> jax.Array:
  """qM^-1 x via the cached factor (reference smooth.py:2848)."""
  if m.qm_meta is not None:
    from . import sparse as sparse_mod
    return sparse_mod.solve(m.qm_meta, d.qLD, x)
  return linalg.cho_solve(d.qLD, x)


def com_vel(m: Model, d: Data) -> Data:
  """Spatial velocities + cdof time derivatives
  (reference smooth.py:2015; C mj_comVel). The per-body tree scan is
  two masked matmuls: cvel from the body/dof ancestry mask, and
  cdof_dot[j] = v_pre(j) x cdof[j] with v_pre from the strict-ancestor
  mask (io._dof_vpre_mask) — exact C accumulation-order semantics."""
  dtype = d.qpos.dtype
  if m.nv == 0:
    return d.replace(cvel=jnp.zeros((m.nbody, 6), dtype))
  dof_vel = d.cdof * d.qvel[:, None]                    # (nv, 6)
  cvel = jnp.einsum('bj,ji->bi', m.body_dof_ancestor_mask, dof_vel,
                    **_EINSUM)
  v_pre = jnp.einsum('jk,ki->ji', m.dof_vpre_mask, dof_vel, **_EINSUM)
  cdof_dot = jax.vmap(math.motion_cross)(v_pre, d.cdof)
  # linear dofs of free joints keep cdof_dot = 0 (C leaves them zero)
  import numpy as np
  is_freelin = np.zeros(m.nv, dtype=bool)
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.FREE:
      dadr = m.jnt_dofadr[j]
      is_freelin[dadr:dadr + 3] = True
  cdof_dot = jnp.where(jnp.asarray(is_freelin)[:, None], 0.0, cdof_dot)
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def rne(m: Model, d: Data) -> Data:
  """Recursive Newton-Euler bias forces with qacc = 0
  (reference smooth.py:1259; C mj_rne). Forward/backward passes are
  masked matmuls."""
  dtype = d.qpos.dtype
  if m.nv == 0:
    return d.replace(qfrc_bias=jnp.zeros(0, dtype))

  # cacc[b] = -gravity_at_root + sum over ancestor dofs of cdof_dot*qvel
  dof_contrib = d.cdof_dot * d.qvel[:, None]            # (nv, 6)
  cacc = jnp.einsum('bj,ji->bi', m.body_dof_ancestor_mask, dof_contrib,
                    **_EINSUM)
  if not m.opt.disableflags & DisableBit.GRAVITY:
    grav = jnp.concatenate([jnp.zeros(3, dtype), -m.opt.gravity])
    cacc = cacc + grav[None, :]
    cacc = cacc.at[0].set(grav)  # world body included for completeness

  # per-body net force: cinert*cacc + cvel x* (cinert*cvel)
  icacc = jax.vmap(math.inert_mul)(d.cinert, cacc)
  icvel = jax.vmap(math.inert_mul)(d.cinert, d.cvel)
  cfrc = icacc + jax.vmap(math.motion_cross_force)(d.cvel, icvel)

  # backward: subtree force sums, then project on dof axes
  cfrc_sub = jnp.einsum('bc,ci->bi', m.body_subtree_mask, cfrc, **_EINSUM)
  qfrc_bias = jnp.einsum(
      'ji,ji->j', d.cdof, cfrc_sub[list(m.dof_bodyid), :], **_EINSUM)
  return d.replace(qfrc_bias=qfrc_bias, cacc=cacc)


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and moment arms (reference smooth.py:2042-2605)."""
  if m.nu == 0:
    return d
  dtype = d.qpos.dtype
  import numpy as np

  # fast path: every actuator is JOINT transmission on a slide/hinge —
  # lengths are a gather, the moment matrix is a static one-hot times
  # gear (one fused op instead of a per-actuator trace loop)
  simple = all(
      m.actuator_trntype[u] == TrnType.JOINT and
      m.jnt_type[m.actuator_trnid[u][0]] in (JointType.SLIDE,
                                             JointType.HINGE)
      for u in range(m.nu))
  if simple:
    jids = np.asarray([m.actuator_trnid[u][0] for u in range(m.nu)])
    qadr = np.asarray(m.jnt_qposadr)[jids]
    dadr = np.asarray(m.jnt_dofadr)[jids]
    onehot = np.zeros((m.nu, m.nv), dtype=np.float32)
    onehot[np.arange(m.nu), dadr] = 1.0
    gear0 = m.actuator_gear[:, 0]
    lengths = d.qpos[qadr] * gear0
    moment = jnp.asarray(onehot, dtype) * gear0[:, None]
    return d.replace(actuator_length=lengths, actuator_moment=moment)

  lengths = []
  moment = jnp.zeros((m.nu, m.nv), dtype)
  for u in range(m.nu):
    trntype = m.actuator_trntype[u]
    if trntype in (TrnType.JOINT, TrnType.JOINTINPARENT):
      j = m.actuator_trnid[u][0]
      jtype = m.jnt_type[j]
      qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
      gear = m.actuator_gear[u]
      if jtype in (JointType.SLIDE, JointType.HINGE):
        lengths.append(d.qpos[qadr] * gear[0])
        moment = moment.at[u, dadr].set(gear[0])
      elif jtype == JointType.BALL:
        q = d.qpos[qadr:qadr + 4]
        axis = math.quat_to_vel(q)
        if trntype == TrnType.JOINTINPARENT:
          axis = math.rot_vec_quat(axis, math.quat_inv(q))
        lengths.append(jnp.dot(axis, gear[:3]))
        g = gear[:3]
        if trntype == TrnType.JOINTINPARENT:
          g = math.rot_vec_quat(g, math.quat_inv(q))
        moment = moment.at[u, dadr:dadr + 3].set(g)
      elif jtype == JointType.FREE:
        lengths.append(jnp.zeros((), dtype))
        g = gear
        if trntype == TrnType.JOINTINPARENT:
          q = d.qpos[qadr + 3:qadr + 7]
          gl = math.rot_vec_quat(gear[:3], q)
          ga = math.rot_vec_quat(gear[3:], q)
          g = jnp.concatenate([gl, ga])
        moment = moment.at[u, dadr:dadr + 6].set(g)
      else:
        raise NotImplementedError(f'joint transmission on {jtype}')
    elif trntype == TrnType.TENDON:
      t = m.actuator_trnid[u][0]
      gear = m.actuator_gear[u][0]
      lengths.append(d.ten_length[t] * gear)
      moment = moment.at[u].set(gear * d.ten_J[t])
    elif trntype == TrnType.SITE:
      from . import support  # local import to avoid cycle
      sid = m.actuator_trnid[u][0]
      refid = m.actuator_trnid[u][1]
      gear = m.actuator_gear[u]
      b = m.site_bodyid[sid]
      if refid == -1:
        # force/torque applied at the site along gear axes: length = 0
        lengths.append(jnp.zeros((), dtype))
        jacp, jacr = support.jac(m, d, d.site_xpos[sid], b)
        frc = d.site_xmat[sid] @ gear[:3]
        trq = d.site_xmat[sid] @ gear[3:]
        moment = moment.at[u].set(jacp.T @ frc + jacr.T @ trq)
      else:
        # site-to-site transmission: length = projected pose difference
        bref = m.site_bodyid[refid]
        refpos = d.site_xpos[refid]
        refmat = d.site_xmat[refid]
        vecp = refmat.T @ (d.site_xpos[sid] - refpos)
        quat = math.mul_quat(math.mat_to_quat(refmat).at[1:].multiply(-1.0),
                             math.mat_to_quat(d.site_xmat[sid]))
        vecr = math.quat_to_vel(quat)
        lengths.append(jnp.dot(vecp, gear[:3]) + jnp.dot(vecr, gear[3:]))
        jacp, jacr = support.jac(m, d, d.site_xpos[sid], b)
        jacp_r, jacr_r = support.jac(m, d, refpos, bref)
        # translational moment in ref frame
        mom_p = (refmat @ gear[:3]) @ (jacp - jacp_r)
        mom_r = (refmat @ gear[3:]) @ (jacr - jacr_r)
        moment = moment.at[u].set(mom_p + mom_r)
    elif trntype == TrnType.SLIDERCRANK:
      from . import support  # local import to avoid cycle
      cranksite = m.actuator_trnid[u][0]
      slidersite = m.actuator_trnid[u][1]
      r = m.actuator_cranklength[u]
      gear = m.actuator_gear[u][0]
      x0 = d.site_xpos[slidersite]
      a = d.site_xmat[slidersite][:, 2]        # slider axis
      pc = d.site_xpos[cranksite]

      def slider_len(x0_, a_, pc_):
        v = pc_ - x0_
        av = jnp.dot(a_, v)
        det = av * av + r * r - jnp.dot(v, v)
        ok = det > 0
        return jnp.where(ok, av - jnp.sqrt(jnp.maximum(det, 1e-12)), av)

      Lval, grads = jax.value_and_grad(slider_len, argnums=(0, 1, 2))(
          x0, a, pc)
      gx0, ga, gpc = grads
      bs = m.site_bodyid[slidersite]
      bc = m.site_bodyid[cranksite]
      jps, jrs = support.jac(m, d, x0, bs)     # (3, nv) each
      jpc, _ = support.jac(m, d, pc, bc)
      # dL/dq = gx0.Jp_s + gpc.Jp_c + ga.(omega_s x a) with
      # (omega x a).ga = (a x ga).omega
      row = gx0 @ jps + gpc @ jpc + (jnp.cross(a, ga)) @ jrs
      lengths.append(Lval * gear)
      moment = moment.at[u].set(gear * row)
    elif trntype == TrnType.BODY:
      # adhesion actuator (reference smooth.py:2260,2448-2601
      # _transmission_body_moment): length = 0; moment = the AVERAGE
      # contact-normal jacobian over contacts touching the body,
      # negated (positive ctrl pulls the contact pair together). The
      # reference reconstructs the normal row by summing pyramid efc
      # rows (weights 0.5/npyramid — tangent terms cancel, leaving
      # exactly the normal row) and falls back to a direct jacobian
      # for in-gap contacts; the direct normal jacobian used here is
      # algebraically identical for both cases.
      from . import support  # local import to avoid cycle
      lengths.append(jnp.zeros((), dtype))
      b = int(m.actuator_trnid[u][0])
      con = d.contact
      if con.dist.shape[0]:
        gb = jnp.asarray(m.geom_bodyid)
        g1, g2 = con.geom[:, 0], con.geom[:, 1]
        valid = (g1 >= 0) & (g2 >= 0)    # flex contacts excluded (ref)
        b1 = jnp.where(valid, gb[jnp.maximum(g1, 0)], -1)
        b2 = jnp.where(valid, gb[jnp.maximum(g2, 0)], -1)
        relevant = valid & ((b1 == b) | (b2 == b))

        def _normal_row(pos, bb1, bb2, normal):
          jacp1, _ = support.jac_dyn(m, d, pos, bb1)
          jacp2, _ = support.jac_dyn(m, d, pos, bb2)
          return normal @ (jacp2 - jacp1)

        jn = jax.vmap(_normal_row)(con.pos, jnp.maximum(b1, 0),
                                   jnp.maximum(b2, 0), con.frame[:, 0])
        ncon_u = jnp.sum(relevant.astype(dtype))
        mom = -jnp.sum(jn * relevant[:, None].astype(dtype),
                       axis=0) / jnp.maximum(ncon_u, 1.0)
        moment = moment.at[u].set(mom)
    else:
      raise NotImplementedError(f'transmission type {trntype}')
  return d.replace(actuator_length=jnp.stack(lengths),
                   actuator_moment=moment)


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and Jacobians (reference smooth.py:3173-3627;
  C mj_tendon). Structure is static per tendon, so the wrap program
  unrolls at trace time; the wrap geometry itself (wrap.py) is
  branch-free masked math."""
  if m.ntendon == 0:
    return d
  from . import support  # local import to avoid cycle
  dtype = d.qpos.dtype
  lengths = []
  jrows = []
  for t in range(m.ntendon):
    kind, info = m.tendon_structure[t]
    if kind == 'fixed':
      length = jnp.zeros((), dtype)
      row = jnp.zeros(m.nv, dtype)
      for qadr, dofadr, wadr in info:
        coef = m.wrap_prm[wadr]
        length = length + coef * d.qpos[qadr]
        row = row.at[dofadr].add(coef)
      lengths.append(length)
      jrows.append(row)
      continue
    # spatial tendon: walk the wrap program
    length = jnp.zeros((), dtype)
    row = jnp.zeros(m.nv, dtype)
    divisor = jnp.ones((), dtype)
    prev = None  # (pos, bodyid) of previous path point

    def seg(row, length, p0, b0, p1, b1, divisor):
      dif = p1 - p0
      norm = math.norm(dif)
      unit = dif / jnp.where(norm < 1e-12, 1.0, norm)
      length = length + norm / divisor
      jacp0, _ = support.jac(m, d, p0, b0)
      jacp1, _ = support.jac(m, d, p1, b1)
      row = row + (unit @ (jacp1 - jacp0)) / divisor
      return row, length

    i = 0
    ops = info
    while i < len(ops):
      op = ops[i]
      if op[0] == 'pulley':
        divisor = jnp.maximum(m.wrap_prm[op[1]], 1e-12)
        prev = None
        i += 1
        continue
      assert op[0] == 'site', f'unexpected wrap op {op}'
      sid = op[1]
      cur = (d.site_xpos[sid], m.site_bodyid[sid])
      if i + 1 < len(ops) and ops[i + 1][0] == 'geom':
        # a geom wraps the cur->next span; the prev->cur span (if any)
        # is still a straight segment — emit it first (C mj_tendon
        # emits every inter-site segment; dropping it was a bug)
        if prev is not None:
          row, length = seg(row, length, prev[0], prev[1], cur[0], cur[1],
                            divisor)
        gid, gtype, side_sid = ops[i + 1][1:]
        nxt_op = ops[i + 2]
        assert nxt_op[0] == 'site', 'geom wrap must sit between sites'
        nsid = nxt_op[1]
        nxt = (d.site_xpos[nsid], m.site_bodyid[nsid])
        gb = m.geom_bodyid[gid]
        side = d.site_xpos[side_sid] if side_sid >= 0 else None
        wrap_fn = (wrap_mod.wrap_sphere if gtype == GeomType.SPHERE
                   else wrap_mod.wrap_cylinder)
        wlen, w0, w1 = wrap_fn(cur[0], nxt[0], d.geom_xpos[gid],
                               d.geom_xmat[gid], m.geom_size[gid, 0], side)
        wrapped = wlen >= 0
        # straight path (no wrap): one segment; wrapped: two segments
        # + arc. Compute both, select by mask.
        row_s, len_s = seg(row, length, cur[0], cur[1], nxt[0], nxt[1],
                           divisor)
        row_w, len_w = seg(row, length, cur[0], cur[1], w0, gb, divisor)
        row_w, len_w = seg(row_w, len_w, w1, gb, nxt[0], nxt[1], divisor)
        len_w = len_w + jnp.maximum(wlen, 0.0) / divisor
        row = jnp.where(wrapped, row_w, row_s)
        length = jnp.where(wrapped, len_w, len_s)
        prev = nxt
        i += 3
        continue
      if prev is not None:
        row, length = seg(row, length, prev[0], prev[1], cur[0], cur[1],
                          divisor)
      prev = cur
      i += 1
    lengths.append(length)
    jrows.append(row)
  return d.replace(ten_length=jnp.stack(lengths), ten_J=jnp.stack(jrows))


def subtree_vel(m: Model, d: Data) -> Data:
  """Subtree linear velocity and angular momentum (reference
  smooth.py:3044; C mj_subtreeVel). Needed by subtree sensors."""
  # linear velocity of each body com in world frame
  offset = d.xipos - d.subtree_com[list(m.body_rootid), :]
  lin = d.cvel[:, 3:] - jnp.cross(offset, d.cvel[:, :3])
  ang = d.cvel[:, :3]
  mass = m.body_mass[:, None]
  mom = jnp.einsum('bc,ci->bi', m.body_subtree_mask, lin * mass, **_EINSUM)
  subtreemass = jnp.maximum(m.body_subtreemass, 1e-12)[:, None]
  subtree_linvel = mom / subtreemass
  # subtree com position
  subtree_compos = jnp.einsum('bc,ci->bi', m.body_subtree_mask,
                              d.xipos * mass, **_EINSUM) / subtreemass
  # angular momentum about subtree com
  dcom = d.xipos - subtree_compos[list(m.body_rootid), :]  # placeholder
  # per-body inertia in world frame: ximat diag(inertia) ximatT
  ri = d.ximat * m.body_inertia[:, None, :]
  iworld = jnp.einsum('bij,bkj->bik', ri, d.ximat, **_EINSUM)
  amom_body = jnp.einsum('bij,bj->bi', iworld, ang, **_EINSUM)

  def accumulate(b):
    rel = d.xipos - subtree_compos[b][None, :]
    vrel = lin - subtree_linvel[b][None, :]
    contrib = amom_body + mass * jnp.cross(rel, vrel)
    return jnp.einsum('c,ci->i', m.body_subtree_mask[b], contrib, **_EINSUM)

  subtree_angmom = jax.vmap(accumulate)(jnp.arange(m.nbody))
  del dcom
  return d.replace(subtree_linvel=subtree_linvel,
                   subtree_angmom=subtree_angmom)
