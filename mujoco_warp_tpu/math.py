"""Quaternion and spatial (Plücker) algebra for the engine.

All functions operate on single-world (unbatched) arrays — batching over
worlds comes from `jax.vmap` at the `step` level, which is the JAX
equivalent of the reference's `nworld`-wide kernel launches
(reference: mujoco_warp/_src/math.py).

Conventions follow MuJoCo: quaternions are (w, x, y, z); spatial motion
vectors are (angular[3], linear[3]); spatial force vectors are
(torque[3], force[3]); 10-vectors for spatial inertia are
(Ixx, Iyy, Izz, Ixy, Ixz, Iyz, m*cx, m*cy, m*cz, m) about an origin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Minimum norm below which quaternion/axis normalization falls back to
# identity, mirroring MuJoCo's mju_normalize4 guard.
_EPS = 1e-14


def norm(x: jax.Array, axis: int = -1) -> jax.Array:
  return jnp.sqrt(jnp.sum(x * x, axis=axis))


def normalize(x: jax.Array) -> jax.Array:
  n = norm(x)
  return x / jnp.where(n < _EPS, 1.0, n)


def normalize_with_norm(x: jax.Array) -> tuple[jax.Array, jax.Array]:
  n = norm(x)
  return x / jnp.where(n < _EPS, 1.0, n), n


def quat_normalize(q: jax.Array) -> jax.Array:
  """Normalize quaternion; zero quaternion maps to identity (MuJoCo rule)."""
  n = norm(q)
  unit = jnp.array([1.0, 0.0, 0.0, 0.0], dtype=q.dtype)
  return jnp.where(n < _EPS, unit, q / jnp.where(n < _EPS, 1.0, n))


def mul_quat(u: jax.Array, v: jax.Array) -> jax.Array:
  """Hamilton product u*v (wxyz)."""
  return jnp.stack([
      u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
      u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
      u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
      u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
  ])


def rot_vec_quat(vec: jax.Array, quat: jax.Array) -> jax.Array:
  """Rotate 3-vector by quaternion (wxyz)."""
  w, qv = quat[0], quat[1:]
  # v' = v + 2w(qv × v) + 2 qv × (qv × v)
  t = 2.0 * jnp.cross(qv, vec)
  return vec + w * t + jnp.cross(qv, t)


def quat_inv(q: jax.Array) -> jax.Array:
  return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_to_mat(q: jax.Array) -> jax.Array:
  """Quaternion (wxyz) → 3x3 rotation matrix."""
  w, x, y, z = q[0], q[1], q[2], q[3]
  return jnp.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def mat_to_quat(mat: jax.Array) -> jax.Array:
  """3x3 rotation matrix → quaternion (wxyz), branch-free via 4-way select."""
  m = mat
  tr = m[0, 0] + m[1, 1] + m[2, 2]
  # Four candidate constructions; pick the numerically best (largest pivot).
  q0 = jnp.stack([
      1.0 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]
  ])
  q1 = jnp.stack([
      m[2, 1] - m[1, 2], 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
      m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]
  ])
  q2 = jnp.stack([
      m[0, 2] - m[2, 0], m[0, 1] + m[1, 0],
      1.0 - m[0, 0] + m[1, 1] - m[2, 2], m[1, 2] + m[2, 1]
  ])
  q3 = jnp.stack([
      m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
      1.0 - m[0, 0] - m[1, 1] + m[2, 2]
  ])
  pivots = jnp.stack([tr, m[0, 0], m[1, 1], m[2, 2]])
  idx = jnp.argmax(pivots)
  q = jnp.stack([q0, q1, q2, q3])[idx]
  return quat_normalize(q)


def axis_angle_to_quat(axis: jax.Array, angle: jax.Array) -> jax.Array:
  half = 0.5 * angle
  return jnp.concatenate([jnp.cos(half)[None], jnp.sin(half) * axis])


def quat_integrate(q: jax.Array, vel: jax.Array, dt: jax.Array) -> jax.Array:
  """Integrate quaternion by angular velocity over dt, exactly
  (reference: mujoco_warp/_src/math.py quat_integrate)."""
  angle = norm(vel) * dt
  axis = normalize(vel)
  # When |vel|*dt ~ 0 the axis-angle quat degrades to identity smoothly.
  dq = axis_angle_to_quat(axis, angle)
  return quat_normalize(mul_quat(q, dq))


def quat_sub(qa: jax.Array, qb: jax.Array) -> jax.Array:
  """Velocity-space difference qa ⊖ qb: 3-vector such that
  qb integrated by it reaches qa (MuJoCo mju_subQuat)."""
  dq = mul_quat(quat_inv(qb), qa)
  return quat_to_vel(dq)


def quat_to_vel(q: jax.Array) -> jax.Array:
  """Quaternion → 3D rotational velocity (mju_quat2Vel with dt=1)."""
  axis, sin_half = normalize_with_norm(q[1:])
  # atan2 handles q[0] < 0 (angle > pi) correctly.
  angle = 2.0 * jnp.arctan2(sin_half, q[0])
  # wrap to (-pi, pi]
  angle = jnp.where(angle > jnp.pi, angle - 2 * jnp.pi, angle)
  return axis * angle


# ---------------------------------------------------------------------------
# Spatial algebra
# ---------------------------------------------------------------------------


def motion_cross(u: jax.Array, v: jax.Array) -> jax.Array:
  """Spatial cross product of motion vectors: u ×ₘ v."""
  ang = jnp.cross(u[:3], v[:3])
  lin = jnp.cross(u[:3], v[3:]) + jnp.cross(u[3:], v[:3])
  return jnp.concatenate([ang, lin])


def motion_cross_force(u: jax.Array, f: jax.Array) -> jax.Array:
  """Spatial cross product applied to a force vector: u ×ₘ* f."""
  ang = jnp.cross(u[:3], f[:3]) + jnp.cross(u[3:], f[3:])
  lin = jnp.cross(u[:3], f[3:])
  return jnp.concatenate([ang, lin])


def inert_mul(i10: jax.Array, v: jax.Array) -> jax.Array:
  """Multiply 10-vec spatial inertia by motion vector → force vector
  (MuJoCo mju_mulInertVec). i10 = (Ixx,Iyy,Izz,Ixy,Ixz,Iyz, mc[3], m)."""
  ang, lin = v[:3], v[3:]
  mc = i10[6:9]
  m = i10[9]
  imat = jnp.array([
      [i10[0], i10[3], i10[4]],
      [i10[3], i10[1], i10[5]],
      [i10[4], i10[5], i10[2]],
  ])
  out_ang = imat @ ang + jnp.cross(mc, lin)
  out_lin = m * lin - jnp.cross(mc, ang)
  return jnp.concatenate([out_ang, out_lin])


def inert_from_body(mass: jax.Array, inertia: jax.Array, pos: jax.Array,
                    mat: jax.Array) -> jax.Array:
  """Build 10-vec spatial inertia of a body with diagonal `inertia` in a
  frame rotated by `mat` and offset by `pos` (MuJoCo mju_inertCom)."""
  # Rotate diagonal inertia: I = R diag(i) Rᵀ
  ri = mat * inertia[None, :]
  imat = ri @ mat.T
  # Parallel-axis: I += m (pᵀp E - p pᵀ)
  pp = jnp.outer(pos, pos)
  imat = imat + mass * (jnp.dot(pos, pos) * jnp.eye(3, dtype=pos.dtype) - pp)
  mc = mass * pos
  return jnp.concatenate([
      jnp.stack([imat[0, 0], imat[1, 1], imat[2, 2],
                 imat[0, 1], imat[0, 2], imat[1, 2]]),
      mc,
      mass[None],
  ])


def transform_motion(vec: jax.Array, offset: jax.Array,
                     rotnew2old: jax.Array | None = None) -> jax.Array:
  """Transform motion vector to a frame offset by `offset`
  (new_origin - old_origin in old/global frame), optionally rotating into a
  new frame whose rotation matrix (columns = new axes in old frame) is
  rotnew2old (MuJoCo mju_transformSpatial, forcematrix=0)."""
  ang, lin = vec[:3], vec[3:]
  lin = lin - jnp.cross(offset, ang)
  if rotnew2old is not None:
    ang = rotnew2old.T @ ang
    lin = rotnew2old.T @ lin
  return jnp.concatenate([ang, lin])


def transform_force(vec: jax.Array, offset: jax.Array,
                    rotnew2old: jax.Array | None = None) -> jax.Array:
  """Transform force vector to a frame offset by `offset`."""
  ang, lin = vec[:3], vec[3:]
  ang = ang - jnp.cross(offset, lin)
  if rotnew2old is not None:
    ang = rotnew2old.T @ ang
    lin = rotnew2old.T @ lin
  return jnp.concatenate([ang, lin])


def make_frame(a: jax.Array) -> jax.Array:
  """Build a 3x3 frame matrix whose first ROW is the normalized input
  vector, rows 2/3 span the orthogonal plane (MuJoCo mju_makeFrame order)."""
  a = normalize(a)
  # MuJoCo mju_makeFrame: helper = z-axis unless normal is near-vertical.
  y = jnp.array([0.0, 1.0, 0.0], dtype=a.dtype)
  z = jnp.array([0.0, 0.0, 1.0], dtype=a.dtype)
  helper = jnp.where(jnp.abs(a[2]) < 0.5, z, y)
  b = normalize(helper - a * jnp.dot(a, helper))
  c = jnp.cross(a, b)
  return jnp.stack([a, b, c])


def closest_segment_point(a: jax.Array, b: jax.Array,
                          pt: jax.Array) -> jax.Array:
  """Closest point on segment [a, b] to point pt."""
  ab = b - a
  denom = jnp.dot(ab, ab)
  t = jnp.dot(pt - a, ab) / jnp.where(denom < _EPS, 1.0, denom)
  t = jnp.clip(t, 0.0, 1.0)
  return a + t * ab


def closest_segment_segment(a0: jax.Array, a1: jax.Array, b0: jax.Array,
                            b1: jax.Array) -> tuple[jax.Array, jax.Array]:
  """Closest points between segments [a0,a1], [b0,b1] (branch-free)."""
  d1 = a1 - a0
  d2 = b1 - b0
  r = a0 - b0
  a = jnp.dot(d1, d1)
  e = jnp.dot(d2, d2)
  f = jnp.dot(d2, r)
  c = jnp.dot(d1, r)
  b = jnp.dot(d1, d2)
  denom = a * e - b * b
  s = jnp.where(denom > _EPS, jnp.clip((b * f - c * e) / jnp.where(
      denom > _EPS, denom, 1.0), 0.0, 1.0), 0.0)
  e_safe = jnp.where(e > _EPS, e, 1.0)
  t = (b * s + f) / e_safe
  t_clamped = jnp.clip(t, 0.0, 1.0)
  # Recompute s for clamped t.
  a_safe = jnp.where(a > _EPS, a, 1.0)
  s = jnp.where((t != t_clamped),
                jnp.clip((b * t_clamped - c) / a_safe, 0.0, 1.0), s)
  pa = a0 + d1 * s
  pb = b0 + d2 * t_clamped
  return pa, pb


def upper_tri_index(n: int, i, j):
  """Linear index into strict upper triangle of n x n matrix."""
  return (2 * n - i - 1) * i // 2 + (j - i - 1)
