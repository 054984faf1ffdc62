"""Ray casting: analytic ray-geom intersections, world-parallel closest
hit (reference: mujoco_warp/_src/ray.py:188-700,909; C mj_ray).

Each intersector returns the smallest positive ray parameter t (or +inf
for a miss); the public ``ray`` takes the min over all geoms —
brute-force per ray, as a dense vectorized sweep (the
reference's `_ray` kernel does the same for non-mesh geoms; BVH
acceleration lands with the renderer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import math
from .types import Data, GeomType, Model

_INF = 1e10


def _positive_min(*ts):
  out = jnp.full((), _INF, ts[0].dtype)
  for t in ts:
    out = jnp.minimum(out, jnp.where(t >= 0, t, _INF))
  return out


def ray_plane(pos, mat, size, pnt, vec):
  n = mat[:, 2]
  denom = jnp.dot(vec, n)
  t = -jnp.dot(pnt - pos, n) / jnp.where(jnp.abs(denom) < 1e-12, 1.0,
                                         denom)
  hit = (jnp.abs(denom) > 1e-12) & (t >= 0)
  p = pnt + t * vec - pos
  x = jnp.dot(p, mat[:, 0])
  y = jnp.dot(p, mat[:, 1])
  inb = ((size[0] <= 0) | (jnp.abs(x) <= size[0])) & (
      (size[1] <= 0) | (jnp.abs(y) <= size[1]))
  return jnp.where(hit & inb, t, _INF)


def _ray_sphere_at(center, r, pnt, vec):
  oc = pnt - center
  a = jnp.dot(vec, vec)
  b = 2.0 * jnp.dot(oc, vec)
  c = jnp.dot(oc, oc) - r * r
  disc = b * b - 4 * a * c
  sq = jnp.sqrt(jnp.maximum(disc, 0.0))
  t0 = (-b - sq) / (2 * a)
  t1 = (-b + sq) / (2 * a)
  t = jnp.where(t0 >= 0, t0, t1)
  return jnp.where((disc >= 0) & (t >= 0), t, _INF)


def ray_sphere(pos, mat, size, pnt, vec):
  return _ray_sphere_at(pos, size[0], pnt, vec)


def ray_capsule(pos, mat, size, pnt, vec):
  axis = mat[:, 2]
  r, h = size[0], size[1]
  # infinite-cylinder part
  oc = pnt - pos
  vp = vec - axis * jnp.dot(vec, axis)
  op = oc - axis * jnp.dot(oc, axis)
  a = jnp.dot(vp, vp)
  b = 2 * jnp.dot(op, vp)
  c = jnp.dot(op, op) - r * r
  disc = b * b - 4 * a * c
  sq = jnp.sqrt(jnp.maximum(disc, 0.0))
  asafe = jnp.where(a < 1e-12, 1.0, a)
  t0 = (-b - sq) / (2 * asafe)
  t1 = (-b + sq) / (2 * asafe)

  def side_ok(t):
    z = jnp.dot(oc + t * vec, axis)
    return (disc >= 0) & (a >= 1e-12) & (t >= 0) & (jnp.abs(z) <= h)

  ts = jnp.where(side_ok(t0), t0, jnp.where(side_ok(t1), t1, _INF))
  tc1 = _ray_sphere_at(pos + axis * h, r, pnt, vec)
  tc2 = _ray_sphere_at(pos - axis * h, r, pnt, vec)
  return jnp.minimum(ts, jnp.minimum(tc1, tc2))


def ray_ellipsoid(pos, mat, size, pnt, vec):
  # scale to unit sphere space
  inv = 1.0 / size
  p = (mat.T @ (pnt - pos)) * inv
  v = (mat.T @ vec) * inv
  a = jnp.dot(v, v)
  b = 2 * jnp.dot(p, v)
  c = jnp.dot(p, p) - 1.0
  disc = b * b - 4 * a * c
  sq = jnp.sqrt(jnp.maximum(disc, 0.0))
  t0 = (-b - sq) / (2 * a)
  t1 = (-b + sq) / (2 * a)
  t = jnp.where(t0 >= 0, t0, t1)
  return jnp.where((disc >= 0) & (t >= 0), t, _INF)


def ray_cylinder(pos, mat, size, pnt, vec):
  axis = mat[:, 2]
  r, h = size[0], size[1]
  oc = pnt - pos
  vp = vec - axis * jnp.dot(vec, axis)
  op = oc - axis * jnp.dot(oc, axis)
  a = jnp.dot(vp, vp)
  b = 2 * jnp.dot(op, vp)
  c = jnp.dot(op, op) - r * r
  disc = b * b - 4 * a * c
  sq = jnp.sqrt(jnp.maximum(disc, 0.0))
  asafe = jnp.where(a < 1e-12, 1.0, a)
  t0 = (-b - sq) / (2 * asafe)
  t1 = (-b + sq) / (2 * asafe)

  def side_ok(t):
    z = jnp.dot(oc + t * vec, axis)
    return (disc >= 0) & (a >= 1e-12) & (t >= 0) & (jnp.abs(z) <= h)

  ts = jnp.where(side_ok(t0), t0, jnp.where(side_ok(t1), t1, _INF))

  # end caps: plane hits within radius
  vz = jnp.dot(vec, axis)
  vz_safe = jnp.where(jnp.abs(vz) < 1e-12, 1.0, vz)
  oz = jnp.dot(oc, axis)

  def cap(sign):
    t = (sign * h - oz) / vz_safe
    q = oc + t * vec - sign * h * axis
    rad2 = jnp.dot(q, q) - jnp.dot(q, axis) ** 2
    ok = (jnp.abs(vz) >= 1e-12) & (t >= 0) & (rad2 <= r * r)
    return jnp.where(ok, t, _INF)

  return jnp.minimum(ts, jnp.minimum(cap(1.0), cap(-1.0)))


def ray_box(pos, mat, size, pnt, vec):
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec
  vsafe = jnp.where(jnp.abs(v) < 1e-12, 1e-12, v)
  t1 = (-size[:3] - p) / vsafe
  t2 = (size[:3] - p) / vsafe
  tmin = jnp.max(jnp.minimum(t1, t2))
  tmax = jnp.min(jnp.maximum(t1, t2))
  t = jnp.where(tmin >= 0, tmin, tmax)
  return jnp.where((tmax >= tmin) & (t >= 0), t, _INF)


RAY_FN = {
    GeomType.PLANE: ray_plane,
    GeomType.SPHERE: ray_sphere,
    GeomType.CAPSULE: ray_capsule,
    GeomType.ELLIPSOID: ray_ellipsoid,
    GeomType.CYLINDER: ray_cylinder,
    GeomType.BOX: ray_box,
}


def ray_mesh(faces, pos, mat, pnt, vec):
  """Ray vs triangle mesh: vectorized Moller-Trumbore over the padded
  face array (degenerate padding rows never hit), min positive t
  (reference ray.py:188-700 ray_mesh; BVH acceleration is future work —
  a dense masked sweep is the natural first formulation)."""
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec
  a = faces[:, 0]
  e1 = faces[:, 1] - a
  e2 = faces[:, 2] - a
  pvec = jnp.cross(v[None, :], e2)
  det = jnp.einsum('fi,fi->f', e1, pvec)
  ok = jnp.abs(det) > 1e-12
  inv = 1.0 / jnp.where(ok, det, 1.0)
  tvec = p[None, :] - a
  u = jnp.einsum('fi,fi->f', tvec, pvec) * inv
  qvec = jnp.cross(tvec, e1)
  w = jnp.einsum('i,fi->f', v, qvec) * inv
  t = jnp.einsum('fi,fi->f', e2, qvec) * inv
  hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
  return jnp.min(jnp.where(hit, t, _INF))


def ray_hfield(m: Model, hid: int, pos, mat, pnt, vec):
  """Ray vs height field: base box + the two triangles of every cell +
  the four side walls clipped by the terrain edge profile (reference
  ray.py:452-620 ray_hfield; C mju_rayHfield). The reference walks only
  the cells along the ray; a masked sweep over the whole static
  grid is the natural formulation (same trade as ray_mesh)."""
  nr, nc = m.hfield_nrow[hid], m.hfield_ncol[hid]
  size = m.hfield_size[hid]
  grid = m.hfield_data[hid, :nr, :nc]              # normalized heights
  sx, sy, sz, sb = size[0], size[1], size[2], size[3]
  dtype = pnt.dtype

  # base box (below z=0, depth sb)
  zcol = mat[:, 2]
  t_base = ray_box(pos - zcol * (sb * 0.5), mat,
                   jnp.stack([sx, sy, sb * 0.5]), pnt, vec)

  # surface triangles (C's cell triangulation)
  faces = hfield_faces(m, hid, dtype)
  t_tri = ray_mesh(faces, pos, mat, pnt, vec)

  # side walls of the terrain prism, solid below the edge profile
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec
  dxc = 2.0 * sx / (nc - 1)
  dyc = 2.0 * sy / (nr - 1)

  def wall(axis, sign, edge, other_half, cellw, ncells):
    vn = v[axis]
    vsafe = jnp.where(jnp.abs(vn) < 1e-12, 1.0, vn)
    t = (sign * (sx if axis == 0 else sy) - p[axis]) / vsafe
    q = p + t * v
    oth = q[1 - axis]
    u = (oth + other_half) / cellw
    u0 = jnp.clip(jnp.floor(u), 0, ncells - 2).astype(jnp.int32)
    z0 = edge[u0]
    z1 = edge[u0 + 1]
    zlim = z0 * (u0 + 1.0 - u) + z1 * (u - u0)
    ok = ((jnp.abs(vn) >= 1e-12) & (t >= 0) &
          (jnp.abs(oth) <= other_half) &
          (q[2] >= 0) & (q[2] / jnp.maximum(sz, 1e-12) < zlim))
    return jnp.where(ok, t, _INF)

  t_walls = _positive_min(
      wall(0, -1.0, grid[:, 0], sy, dyc, nr),
      wall(0, 1.0, grid[:, -1], sy, dyc, nr),
      wall(1, -1.0, grid[0, :], sx, dxc, nc),
      wall(1, 1.0, grid[-1, :], sx, dxc, nc))

  return jnp.minimum(jnp.minimum(t_base, t_tri), t_walls)


def ray_mesh_hit(faces, pos, mat, pnt, vec):
  """ray_mesh + the world-frame normal of the hit face (oriented
  against the ray). Used by the renderer for shading."""
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec
  a = faces[:, 0]
  e1 = faces[:, 1] - a
  e2 = faces[:, 2] - a
  pvec = jnp.cross(v[None, :], e2)
  det = jnp.einsum('fi,fi->f', e1, pvec)
  ok = jnp.abs(det) > 1e-12
  inv = 1.0 / jnp.where(ok, det, 1.0)
  tvec = p[None, :] - a
  u = jnp.einsum('fi,fi->f', tvec, pvec) * inv
  qvec = jnp.cross(tvec, e1)
  w = jnp.einsum('i,fi->f', v, qvec) * inv
  t = jnp.einsum('fi,fi->f', e2, qvec) * inv
  hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
  tall = jnp.where(hit, t, _INF)
  i = jnp.argmin(tall)
  n_loc = jnp.cross(e1[i], e2[i])
  n_loc = n_loc * jnp.sign(-jnp.dot(n_loc, v))
  n = math.normalize(mat @ n_loc)
  return tall[i], n


def ray_mesh_hit_uv(faces, face_uv, pos, mat, pnt, vec):
  """ray_mesh_hit + texcoord of the hit: barycentric interpolation of
  the per-face-corner uv table `face_uv` (F, 3, 2) (reference
  render.py:44 sample_texture's MESH branch)."""
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec
  a = faces[:, 0]
  e1 = faces[:, 1] - a
  e2 = faces[:, 2] - a
  pvec = jnp.cross(v[None, :], e2)
  det = jnp.einsum('fi,fi->f', e1, pvec)
  ok = jnp.abs(det) > 1e-12
  inv = 1.0 / jnp.where(ok, det, 1.0)
  tvec = p[None, :] - a
  u = jnp.einsum('fi,fi->f', tvec, pvec) * inv
  qvec = jnp.cross(tvec, e1)
  w = jnp.einsum('i,fi->f', v, qvec) * inv
  t = jnp.einsum('fi,fi->f', e2, qvec) * inv
  hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
  tall = jnp.where(hit, t, _INF)
  i = jnp.argmin(tall)
  n_loc = jnp.cross(e1[i], e2[i])
  n_loc = n_loc * jnp.sign(-jnp.dot(n_loc, v))
  n = math.normalize(mat @ n_loc)
  # hit point = a + u*e1 + w*e2 -> uv = (1-u-w)*uv_a + u*uv_b + w*uv_c
  uvf = face_uv[i]                                   # (3, 2)
  uv = (1.0 - u[i] - w[i]) * uvf[0] + u[i] * uvf[1] + w[i] * uvf[2]
  return tall[i], n, uv


def hfield_faces(m: Model, hid: int, dtype=jnp.float32):
  """(F, 3, 3) local-frame surface triangles of a height field (C cell
  triangulation; shared by ray_hfield and the renderer)."""
  nr, nc = m.hfield_nrow[hid], m.hfield_ncol[hid]
  size = m.hfield_size[hid]
  grid = m.hfield_data[hid, :nr, :nc]
  xs = (2.0 * jnp.arange(nc, dtype=dtype) / (nc - 1) - 1.0) * size[0]
  ys = (2.0 * jnp.arange(nr, dtype=dtype) / (nr - 1) - 1.0) * size[1]
  V = jnp.stack([jnp.broadcast_to(xs[None, :], (nr, nc)),
                 jnp.broadcast_to(ys[:, None], (nr, nc)),
                 grid * size[2]], axis=-1)
  v00 = V[:-1, :-1].reshape(-1, 3)
  v10 = V[:-1, 1:].reshape(-1, 3)
  v01 = V[1:, :-1].reshape(-1, 3)
  v11 = V[1:, 1:].reshape(-1, 3)
  return jnp.concatenate([
      jnp.stack([v00, v10, v11], axis=1),
      jnp.stack([v00, v11, v01], axis=1)], axis=0)


def ray_geom(m: Model, d: Data, geomid: int, pnt: jax.Array,
             vec: jax.Array) -> jax.Array:
  """t for one (static-id) geom."""
  gtype = GeomType(m.geom_type[geomid])
  if gtype == GeomType.MESH and m.geom_dataid[geomid] >= 0:
    did = m.geom_dataid[geomid]
    if m.mesh_cluster_aabb.shape[1] > 4:
      # large mesh: cluster-marched exact query (bvh.py) — tests only
      # the clusters a front-to-back BVH walk would
      from . import bvh as bvh_mod
      return bvh_mod.ray_mesh_clustered(
          m.mesh_faces[did], m.mesh_cluster_aabb[did],
          d.geom_xpos[geomid], d.geom_xmat[geomid], pnt, vec)
    return ray_mesh(m.mesh_faces[did],
                    d.geom_xpos[geomid], d.geom_xmat[geomid], pnt, vec)
  if gtype == GeomType.HFIELD and m.geom_dataid[geomid] >= 0:
    return ray_hfield(m, m.geom_dataid[geomid], d.geom_xpos[geomid],
                      d.geom_xmat[geomid], pnt, vec)
  fn = RAY_FN.get(gtype)
  if fn is None:
    return jnp.full((), _INF, pnt.dtype)
  return fn(d.geom_xpos[geomid], d.geom_xmat[geomid], m.geom_size[geomid],
            pnt, vec)


def ray(m: Model, d: Data, pnt: jax.Array, vec: jax.Array,
        bodyexclude: int = -1, geomgroup=None):
  """Closest hit over all geoms: (geomid, dist); geomid -1 on miss
  (reference ray.py:1168; C mj_ray)."""
  vec = math.normalize(vec)
  ts = []
  ids = []
  for g in range(m.ngeom):
    if m.geom_bodyid[g] == bodyexclude:
      continue
    gt = GeomType(m.geom_type[g])
    if (gt not in RAY_FN and
        not (gt in (GeomType.MESH, GeomType.HFIELD) and
             m.geom_dataid[g] >= 0)):
      continue
    ts.append(ray_geom(m, d, g, pnt, vec))
    ids.append(g)
  if not ts:
    return jnp.full((), -1, jnp.int32), jnp.full((), -1.0, pnt.dtype)
  ts = jnp.stack(ts)
  ids = jnp.asarray(np.array(ids, dtype=np.int32))
  i = jnp.argmin(ts)
  tmin = ts[i]
  hit = tmin < _INF * 0.5
  return (jnp.where(hit, ids[i], -1).astype(jnp.int32),
          jnp.where(hit, tmin, -1.0))


def rays(m: Model, d: Data, pnts: jax.Array, vecs: jax.Array):
  """Batched closest-hit (reference ray.py:1212)."""
  return jax.vmap(lambda p, v: ray(m, d, p, v))(pnts, vecs)
