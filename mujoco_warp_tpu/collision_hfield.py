"""Height-field narrowphase: sphere/capsule vs hfield
(reference: mujoco_warp/_src/collision_hfield path inside
collision_convex.py:158 hfield-tiled CCD; C mjc_ConvexHField).

Fixed-shape formulation: instead of enumerating prisms under the geom's
AABB with dynamic counts, each contact candidate tests a STATIC KxK
neighborhood of grid cells around the geom's (x, y) — 2 triangles per
cell, branch-free closest-point-on-triangle tests, top-k deepest
contacts kept. Height data is a padded (nhfield, nrow, ncol) array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import math
from .types import Data, GeomType, Model

_K = 3           # neighborhood half-width in cells
_NCONH = 4       # contacts returned per hfield pair


def _tri_closest(a, b, c, p):
  """Closest point on triangle (a, b, c) to p, branch-free."""
  ab = b - a
  ac = c - a
  ap = p - a
  d1 = jnp.dot(ab, ap)
  d2 = jnp.dot(ac, ap)
  bp = p - b
  d3 = jnp.dot(ab, bp)
  d4 = jnp.dot(ac, bp)
  cp = p - c
  d5 = jnp.dot(ab, cp)
  d6 = jnp.dot(ac, cp)

  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom_v = jnp.maximum(va + vb + vc, 1e-12)
  v_face = vb / denom_v
  w_face = vc / denom_v
  face = a + ab * v_face + ac * w_face

  # edge AB
  t_ab = jnp.clip(d1 / jnp.maximum(d1 - d3, 1e-12), 0.0, 1.0)
  on_ab = a + t_ab * ab
  # edge AC
  t_ac = jnp.clip(d2 / jnp.maximum(d2 - d6, 1e-12), 0.0, 1.0)
  on_ac = a + t_ac * ac
  # edge BC
  t_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6), 1e-12),
                  0.0, 1.0)
  on_bc = b + t_bc * (c - b)

  vert_a = (d1 <= 0) & (d2 <= 0)
  vert_b = (d3 >= 0) & (d4 <= d3)
  vert_c = (d6 >= 0) & (d5 <= d6)
  edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  edge_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

  out = face
  out = jnp.where(edge_bc, on_bc, out)
  out = jnp.where(edge_ac, on_ac, out)
  out = jnp.where(edge_ab, on_ab, out)
  out = jnp.where(vert_c, c, out)
  out = jnp.where(vert_b, b, out)
  out = jnp.where(vert_a, a, out)
  return out


def sphere_hfield(m: Model, hid: int, nrow: int, ncol: int,
                  hpos, hmat, hsize, center, radius):
  """All-candidate sphere-vs-hfield: returns (_NCONH,) contacts in world
  frame: (dist, pos, normal-from-hfield-to-sphere)."""
  data = m.hfield_data[hid]                 # (nrow_pad, ncol_pad)
  dtype = center.dtype
  # to hfield local frame: x in [-sx, sx], y in [-sy, sy]
  c_loc = hmat.T @ (center - hpos)
  sx, sy, sz, _ = hsize[0], hsize[1], hsize[2], hsize[3]
  dx = 2.0 * sx / (ncol - 1)
  dy = 2.0 * sy / (nrow - 1)
  fx = (c_loc[0] + sx) / dx                 # fractional column
  fy = (c_loc[1] + sy) / dy
  ci = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, ncol - 2)
  ri = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, nrow - 2)

  offs = np.arange(-_K + 1, _K)             # e.g. -2..2 for K=3
  cells = [(oi, oj) for oi in offs for oj in offs]
  dists, poss, normals = [], [], []
  for oi, oj in cells:
    r0 = jnp.clip(ri + oi, 0, nrow - 2)
    c0 = jnp.clip(ci + oj, 0, ncol - 2)
    x0 = -sx + c0.astype(dtype) * dx
    y0 = -sy + r0.astype(dtype) * dy
    z00 = data[r0, c0] * sz
    z01 = data[r0, c0 + 1] * sz
    z10 = data[r0 + 1, c0] * sz
    z11 = data[r0 + 1, c0 + 1] * sz
    p00 = jnp.stack([x0, y0, z00])
    p01 = jnp.stack([x0 + dx, y0, z01])
    p10 = jnp.stack([x0, y0 + dy, z10])
    p11 = jnp.stack([x0 + dx, y0 + dy, z11])
    for tri in ((p00, p01, p11), (p00, p11, p10)):
      q = _tri_closest(*tri, c_loc)
      dvec = c_loc - q
      dn = math.norm(dvec)
      n_loc = dvec / jnp.where(dn < 1e-12, 1.0, dvec * 0 + dn)
      n_loc = jnp.where(dn < 1e-12, jnp.array([0., 0., 1.], dtype), n_loc)
      # if the center is below the triangle plane, flip to surface normal
      tn = jnp.cross(tri[1] - tri[0], tri[2] - tri[0])
      tn = math.normalize(tn)
      below = jnp.dot(dvec, tn) < 0
      sd = jnp.where(below, -dn, dn)
      dist = sd - radius
      n_loc = jnp.where(below, tn, n_loc)
      dists.append(dist)
      poss.append(q + 0.5 * dist * n_loc)
      normals.append(n_loc)
  dists = jnp.stack(dists)
  poss = jnp.stack(poss)
  normals = jnp.stack(normals)
  # keep the _NCONH candidates CLOSEST to the surface (smallest |dist|):
  # a deeply-buried point is "below" the planes of far triangles too,
  # which report spuriously deep distances — the true penetration is
  # the distance to the nearest surface feature
  tie = jnp.arange(dists.shape[0], dtype=dtype) * 1e-7
  _, idx = jax.lax.top_k(-(jnp.abs(dists) + tie), _NCONH)
  dist_k = dists[idx]
  pos_k = poss[idx] @ hmat.T + hpos[None, :]
  n_k = normals[idx] @ hmat.T
  # drop near-duplicate positions (within 1e-6): mark dist=+inf
  def dedup(i, dk):
    same = (math.norm(pos_k[i] - pos_k[:i], axis=-1) < 1e-5) if i else None
    if i == 0:
      return dk
    return jnp.where(jnp.any(same), 1e10, dk)
  dist_k = jnp.stack([dedup(i, dist_k[i]) for i in range(_NCONH)])
  # geom1 is the hfield: contact frame normal points hfield -> geom2
  frames = jax.vmap(math.make_frame)(n_k)
  return dist_k, pos_k, frames


def _cell_prisms(m: Model, hid: int, nrow: int, ncol: int,
                 hmat, hpos, hsize, center):
  """(P, 6, 4) prism vertex buffers (hfield-LOCAL, mesh-hull layout:
  xyz + validity) for the 2 triangles of each cell in the static KxK
  neighborhood around `center` (world). Each prism extrudes a surface
  triangle down to the hfield base at z = -size[3] — exactly the convex
  prisms C MuJoCo's mjc_ConvexHField collides (reference
  collision_convex.py:158 tiles the same cells)."""
  data = m.hfield_data[hid]
  dtype = center.dtype
  c_loc = hmat.T @ (center - hpos)
  sx, sy, sz, base = hsize[0], hsize[1], hsize[2], hsize[3]
  dx = 2.0 * sx / (ncol - 1)
  dy = 2.0 * sy / (nrow - 1)
  fx = (c_loc[0] + sx) / dx
  fy = (c_loc[1] + sy) / dy
  ci = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, ncol - 2)
  ri = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, nrow - 2)
  offs = np.arange(-_K + 1, _K)
  prisms = []
  for oi in offs:
    for oj in offs:
      r0 = jnp.clip(ri + oi, 0, nrow - 2)
      c0 = jnp.clip(ci + oj, 0, ncol - 2)
      x0 = -sx + c0.astype(dtype) * dx
      y0 = -sy + r0.astype(dtype) * dy
      z00 = data[r0, c0] * sz
      z01 = data[r0, c0 + 1] * sz
      z10 = data[r0 + 1, c0] * sz
      z11 = data[r0 + 1, c0 + 1] * sz
      p00 = jnp.stack([x0, y0, z00])
      p01 = jnp.stack([x0 + dx, y0, z01])
      p10 = jnp.stack([x0, y0 + dy, z10])
      p11 = jnp.stack([x0 + dx, y0 + dy, z11])
      zb = -base
      for tri in ((p00, p01, p11), (p00, p11, p10)):
        top = jnp.stack(tri)                          # (3, 3)
        bot = top.at[:, 2].set(zb)
        verts = jnp.concatenate([top, bot], axis=0)   # (6, 3)
        prisms.append(jnp.concatenate(
            [verts, jnp.ones((6, 1), dtype)], axis=1))
  return jnp.stack(prisms)                            # (P, 6, 4)


def prism_mpr_hfield(m: Model, hid: int, nrow: int, ncol: int, t2: int,
                     p1, m1, s1, p2, m2, s2):
  """Exact hfield narrowphase for convex geoms: MPR between each cell
  prism (a 6-vertex convex, treated as a mesh hull) and the geom — the
  fixed-shape formulation of C mjc_ConvexHField / the reference's hfield-tiled
  CCD (reference collision_convex.py:158). Returns the _NCONH deepest
  contacts (dist, pos, frame), frame normal hfield -> geom."""
  from . import collision_convex
  prisms = _cell_prisms(m, hid, nrow, ncol, m1, p1, s1, p2)
  # flat-capable geoms (box/cylinder faces) need the multi-contact
  # manifold per prism — C's CCD emits the corner/edge witness set on
  # flat-on-triangle patches, a single MPR point lands mid-patch
  if GeomType(t2) in collision_convex._FLAT_CAPABLE:
    collide = collision_convex.mpr_multi(int(GeomType.MESH), t2)
  else:
    collide = collision_convex.mpr(int(GeomType.MESH), t2)
  s_dummy = jnp.zeros((3,), p2.dtype)

  def one(v1):
    dist, pos, frame = collide(p1, m1, s_dummy, p2, m2, s2, v1=v1)
    return dist, pos, frame

  dists, poss, frames = jax.vmap(one)(prisms)
  dists = dists.reshape(-1)
  poss = poss.reshape(-1, 3)
  frames = frames.reshape(-1, 3, 3)
  # deepest-first selection (dist = 1e10 for non-penetrating prisms)
  _, idx = jax.lax.top_k(-dists, _NCONH)
  dist_k = dists[idx]
  pos_k = poss[idx]
  fr_k = frames[idx]
  # near-duplicate positions (a deep vertex penetrates several prisms):
  # keep the first, mark the rest inactive
  def dedup(i, dk):
    if i == 0:
      return dk
    same = math.norm(pos_k[i] - pos_k[:i], axis=-1) < 1e-5
    return jnp.where(jnp.any(same), 1e10, dk)
  dist_k = jnp.stack([dedup(i, dist_k[i]) for i in range(_NCONH)])
  return dist_k, pos_k, fr_k


def hfield_collider(m: Model, hid: int, nrow: int, ncol: int, t2: int):
  """Collider closure for (HFIELD, t2) with static hfield id.
  sphere/capsule: analytic closest-point vs cell triangles (exact for
  sphere; capsule via end/mid sphere expansion). box/cylinder/
  ellipsoid: exact prism-MPR (C mjc_ConvexHField behavior)."""

  def collide(p1, m1, s1, p2, m2, s2):
    if t2 == GeomType.SPHERE:
      return sphere_hfield(m, hid, nrow, ncol, p1, m1, s1, p2, s2[0])
    if t2 == GeomType.CAPSULE:
      axis = m2[:, 2] * s2[1]
      outs = [sphere_hfield(m, hid, nrow, ncol, p1, m1, s1, p2 + e * axis,
                            s2[0]) for e in (-1.0, 0.0, 1.0)]
      dist = jnp.concatenate([o[0] for o in outs])
      pos = jnp.concatenate([o[1] for o in outs])
      frame = jnp.concatenate([o[2] for o in outs])
      # nearest-to-surface selection: buried sample points sit 'below' far
      # triangles too, which report spuriously deep distances
      _, idx = jax.lax.top_k(-jnp.abs(dist), _NCONH)
      return dist[idx], pos[idx], frame[idx]
    if t2 in (GeomType.BOX, GeomType.CYLINDER, GeomType.ELLIPSOID):
      return prism_mpr_hfield(m, hid, nrow, ncol, t2, p1, m1, s1,
                              p2, m2, s2)
    raise NotImplementedError(f'hfield vs geom type {t2}')

  return collide
