"""Generic convex narrowphase: support functions + MPR (Minkowski
Portal Refinement) with fixed iteration counts and mask-based control
flow.

Replaces the reference's GJK/EPA kernels (mujoco_warp/_src/
collision_gjk.py, collision_convex.py) with a fixed-shape formulation:
MPR handles the penetrating case directly (no polytope bookkeeping — a
3-vertex portal refined toward the origin ray), and a fixed-iteration
GJK gives separation distance for margin-positive models. All loops are
``lax.fori_loop`` with per-lane masks, so the collider vmaps over pair
batches exactly like the analytic primitives.

Contact convention matches the analytic colliders: returns (dist, pos,
frame) with frame[0] = contact normal pointing from geom1 into geom2,
pos = midpoint between the two surface points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import math
from .types import DisableBit
from .types import GeomType

_MPR_ITERATIONS = 24
_TOL = 1e-6

# multi-contact re-portal tilt angle (radians). Small enough that the
# depth/position error of a perturbed contact (~angle * lever arm) is
# negligible, large enough that portal refinement on a tilted flat face
# lands on a distinct corner of the contact patch.
_MULTI_TILT = 1e-3


# ---------------------------------------------------------------------------
# Support functions. Each takes (pos, mat, size, vert, d_world) where
# `vert` is the (padded) convex-hull vertex buffer for mesh geoms (None
# otherwise) and returns the world support point in direction d.
# ---------------------------------------------------------------------------


def _supp_sphere(p, R, s, vert, d):
  return p + s[0] * math.normalize(d)


def _supp_capsule(p, R, s, vert, d):
  dn = math.normalize(d)
  axis = R[:, 2]
  return p + axis * (s[1] * jnp.sign(jnp.dot(dn, axis))) + s[0] * dn


def _supp_ellipsoid(p, R, s, vert, d):
  dl = R.T @ d
  sd = s * dl
  denom = math.norm(sd)
  x = (s * sd) / jnp.where(denom < 1e-12, 1.0, denom)
  return p + R @ x


def _supp_cylinder(p, R, s, vert, d):
  dl = R.T @ d
  rho = jnp.sqrt(dl[0] * dl[0] + dl[1] * dl[1])
  rsafe = jnp.where(rho < 1e-12, 1.0, rho)
  x = jnp.stack([s[0] * dl[0] / rsafe, s[0] * dl[1] / rsafe,
                 s[1] * jnp.sign(dl[2])])
  x = jnp.where(rho < 1e-12, jnp.stack([0.0 * dl[0], 0.0 * dl[1],
                                        s[1] * jnp.sign(dl[2])]), x)
  return p + R @ x


def _supp_box(p, R, s, vert, d):
  dl = R.T @ d
  return p + R @ (s[:3] * jnp.sign(dl))


def _supp_mesh(p, R, s, vert, d):
  """vert: (V, 4) — xyz + validity mask (padded hull vertices, local)."""
  dl = R.T @ d
  dots = vert[:, :3] @ dl
  dots = jnp.where(vert[:, 3] > 0, dots, -jnp.inf)
  i = jnp.argmax(dots)
  return p + R @ vert[i, :3]


SUPPORT = {
    GeomType.SPHERE: _supp_sphere,
    GeomType.CAPSULE: _supp_capsule,
    GeomType.ELLIPSOID: _supp_ellipsoid,
    GeomType.CYLINDER: _supp_cylinder,
    GeomType.BOX: _supp_box,
    GeomType.MESH: _supp_mesh,
}

# geom types with a smooth surface: 1-contact manifolds suffice
_CENTER = {
    GeomType.SPHERE: lambda p, R, s, v: p,
    GeomType.CAPSULE: lambda p, R, s, v: p,
    GeomType.ELLIPSOID: lambda p, R, s, v: p,
    GeomType.CYLINDER: lambda p, R, s, v: p,
    GeomType.BOX: lambda p, R, s, v: p,
    GeomType.MESH: lambda p, R, s, v: p + R @ (
        jnp.sum(v[:, :3] * (v[:, 3:] > 0), axis=0) /
        jnp.maximum(jnp.sum(v[:, 3] > 0), 1)),
}


# types whose contact patch can be a face (flat-on-flat needs a
# manifold); sphere/ellipsoid contacts are always point-like
_FLAT_CAPABLE = {GeomType.BOX, GeomType.MESH, GeomType.CYLINDER}
_POINT_LIKE = {GeomType.SPHERE, GeomType.ELLIPSOID}


def manifold_ncon(t1: int, t2: int, disableflags: int) -> int:
  """Contact slots for an MPR-routed type pair: 5 when a multi-point
  manifold is possible and MULTICCD is not disabled (MuJoCo >= 3.3:
  multi-contact CCD is on by default, mjDSBL_MULTICCD turns it off),
  else 1. Mirrors the reference's use_multiccd gating (reference
  io.py:373-389) with the disable-bit semantics of our MuJoCo pin."""
  if disableflags & DisableBit.MULTICCD:
    return 1
  t1, t2 = GeomType(t1), GeomType(t2)
  if t1 in _POINT_LIKE or t2 in _POINT_LIKE:
    return 1
  if t1 in _FLAT_CAPABLE or t2 in _FLAT_CAPABLE:
    return 5
  return 1


def collider(t1: int, t2: int, disableflags: int):
  """(collider_fn, ncon slots) for an MPR-routed type pair."""
  k = manifold_ncon(t1, t2, disableflags)
  return (mpr_multi(t1, t2) if k > 1 else mpr(t1, t2)), k


def mpr(t1: int, t2: int):
  """Build an MPR collider for a static geom-type pair. The returned
  function maps raw pair geometry (+ optional hull verts) to
  (dist[1], pos[1, 3], frame[1, 3, 3])."""
  supp1 = SUPPORT[GeomType(t1)]
  supp2 = SUPPORT[GeomType(t2)]
  c1fn = _CENTER[GeomType(t1)]
  c2fn = _CENTER[GeomType(t2)]

  def collide(p1, m1, s1, p2, m2, s2, v1=None, v2=None, margin=0.0):
    """margin expands geom2's support by `margin` along the query
    direction: the expanded penetration depth p maps to the true
    distance as dist = margin - p, giving separation distances within
    the margin band from the same portal refinement (the reference
    inflates geoms for margin the same way, collision_gjk.py)."""
    dtype = p1.dtype
    margin = jnp.asarray(margin, dtype)

    def S(d):
      """Minkowski-difference support: supp2(d) - supp1(-d); also
      returns the witness points on both geoms."""
      dn = math.normalize(d)
      a = supp1(p1, m1, s1, v1, -d)
      b = supp2(p2, m2, s2, v2, d) + margin * dn
      return b - a, a, b

    # phase 1: interior point of the difference (center2 - center1)
    c1 = c1fn(p1, m1, s1, v1)
    c2 = c2fn(p2, m2, s2, v2)
    v0 = c2 - c1
    v0 = jnp.where(math.norm(v0) < 1e-10,
                   jnp.array([1e-5, 0, 0], dtype), v0)

    # phase 2: initial portal — canonical XenoCollide/libccd-MPR
    # structure (reference behavior: mujoco_warp/_src/collision_gjk.py
    # gjk/epa; C mjc_Convex). The portal triangle (w1, w2, w3) is kept
    # wound so that cross(w2-w1, w3-w1) points OUTWARD (away from v0)
    # by construction — no flip heuristics (orienting by dot(n, v0)
    # breaks when v0 is nearly parallel to the portal plane and walks
    # the portal to the far face of the CSO, reporting ~0.65 m fake
    # penetrations for cleanly separated mesh pairs). Every `miss`
    # condition below is a sound separating-axis witness.
    d1 = math.normalize(-v0)
    w1, a1, b1 = S(d1)
    miss = jnp.dot(w1, d1) < 0          # SA: CSO cannot reach origin
    d2 = jnp.cross(v0, w1)
    d2n = math.norm(d2)
    # v0 colinear with w1 through the origin -> any perpendicular
    d2 = jnp.where(d2n < 1e-10, math.normalize(
        jnp.cross(v0, jnp.array([0.57, 0.62, 0.53], dtype))),
        d2 / jnp.where(d2n < 1e-10, 1.0, d2n))
    w2, a2, b2 = S(d2)
    miss |= jnp.dot(w2, d2) < 0
    d3 = jnp.cross(w1 - v0, w2 - v0)
    # origin must be on the -d3 side: swap w1/w2 to fix the winding
    swap = jnp.dot(d3, v0) > 0
    w1, w2 = jnp.where(swap, w2, w1), jnp.where(swap, w1, w2)
    a1, a2 = jnp.where(swap, a2, a1), jnp.where(swap, a1, a2)
    b1, b2 = jnp.where(swap, b2, b1), jnp.where(swap, b1, b2)
    d3 = math.normalize(jnp.where(swap, -d3, d3))
    w3, a3, b3 = S(d3)

    # portal discovery: rotate the candidate portal about the origin ray
    # until the ray v0->O passes through triangle (w1, w2, w3). Fixed
    # iterations with masked updates; each samples ONE fresh support.
    def disc_body(_, state):
      (w1, a1, b1, w2, a2, b2, w3, a3, b3, dirn, miss, done) = state
      w3n, a3n, b3n = S(dirn)
      miss_i = jnp.dot(w3n, dirn) < 0
      # origin outside plane (v0, w1, w3n): w2 := w3n, re-aim, continue
      cA = jnp.dot(jnp.cross(w1, w3n), v0) < 0
      # origin outside plane (v0, w3n, w2): w1 := w3n, re-aim, continue
      cB = ~cA & (jnp.dot(jnp.cross(w3n, w2), v0) < 0)
      fin = ~cA & ~cB                    # ray inside: portal complete
      upd = ~done & ~miss_i
      sel = lambda c, x, y: jnp.where(c & upd, x, y)
      w2_, a2_, b2_ = sel(cA, w3n, w2), sel(cA, a3n, a2), sel(cA, b3n, b2)
      w1_, a1_, b1_ = sel(cB, w3n, w1), sel(cB, a3n, a1), sel(cB, b3n, b1)
      w3_ = jnp.where(upd, w3n, w3)
      a3_ = jnp.where(upd, a3n, a3)
      b3_ = jnp.where(upd, b3n, b3)
      dir_a = math.normalize(jnp.cross(w1_ - v0, w3n - v0))
      dir_b = math.normalize(jnp.cross(w3n - v0, w2_ - v0))
      dirn_ = jnp.where(cA & upd, dir_a,
                        jnp.where(cB & upd, dir_b, dirn))
      miss_ = miss | (miss_i & ~done)
      done_ = done | miss_i | (fin & ~done)
      return (w1_, a1_, b1_, w2_, a2_, b2_, w3_, a3_, b3_, dirn_,
              miss_, done_)

    done0 = jnp.zeros((), bool)
    # early-exit while: under vmap the loop runs to the batch's max
    # needed iteration (typically 2-6) instead of the fixed cap of 12 —
    # the portal loops dominate large-batch convex scenes (apollo)
    state = (jnp.zeros((), jnp.int32),
             (w1, a1, b1, w2, a2, b2, w3, a3, b3, d3, miss, done0))
    state = jax.lax.while_loop(
        lambda s: (s[0] < 12) & ~s[1][-1],
        lambda s: (s[0] + 1, disc_body(s[0], s[1])), state)
    w1, a1, b1, w2, a2, b2, w3, a3, b3, _, miss, _ = state[1]

    # phase 3: portal refinement toward the origin. The expandPortal
    # update keeps the outward winding invariant (libccd expandPortal).
    def ref_body(_, state):
      w1, a1, b1, w2, a2, b2, w3, a3, b3, miss, done = state
      n = math.normalize(jnp.cross(w2 - w1, w3 - w1))   # outward
      w4, a4, b4 = S(n)
      sep = jnp.dot(w4, n) < 0          # SA: separated along n
      prog = jnp.dot(n, w4 - w3)
      new_done = done | sep | (prog < _TOL)
      miss = miss | (sep & ~done)
      # choose the sub-portal that still contains the v0->origin ray
      v4v0 = jnp.cross(w4, v0)
      e1 = jnp.dot(w1, v4v0) > 0
      e2 = jnp.dot(w2, v4v0) > 0
      e3 = jnp.dot(w3, v4v0) > 0
      r1 = (e1 & e2) | (~e1 & ~e3)
      r2 = ~e1 & e3
      r3 = e1 & ~e2
      sel = lambda c, x, y: jnp.where(c & ~new_done, x, y)
      w1n = sel(r1, w4, w1); a1n = sel(r1, a4, a1); b1n = sel(r1, b4, b1)
      w2n = sel(r2, w4, w2); a2n = sel(r2, a4, a2); b2n = sel(r2, b4, b2)
      w3n = sel(r3, w4, w3); a3n = sel(r3, a4, a3); b3n = sel(r3, b4, b3)
      return (w1n, a1n, b1n, w2n, a2n, b2n, w3n, a3n, b3n, miss,
              new_done)

    state = (jnp.zeros((), jnp.int32),
             (w1, a1, b1, w2, a2, b2, w3, a3, b3, miss, done0))
    state = jax.lax.while_loop(
        lambda s: (s[0] < _MPR_ITERATIONS) & ~s[1][-1],
        lambda s: (s[0] + 1, ref_body(s[0], s[1])), state)
    w1, a1, b1, w2, a2, b2, w3, a3, b3, miss, _ = state[1]

    # final portal plane (outward normal by the winding invariant)
    n = math.normalize(jnp.cross(w2 - w1, w3 - w1))
    plane_d = jnp.dot(n, w1)        # signed dist of portal plane from O
    # penetration iff the origin is inside the portal plane AND no
    # separating axis was witnessed; insurance: the support along the
    # final normal must itself reach the origin (sound SA check — can
    # never reject a truly penetrating pair)
    w_sa, _, _ = S(n)
    penetrating = (plane_d >= 0) & ~miss & (jnp.dot(n, w_sa) >= 0)
    depth = plane_d                  # >= 0 when penetrating

    # witness points: barycentric coords of the origin ray hit on the
    # portal, applied to the per-geom support points
    # project origin onto portal plane along n
    q = -n * (-plane_d)
    # barycentric of q in (w1, w2, w3)
    e1 = w2 - w1
    e2 = w3 - w1
    qp = q - w1
    d11 = jnp.dot(e1, e1)
    d12 = jnp.dot(e1, e2)
    d22 = jnp.dot(e2, e2)
    dq1 = jnp.dot(qp, e1)
    dq2 = jnp.dot(qp, e2)
    det = jnp.maximum(d11 * d22 - d12 * d12, 1e-12)
    l2 = (d22 * dq1 - d12 * dq2) / det
    l3 = (d11 * dq2 - d12 * dq1) / det
    l1 = 1.0 - l2 - l3
    l1, l2, l3 = [jnp.clip(x, 0.0, 1.0) for x in (l1, l2, l3)]
    lsum = jnp.maximum(l1 + l2 + l3, 1e-12)
    l1, l2, l3 = l1 / lsum, l2 / lsum, l3 / lsum
    pa = l1 * a1 + l2 * a2 + l3 * a3   # witness on geom1
    pb = l1 * b1 + l2 * b2 + l3 * b3   # witness on geom2

    # contact normal from geom1 into geom2 = -n (portal normal points
    # from origin outward = direction of deepest translation of B)
    normal = -n
    # undo the margin expansion: depth is of the INFLATED pair
    dist = jnp.where(penetrating, margin - depth, 1e10)
    pos = 0.5 * (pa + pb) - 0.5 * margin * n
    return dist[None], pos[None], math.make_frame(normal)[None]

  return collide


def _axis_angle_mat(u, angle, dtype):
  """Rotation matrix for angle about unit axis u (Rodrigues)."""
  c = jnp.cos(angle)
  s = jnp.sin(angle)
  zero = jnp.zeros((), dtype)
  ux = jnp.stack([
      jnp.stack([zero, -u[2], u[1]]),
      jnp.stack([u[2], zero, -u[0]]),
      jnp.stack([-u[1], u[0], zero]),
  ])
  eye = jnp.eye(3, dtype=dtype)
  return c * eye + s * ux + (1.0 - c) * jnp.outer(u, u)


def mpr_multi(t1: int, t2: int):
  """Multi-contact convex narrowphase: base MPR + four tangential
  tilt re-portals, giving up to a 5-point manifold for flat-on-flat
  (mesh/box/cylinder face) contact.

  The reference implements this as explicit contact-face polygon
  clipping (mujoco_warp/_src/collision_convex.py:706-1267, gated on
  MULTICCD); polygon extraction + Sutherland-Hodgman clipping is
  pointer-chasing over mesh topology and maps poorly onto fixed-shape
  vector lanes. The fixed-shape equivalent used here: tilt geom2 by
  +/-_MULTI_TILT about the two contact tangent axes (rotating about the
  base contact point) and re-run the same fixed-iteration portal
  refinement. On a flat contact patch each tilt lands the deepest point
  on a distinct edge/corner of the patch; on a smooth (curved) surface
  the perturbed point moves only O(tilt * curvature radius) and is
  rejected by the distinctness test, so sphere-like contacts still
  yield one point. Perturbed positions/depths are mapped back to the
  untilted configuration to first order (exact for the infinitesimal
  limit; error O(tilt * patch radius) ~ 1e-4 of geom size, below
  solref impedance scales)."""
  base = mpr(t1, t2)

  def collide(p1, m1, s1, p2, m2, s2, v1=None, v2=None, margin=0.0):
    dtype = p1.dtype
    dist0, pos0, frame0 = base(p1, m1, s1, p2, m2, s2, v1, v2, margin)
    n = frame0[0, 0]
    tangents = (frame0[0, 1], frame0[0, 2])
    c0 = pos0[0]
    base_hit = dist0[0] < 1e9

    # distinctness tolerance: curved-surface drift is ~_MULTI_TILT * r;
    # a flat patch moves the contact point a patch-radius. 10x over the
    # curvature bound keeps spheres single-point while accepting any
    # patch larger than ~1% of the geom scale.
    def _scale(s, v):
      r = jnp.max(jnp.abs(s))
      if v is not None:
        vn = math.norm(v[:, :3], axis=-1) * (v[:, 3] > 0)
        r = jnp.maximum(r, jnp.max(vn))
      return r
    rmax = jnp.maximum(jnp.maximum(_scale(s1, v1), _scale(s2, v2)),
                       jnp.asarray(1e-3, dtype))
    tol = 10.0 * _MULTI_TILT * rmax

    dists = [dist0[0]]
    poss = [c0]
    valids = [base_hit]
    # the four tilt re-portals are independent: run them as ONE vmapped
    # MPR (4x fewer sequential portal loops — the dominant cost of the
    # multi-contact path at large batches)
    tilt_spec = ((0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0))
    us = jnp.stack([tangents[a] for a, _ in tilt_spec])
    angs = jnp.asarray([sg * _MULTI_TILT for _, sg in tilt_spec], dtype)
    rots = jax.vmap(lambda u, a: _axis_angle_mat(u, a, dtype))(us, angs)
    p2rs = c0 + jnp.einsum('kij,j->ki', rots, p2 - c0)
    m2rs = jnp.einsum('kij,jl->kil', rots, m2)
    dks, pks, _ = jax.vmap(
        lambda p2r, m2r: base(p1, m1, s1, p2r, m2r, s2, v1, v2,
                              margin))(p2rs, m2rs)
    for ti, (axis_i, sign) in enumerate(tilt_spec):
      u = tangents[axis_i]
      ang = angs[ti]
      dk = dks[ti, 0]
      pk = pks[ti, 0]
      hit = dk < 1e9
      # first-order un-tilt: the geom1 witness never moved, the geom2
      # witness moved by the full rotation; the midpoint by half
      half = _axis_angle_mat(u, -0.5 * ang, dtype)
      pk_true = c0 + half @ (pk - c0)
      # gap along n opened by dot(displacement, n) at the contact point
      dk_true = dk - ang * jnp.dot(jnp.cross(u, pk_true - c0), n)
      # accept if tangentially distinct from every kept point
      dp = pk_true - c0
      dp_t = dp - n * jnp.dot(dp, n)
      distinct = math.norm(dp_t) > tol
      for j in range(1, len(poss)):
        dj = pk_true - poss[j]
        dj_t = dj - n * jnp.dot(dj, n)
        distinct &= (~valids[j]) | (math.norm(dj_t) > tol)
      ok = base_hit & hit & distinct
      dists.append(jnp.where(ok, dk_true, jnp.asarray(1e10, dtype)))
      poss.append(jnp.where(ok, pk_true, c0))
      valids.append(ok)

    dist = jnp.stack(dists)
    pos = jnp.stack(poss)
    frame = jnp.broadcast_to(frame0[0], (5, 3, 3))
    return dist, pos, frame

  return collide
