"""Box-box multi-contact collision: SAT separating-axis search + the
MuJoCo contact-manifold enumeration (up to 8 contacts).

Branch-free JAX reformulation of C MuJoCo's mjc_BoxBox (the algorithm
the reference implements in mujoco_warp/_src/collision_primitive_core.py:648
box_box): every data-dependent branch becomes a mask, every candidate
contact gets a fixed slot with a validity flag, and the face/edge cases
are both evaluated and selected at the end — the shape XLA/vmap needs.

Returns 8 fixed contact slots; invalid slots carry dist = 1e10.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import math

_EPS = 1e-12
_BIG = 1e10

# rotmore permutation matrices indexed by face id (C mjc_BoxBox /
# reference _compute_rotmore): rotate the chosen face to +z
_ROTMORE = np.zeros((6, 3, 3), dtype=np.float32)
_ROTMORE[0, 0, 2], _ROTMORE[0, 1, 1], _ROTMORE[0, 2, 0] = -1, 1, 1
_ROTMORE[1, 0, 0], _ROTMORE[1, 1, 2], _ROTMORE[1, 2, 1] = 1, -1, 1
_ROTMORE[2, 0, 0], _ROTMORE[2, 1, 1], _ROTMORE[2, 2, 2] = 1, 1, 1
_ROTMORE[3, 0, 2], _ROTMORE[3, 1, 1], _ROTMORE[3, 2, 0] = 1, 1, -1
_ROTMORE[4, 0, 0], _ROTMORE[4, 1, 2], _ROTMORE[4, 2, 1] = 1, 1, -1
_ROTMORE[5, 0, 0], _ROTMORE[5, 1, 1], _ROTMORE[5, 2, 2] = -1, 1, -1



def _sel3(idx, a, b, c):
  """Static 3-way select by a traced index in {0,1,2} — compiles to two
  selects instead of a per-world gather."""
  return jnp.where(idx == 0, a, jnp.where(idx == 1, b, c))


def _sel6(idx, xs):
  out = xs[5]
  for k in range(4, -1, -1):
    out = jnp.where(idx == k, xs[k], out)
  return out


def _sat(pos21, pos12, rot21, rot21abs, s1, s2, margin):
  """Separating-axis scan in C's exact candidate order/semantics.
  Returns (fail, axis_code, clnorm, inv, cle1, cle2)."""
  rot12 = rot21.T
  rot12abs = rot21abs.T
  plen2 = rot21abs @ s2
  plen1 = rot12abs @ s1

  sep = margin + 3.0 * jnp.sum(s1 + s2)
  axis_code = jnp.int32(-1)
  fail = jnp.zeros((), bool)

  for i in range(3):
    c1 = -jnp.abs(pos21[i]) + s1[i] + plen2[i]
    c2 = -jnp.abs(pos12[i]) + s2[i] + plen1[i]
    fail = fail | (c1 < -margin) | (c2 < -margin)
    upd = c1 < sep
    axis_code = jnp.where(upd, i + 3 * (pos21[i] < 0).astype(jnp.int32),
                          axis_code)
    sep = jnp.where(upd, c1, sep)
    upd = c2 < sep
    axis_code = jnp.where(
        upd, i + 3 * (pos12[i] < 0).astype(jnp.int32) + 6, axis_code)
    sep = jnp.where(upd, c2, sep)

  clnorm = jnp.zeros(3, pos21.dtype)
  inv = jnp.zeros((), bool)
  cle1 = jnp.int32(0)
  cle2 = jnp.int32(0)

  for i in range(3):
    for j in range(3):
      if i == 0:
        cross = jnp.stack([jnp.zeros((), pos21.dtype), -rot12[j, 2],
                           rot12[j, 1]])
      elif i == 1:
        cross = jnp.stack([rot12[j, 2], jnp.zeros((), pos21.dtype),
                           -rot12[j, 0]])
      else:
        cross = jnp.stack([-rot12[j, 1], rot12[j, 0],
                           jnp.zeros((), pos21.dtype)])
      clen = math.norm(cross)
      ok = clen >= 1e-9
      clen_s = jnp.where(ok, clen, 1.0)
      axis = cross / clen_s
      box_dist = jnp.dot(pos21, axis)
      c3 = -jnp.abs(box_dist)
      for k in range(3):
        if k != i:
          c3 = c3 + s1[k] * jnp.abs(axis[k])
        if k != j:
          c3 = c3 + s2[k] * rot21abs[i, 3 - k - j] / clen_s
      fail = fail | (ok & (c3 < -margin))
      upd = ok & (c3 < sep * (1.0 - 1e-12))
      c1b = jnp.int32(0)
      c2b = jnp.int32(0)
      for k in range(3):
        if k != i:
          bit = (axis[k] > 0) ^ (box_dist < 0)
          c1b = c1b + jnp.where(bit, 1 << k, 0)
        if k != j:
          bit = ((rot21[i, 3 - k - j] > 0) ^ (box_dist < 0) ^
                 (((k - j + 3) % 3) == 1))
          c2b = c2b + jnp.where(bit, 1 << k, 0)
      sep = jnp.where(upd, c3, sep)
      axis_code = jnp.where(upd, 12 + i * 3 + j, axis_code)
      clnorm = jnp.where(upd, axis, clnorm)
      inv = jnp.where(upd, box_dist < 0, inv)
      cle1 = jnp.where(upd, c1b, cle1)
      cle2 = jnp.where(upd, c2b, cle2)

  fail = fail | (axis_code < 0)
  return fail, axis_code, clnorm, inv, cle1, cle2


def _face_case(axis_code, pos21, pos12, rot21, p1, m1, s1, p2, m2, s2,
               margin):
  """Face-separation manifold: enumerate edge-rect intersections,
  interior crossings and contained corners (C mjc_BoxBox face branch)."""
  dtype = pos21.dtype
  rot12 = rot21.T
  face_idx = jnp.clip(axis_code, 0, 11) % 6
  box_idx = jnp.clip(axis_code, 0, 11) // 6
  rotmore = _sel6(face_idx, [jnp.asarray(_ROTMORE[k], dtype)
                             for k in range(6)])
  bi = box_idx.astype(bool)

  r = rotmore @ jnp.where(bi, rot12, rot21)
  p = rotmore @ jnp.where(bi, pos12, pos21)
  ss = jnp.abs(rotmore @ jnp.where(bi, s2, s1))
  s_o = jnp.where(bi, s1, s2)                    # sizes of the other box
  rt = r.T
  lx, ly, hz = ss[0], ss[1], ss[2]
  p = p.at[2].add(-hz)

  clc_bits = [(r[2, i] < 0) for i in range(3)]
  lp = p
  for i in range(3):
    lp = lp + rt[i] * s_o[i] * jnp.where(clc_bits[i], 1.0, -1.0)

  # lateral directions of the incident face
  w = [jnp.abs(r[2, i]) < 0.5 for i in range(3)]
  wf = jnp.stack([wi.astype(dtype) for wi in w])
  dirs = jnp.sum(wf).astype(jnp.int32)
  cns = jnp.stack([rt[i] * s_o[i] * jnp.where(clc_bits[i], -2.0, 2.0)
                   for i in range(3)])           # (3, 3)
  idx = jnp.argsort(-wf)                         # true dirs first, stable
  cn1 = cns[idx[0]] * wf[idx[0]]
  cn2 = cns[idx[1]] * wf[idx[1]]
  dirs2 = dirs == 2

  cand_pts = []
  cand_valid = []

  # (a) incident-edge lines clipped against the rect edges: 16 slots
  lines = [(lp, cn1, dirs >= 1), (lp, cn2, dirs2),
           (lp + cn1, cn2, dirs2), (lp + cn2, cn1, dirs2)]
  for la, lb, lex in lines:
    for q in (0, 1):
      denom_ok = jnp.abs(lb[q]) > 1e-9
      br = 1.0 / jnp.where(denom_ok, lb[q], 1.0)
      for j in (-1.0, 1.0):
        l = ss[q] * j
        c1 = (l - la[q]) * br
        c2 = la[1 - q] + lb[1 - q] * c1
        valid = (lex & denom_ok & (c1 >= 0) & (c1 <= 1) &
                 (jnp.abs(c2) <= ss[1 - q]))
        cand_pts.append(la + c1 * lb)
        cand_valid.append(valid)

  # (b) rect corners inside the incident face parallelogram: 4 slots
  ax_, bx_ = cn1[0], cn2[0]
  ay_, by_ = cn1[1], cn2[1]
  det = ax_ * by_ - bx_ * ay_
  cdet = 1.0 / jnp.where(jnp.abs(det) < _EPS, 1.0, det)
  for i in range(4):
    llx = lx if i // 2 else -lx
    lly = ly if i % 2 else -ly
    x = llx - lp[0]
    y = lly - lp[1]
    u = (x * by_ - y * bx_) * cdet
    v = (y * ax_ - x * ay_) * cdet
    valid = dirs2 & (u > 0) & (v > 0) & (u < 1) & (v < 1)
    pt = jnp.stack([jnp.asarray(llx, dtype), jnp.asarray(lly, dtype),
                    lp[2] + u * cn1[2] + v * cn2[2]])
    cand_pts.append(pt)
    cand_valid.append(valid)

  # (c) incident-face corners inside the rect: 4 slots
  for i in range(4):
    exist = (i < 2) | dirs2
    tmpv = (lp + (i & 1) * cn1 +
            (1.0 if i & 2 else 0.0) * cn2)
    valid = exist & (tmpv[0] > -lx) & (tmpv[0] < lx) & (
        tmpv[1] > -ly) & (tmpv[1] < ly)
    cand_pts.append(tmpv)
    cand_valid.append(valid)

  pts = jnp.stack(cand_pts)                      # (24, 3)
  valid = jnp.stack(cand_valid) & (pts[:, 2] <= margin)
  depth = pts[:, 2]
  out_pts = pts.at[:, 2].multiply(0.5)

  rw = jnp.where(bi, m2, m1) @ rotmore.T
  pw = jnp.where(bi, p2, p1)
  normal = jnp.where(bi, -1.0, 1.0) * rw[:, 2]
  world = (out_pts.at[:, 2].add(hz)) @ rw.T + pw
  return depth, world, normal, valid


def _edge_case(axis_code, pos21, rot21, rot21abs, clnorm, inv, cle1, cle2,
               p1, m1, s1, s2, margin):
  """Edge-edge separation manifold (C mjc_BoxBox edge branch): clip the
  closest box2 face against box1's rect in the separating-normal
  projection."""
  dtype = pos21.dtype
  code = jnp.clip(axis_code - 12, 0, 8)
  edge1 = code // 3
  edge2 = code % 3
  rot12abs = rot21abs.T

  ax1 = 1 - (edge2 & 1)
  ax2 = 2 - (edge2 & 2)
  r21_e1 = _sel3(edge1, rot21abs[0], rot21abs[1], rot21abs[2])  # (3,)
  swap2 = _sel3(ax1, r21_e1[0], r21_e1[1], r21_e1[2]) < _sel3(
      ax2, r21_e1[0], r21_e1[1], r21_e1[2])
  ax1, ax2 = (jnp.where(swap2, ax2, ax1), jnp.where(swap2, ax1, ax2))

  pax1 = 1 - (edge1 & 1)
  pax2 = 2 - (edge1 & 2)
  r12_e2 = _sel3(edge2, rot12abs[0], rot12abs[1], rot12abs[2])
  swap1 = _sel3(pax1, r12_e2[0], r12_e2[1], r12_e2[2]) < _sel3(
      pax2, r12_e2[0], r12_e2[1], r12_e2[2])
  pax1, pax2 = (jnp.where(swap1, pax2, pax1), jnp.where(swap1, pax1, pax2))

  bit1 = (cle1 >> pax2) & 1
  rm_idx = jnp.where(bit1.astype(bool), pax2, pax2 + 3)
  rotmore = _sel6(rm_idx, [jnp.asarray(_ROTMORE[k], dtype)
                           for k in range(6)])

  p = rotmore @ pos21
  rnorm = rotmore @ clnorm
  r = rotmore @ rot21
  rt = r.T
  s = jnp.abs(rotmore.T @ s1)
  lx, ly, hz = s[0], s[1], s[2]
  p = p.at[2].add(-hz)

  sgn = lambda bits, a: jnp.where(((bits >> a) & 1).astype(bool), 1.0,
                                  -1.0)
  rt_ax1 = _sel3(ax1, rt[0], rt[1], rt[2])
  rt_ax2 = _sel3(ax2, rt[0], rt[1], rt[2])
  rt_e2 = _sel3(edge2, rt[0], rt[1], rt[2])
  s2_ax1 = _sel3(ax1, s2[0], s2[1], s2[2])
  s2_ax2 = _sel3(ax2, s2[0], s2[1], s2[2])
  s2_e2 = _sel3(edge2, s2[0], s2[1], s2[2])

  pt0 = p + rt_ax1 * s2_ax1 * sgn(cle2, ax1) + rt_ax2 * s2_ax2 * sgn(
      cle2, ax2)
  pt1 = pt0 - rt_e2 * s2_e2
  pt0 = pt0 + rt_e2 * s2_e2
  pt2 = p + rt_ax1 * s2_ax1 * (-sgn(cle2, ax1)) + rt_ax2 * s2_ax2 * sgn(
      cle2, ax2)
  pt3 = pt2 - rt_e2 * s2_e2
  pt2 = pt2 + rt_e2 * s2_e2
  quad = jnp.stack([pt0, pt1, pt2, pt3])         # (4, 3)

  axi_lp = quad[0]
  axi_cn1 = quad[1] - quad[0]
  axi_cn2 = quad[2] - quad[0]

  norm_ok = jnp.abs(rnorm[2]) >= 1e-9
  innorm = jnp.where(inv, -1.0, 1.0) / jnp.where(norm_ok, rnorm[2], 1.0)

  pu = quad
  c_scl = quad[:, 2] * jnp.where(inv, -1.0, 1.0) * innorm
  proj = quad - rnorm[None, :] * c_scl[:, None]

  pts_lp = proj[0]
  pts_cn1 = proj[1] - proj[0]
  pts_cn2 = proj[2] - proj[0]

  cand_pts = []
  cand_depth = []
  cand_valid = []

  # (a) projected quad edges clipped against the rect: 16 slots
  lines2 = [(pts_lp, pts_cn1, axi_lp, axi_cn1),
            (pts_lp, pts_cn2, axi_lp, axi_cn2),
            (pts_lp + pts_cn1, pts_cn2, axi_lp + axi_cn1, axi_cn2),
            (pts_lp + pts_cn2, pts_cn1, axi_lp + axi_cn2, axi_cn1)]
  for la2, lb2, lua, lub in lines2:
    for q in (0, 1):
      lb_q = lb2[q]
      denom_ok = jnp.abs(lb_q) > 1e-9
      br = 1.0 / jnp.where(denom_ok, lb_q, 1.0)
      for j in (-1.0, 1.0):
        l = s[q] * j
        c1 = (l - la2[q]) * br
        c2 = la2[1 - q] + lb2[1 - q] * c1
        zval = (lua[2] + lub[2] * c1) * innorm
        valid = (denom_ok & (c1 >= 0) & (c1 <= 1) &
                 (jnp.abs(c2) <= s[1 - q]) & (zval <= margin))
        pt = lua * 0.5 + c1 * lub * 0.5
        pt = pt.at[q].add(0.5 * l)
        pt = pt.at[1 - q].add(0.5 * c2)
        cand_pts.append(pt)
        cand_depth.append(pt[2] * innorm * 2.0)
        cand_valid.append(valid)
  nl = jnp.sum(jnp.stack(cand_valid).astype(jnp.int32))

  # (b) rect corners against the projected quad: 4 slots
  ax_, bx_ = pts_cn1[0], pts_cn2[0]
  ay_, by_ = pts_cn1[1], pts_cn2[1]
  det = ax_ * by_ - bx_ * ay_
  cdet = 1.0 / jnp.where(jnp.abs(det) < _EPS, 1.0, det)
  corner_valid = []
  for i in range(4):
    llx = lx if i // 2 else -lx
    lly = ly if i % 2 else -ly
    x = llx - pts_lp[0]
    y = lly - pts_lp[1]
    u = (x * by_ - y * bx_) * cdet
    v = (y * ax_ - x * ay_) * cdet
    inside_loose = ~(((u < 0) | (u > 1)) & ((v < 0) | (v > 1)))
    inside_strict = (u >= 0) & (v >= 0) & (u <= 1) & (v <= 1)
    accept = jnp.where(nl == 0, inside_loose, inside_strict)
    uc = jnp.clip(u, 0.0, 1.0)
    vc = jnp.clip(v, 0.0, 1.0)
    wc = 1.0 - uc - vc
    vtmp = pu[0] * wc + pu[1] * uc + pu[2] * vc
    pt = jnp.stack([jnp.asarray(llx, dtype), jnp.asarray(lly, dtype),
                    jnp.zeros((), dtype)])
    dvec = pt - vtmp
    tc1 = jnp.dot(dvec, dvec)
    accept = accept & ~((vtmp[2] > 0) & (tc1 > margin * margin))
    cand_pts.append(0.5 * (pt + vtmp))
    cand_depth.append(jnp.sqrt(tc1) * jnp.where(vtmp[2] < 0, -1.0, 1.0))
    corner_valid.append(accept)
    cand_valid.append(accept)
  nf = jnp.sum(jnp.stack(corner_valid).astype(jnp.int32))

  # (c) projected box2-face corners against the rect: 4 slots
  for i in range(4):
    x, y = pu[i, 0], pu[i, 1]
    inside_loose = ~(((x < -lx) | (x > lx)) & ((y < -ly) | (y > ly)))
    inside_strict = (x >= -lx) & (x <= lx) & (y >= -ly) & (y <= ly)
    accept = jnp.where((nl == 0) & (nf != 0), inside_loose, inside_strict)
    c1v = jnp.zeros((), dtype)
    tmp_p = jnp.stack([x, y, jnp.zeros((), dtype)])
    for jq in range(2):
      below = pu[i, jq] < -s[jq]
      above = pu[i, jq] > s[jq]
      c1v = c1v + jnp.where(below, (pu[i, jq] + s[jq]) ** 2,
                            jnp.where(above, (pu[i, jq] - s[jq]) ** 2,
                                      0.0))
      tmp_p = tmp_p.at[jq].set(jnp.where(below, -s[jq] * 0.5,
                                         jnp.where(above, s[jq] * 0.5,
                                                   tmp_p[jq])))
    c1v = c1v + (pu[i, 2] * innorm) ** 2
    accept = accept & ~((pu[i, 2] > 0) & (c1v > margin * margin))
    cand_pts.append((tmp_p + pu[i]) * 0.5)
    cand_depth.append(jnp.sqrt(c1v) * jnp.where(pu[i, 2] < 0, -1.0, 1.0))
    cand_valid.append(accept)

  pts = jnp.stack(cand_pts)
  depth = jnp.stack(cand_depth)
  valid = jnp.stack(cand_valid) & norm_ok

  rw = m1 @ rotmore.T
  normal = jnp.where(inv, -1.0, 1.0) * (rw @ rnorm)
  world = (pts.at[:, 2].add(hz)) @ rw.T + p1
  return depth, world, normal, valid


def box_box(p1, m1, s1, p2, m2, s2, margin=0.0):
  """Up to 8 contacts between two boxes. Returns (dist (8,),
  pos (8, 3), frame (8, 3, 3)); empty slots have dist = 1e10."""
  dtype = p1.dtype
  margin = jnp.asarray(margin, dtype)
  pos21 = m1.T @ (p2 - p1)
  pos12 = m2.T @ (p1 - p2)
  rot21 = m1.T @ m2
  rot21abs = jnp.abs(rot21)

  fail, axis_code, clnorm, inv, cle1, cle2 = _sat(
      pos21, pos12, rot21, rot21abs, s1, s2, margin)

  fd, fw, fn, fv = _face_case(axis_code, pos21, pos12, rot21, p1, m1, s1,
                              p2, m2, s2, margin)
  ed, ew, en, ev = _edge_case(axis_code, pos21, rot21, rot21abs, clnorm,
                              inv, cle1, cle2, p1, m1, s1, s2, margin)

  is_face = axis_code < 12
  # face path has 24 candidate slots, edge path 24 as well
  depth = jnp.where(is_face, fd, ed)
  world = jnp.where(is_face, fw, ew)
  normal = jnp.where(is_face, fn, en)
  valid = jnp.where(is_face, fv, ev) & ~fail

  # keep the 8 deepest valid candidates (C keeps the first 8 in
  # enumeration order; depth ordering is stabler under f32 and the
  # contact SET matches)
  key = jnp.where(valid, -depth, -jnp.inf)
  _, sel = jax.lax.top_k(key, 8)
  valid8 = valid[sel]
  dist = jnp.where(valid8, depth[sel], _BIG)
  pos = jnp.where(valid8[:, None], world[sel], 0.0)
  frame = jnp.broadcast_to(math.make_frame(normal)[None], (8, 3, 3))
  return dist, pos, frame
