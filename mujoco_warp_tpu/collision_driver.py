"""Collision pipeline: static filtered pair list -> vectorized
narrowphase -> mask compaction into the per-world contact pool.

Fixed-shape reformulation of the reference's driver
(mujoco_warp/_src/collision_driver.py): the pair list is filtered at
put_model time (io._collision_pairs), every candidate contact has a
static slot, and "allocation" is a prefix-sum scatter instead of a global
atomic cursor (reference collision_core.py:160). Broadphase culling
becomes a mask (candidates beyond bounding-sphere overlap produce
dist=+inf) rather than a variable-length pair queue: computing a cheap
candidate and masking keeps every shape static.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import collision_convex
from . import collision_primitive
from .types import Data, DisableBit, GeomType, Model


def _candidate_params(m: Model, g1s: np.ndarray, g2s: np.ndarray,
                      condims: np.ndarray, pairids: np.ndarray):
  """Mix contact parameters for each candidate pair; explicit <pair>
  candidates take their parameters from the pair tables
  (C mj_contactParam; reference collision_core.py:236)."""
  f1 = m.geom_friction[g1s]
  f2 = m.geom_friction[g2s]
  p1 = np.array([m.geom_priority[g] for g in g1s])
  p2 = np.array([m.geom_priority[g] for g in g2s])
  use1 = jnp.asarray(p1 > p2)
  use2 = jnp.asarray(p2 > p1)
  eq = jnp.asarray(p1 == p2)

  fmax = jnp.maximum(f1, f2)
  fr3 = jnp.where(eq[:, None], fmax, jnp.where(use1[:, None], f1, f2))
  friction = jnp.stack([fr3[:, 0], fr3[:, 0], fr3[:, 1], fr3[:, 2],
                        fr3[:, 2]], axis=1)

  solmix1 = m.geom_solmix[g1s]
  solmix2 = m.geom_solmix[g2s]
  denom = solmix1 + solmix2
  mix = jnp.where(denom > 1e-12, solmix1 / jnp.where(denom > 1e-12, denom,
                                                     1.0), 0.5)
  mix = jnp.where((solmix1 < 1e-12) & (solmix2 < 1e-12), 0.5, mix)
  mix = jnp.where((solmix1 < 1e-12) & (solmix2 >= 1e-12), 0.0, mix)
  mix = jnp.where((solmix2 < 1e-12) & (solmix1 >= 1e-12), 1.0, mix)
  mix = jnp.where(eq, mix, jnp.where(use1, 1.0, 0.0))

  sr1, sr2 = m.geom_solref[g1s], m.geom_solref[g2s]
  standard = (sr1[:, 0] > 0) & (sr2[:, 0] > 0)
  solref = jnp.where(standard[:, None], mix[:, None] * sr1 +
                     (1 - mix)[:, None] * sr2, jnp.minimum(sr1, sr2))
  si1, si2 = m.geom_solimp[g1s], m.geom_solimp[g2s]
  solimp = mix[:, None] * si1 + (1 - mix)[:, None] * si2

  margin = jnp.maximum(m.geom_margin[g1s], m.geom_margin[g2s])
  gap = jnp.maximum(m.geom_gap[g1s], m.geom_gap[g2s])
  solreffriction = jnp.zeros_like(solref)

  if (pairids >= 0).any():
    is_pair = jnp.asarray(pairids >= 0)
    pid = np.maximum(pairids, 0)
    friction = jnp.where(is_pair[:, None], m.pair_friction[pid], friction)
    solref = jnp.where(is_pair[:, None], m.pair_solref[pid], solref)
    solreffriction = jnp.where(is_pair[:, None],
                               m.pair_solreffriction[pid], solreffriction)
    solimp = jnp.where(is_pair[:, None], m.pair_solimp[pid], solimp)
    margin = jnp.where(is_pair, m.pair_margin[pid], margin)
    gap = jnp.where(is_pair, m.pair_gap[pid], gap)

  includemargin = margin - gap
  return (friction, solref, solreffriction, solimp, margin, includemargin,
          jnp.asarray(condims, dtype=jnp.int32))


# Cull/compaction pays per-world dynamic gathers: only worth it when
# narrowphase is expensive (MPR/mesh/SDF) or the group is enormous (terrain/kitchen).
_CULL_THRESHOLD = 64          # groups with costly colliders
_CULL_THRESHOLD_CHEAP = 2048  # pure-primitive groups


def _cull_k(nconmax: int, n: int) -> int:
  """Active-pair budget for a culled group: enough to fill the contact
  pool with headroom (reference SAP's per-world active-pair queue role,
  collision_driver.py:554)."""
  import os
  k = int(os.environ.get('MJWT_CULL_K', max(4 * nconmax, 64)))
  return min(n, k)


def make_pack(parts: list, dtype):
  """Build the parts-list packer shared by the static-NXN and SAP
  drivers: normalizes a group's collider outputs to flat rows."""
  def pack(dist_k, pos_k, frame_k, params, g1j, g2j, k, valid=None):
    n = g1j.shape[0]
    dist_f = dist_k.reshape(n * k)
    if valid is not None:
      vrep = jnp.repeat(valid, k)
      dist_f = jnp.where(vrep, dist_f, 1e10)
    rep = lambda x: jnp.repeat(x, k, axis=0) if k > 1 else x
    parts.append(dict(
        dist=dist_f.astype(dtype),
        pos=pos_k.reshape(n * k, 3),
        frame=frame_k.reshape(n * k, 3, 3),
        friction=rep(params[0]), solref=rep(params[1]),
        solreffriction=rep(params[2]), solimp=rep(params[3]),
        margin=rep(params[4]), includemargin=rep(params[5]),
        condim=rep(params[6]),
        g1=jnp.repeat(jnp.asarray(g1j, jnp.int32), k),
        g2=jnp.repeat(jnp.asarray(g2j, jnp.int32), k),
        vert=jnp.full((n * k, 3), -1, jnp.int32),
        vertw=jnp.zeros((n * k, 3), dtype)))
  return pack


def finalize(d: Data, parts: list, ncull_dropped, dtype) -> Data:
  """Candidate-pool compaction shared by the NXN and SAP drivers:
  top-K GATHER of active rows (a gather, not a scatter),
  overflow counted into ncollision (C mj_collision atomic-pool
  analogue, reference collision_core.py:160)."""
  con = d.contact
  nconmax = con.dist.shape[0]
  cat = lambda key: jnp.concatenate([p[key] for p in parts], axis=0)
  dist = cat('dist')
  pos = cat('pos')
  frame = cat('frame')
  friction = cat('friction')
  solref = cat('solref')
  solreffriction = cat('solreffriction')
  solimp = cat('solimp')
  margin = cat('margin')
  includemargin = cat('includemargin')
  condim = cat('condim')
  g12 = jnp.stack([cat('g1'), cat('g2')], axis=1)

  # inclusion rule: dist < margin (C mj_collision)
  active = dist < margin
  ncollision = jnp.sum(active.astype(jnp.int32)) + ncull_dropped
  ncand = dist.shape[0]
  idx_r = jnp.arange(ncand, dtype=jnp.int32)
  key = jnp.where(active, ncand - idx_r, -idx_r)
  _, sel = jax.lax.top_k(key, min(nconmax, ncand))
  sel_active = active[sel]
  ncon = jnp.minimum(jnp.sum(active.astype(jnp.int32)), nconmax)

  def take(vals, fill):
    out = jnp.where(
        sel_active.reshape((-1,) + (1,) * (vals.ndim - 1)),
        vals[sel], fill)
    if out.shape[0] < nconmax:  # pad up to pool size
      pad = jnp.broadcast_to(fill, (nconmax - out.shape[0],) + out.shape[1:])
      out = jnp.concatenate([out, pad], axis=0)
    return out

  new_con = con.replace(
      dist=take(dist, jnp.full((), 1e10, dtype)),
      pos=take(pos, jnp.zeros(3, dtype)),
      frame=take(frame, jnp.zeros((3, 3), dtype)),
      includemargin=take(includemargin, jnp.zeros((), dtype)),
      friction=take(friction, jnp.ones(5, dtype)),
      solref=take(solref, jnp.full(2, 0.02, dtype)),
      solreffriction=take(solreffriction, jnp.zeros(2, dtype)),
      solimp=take(solimp, jnp.full(5, 0.9, dtype)),
      dim=take(condim, jnp.ones((), jnp.int32)),
      geom=take(g12, -jnp.ones(2, jnp.int32)),
      vert=take(cat('vert'), -jnp.ones(3, jnp.int32)),
      vertw=take(cat('vertw'), jnp.zeros(3, dtype)),
  )
  return d.replace(contact=new_con, ncon=ncon, ncollision=ncollision)


def collision(m: Model, d: Data) -> Data:
  """Narrowphase over the static pair list + compaction
  (reference collision_driver.py:755).

  Groups larger than _CULL_THRESHOLD get a per-step bounding-sphere
  cull + top-K compaction first (the fixed-shape analogue of the
  reference's SAP broadphase, collision_driver.py:554-643): narrowphase
  then runs on K gathered pairs instead of every static candidate.
  Culled mesh pairs use decimated hulls (m.mesh_hullvert_small) so the
  per-world hull gather stays small. Overlaps beyond K are dropped and
  counted in ncollision (overflow observability).

  Models whose filtered pair count exceeds the SAP threshold dispatch
  to the sort-based sweep-and-prune driver instead (collision_sap.py;
  reference auto-selection io.py:349-354)."""
  from . import collision_flex
  con = d.contact
  nconmax = con.dist.shape[0]
  nflex_cand = collision_flex.n_candidates(m)
  if ((m.nxn_candidates == 0 and nflex_cand == 0) or nconmax == 0 or
      m.opt.disableflags & DisableBit.CONTACT):
    return d.replace(ncon=jnp.zeros((), jnp.int32))

  if m.sap_meta:
    from . import collision_sap
    return collision_sap.collision(m, d)

  dtype = d.qpos.dtype
  geom_dataid = np.asarray(m.geom_dataid)
  parts = []
  ncull_dropped = jnp.zeros((), jnp.int32)
  pack = make_pack(parts, dtype)

  for t1, t2, glist in m.collision_pairs:
    g1s = np.array([g for g, _, _ in glist])
    g2s = np.array([g for _, g, _ in glist])
    pids = np.array([p for _, _, p in glist])
    condims = np.array([_static_condim(m, g1, g2, p)
                        for g1, g2, p in glist])
    params = _candidate_params(m, g1s, g2s, condims, pids)

    if t1 == GeomType.HFIELD:
      # per-hfield-geom subgroups (static grid shape per collider)
      from . import collision_hfield
      k = collision_hfield._NCONH
      by_h = {}
      for idx, (g1, g2, pid) in enumerate(glist):
        by_h.setdefault(g1, []).append(idx)
      for g1, idxs in sorted(by_h.items()):
        idxs_np = np.asarray(idxs)
        g2sub = g2s[idxs_np]
        hid = m.geom_dataid[g1]
        fn = collision_hfield.hfield_collider(
            m, hid, m.hfield_nrow[hid], m.hfield_ncol[hid], t2)
        dist_k, pos_k, frame_k = jax.vmap(
            fn, in_axes=(None, None, None, 0, 0, 0))(
            d.geom_xpos[g1], d.geom_xmat[g1], m.hfield_size[hid],
            d.geom_xpos[g2sub], d.geom_xmat[g2sub], m.geom_size[g2sub])
        sub_params = tuple(pp[idxs_np] for pp in params)
        pack(dist_k, pos_k, frame_k, sub_params,
             np.full(len(idxs), g1), g2sub, k)
      continue

    if GeomType.SDF in (t1, t2):
      # SDF narrowphase: ONE traced descent program per (t1, t2)
      # family; per-pair voxel grids are vmapped arguments (per-mesh
      # closures multiplied the XLA program by the number of mesh-data
      # pairs — aloha_sdf's collision compile exceeded 10 minutes)
      from . import collision_sdf
      ninit = m.opt.sdf_initpoints
      iters = m.opt.sdf_iterations
      geom_dataid_np = np.asarray(m.geom_dataid)
      gom = np.asarray(m.sdf_grid_of_mesh)
      has1 = t1 in (GeomType.MESH, GeomType.SDF)
      has2 = t2 in (GeomType.MESH, GeomType.SDF)

      def grids_for(gs, has):
        if not has:
          return (jnp.zeros_like(m.sdf_grids[0]),
                  jnp.zeros_like(m.sdf_grid_aabb[0]), None, None)
        gi = gom[geom_dataid_np[gs]]
        if (gi < 0).any():
          raise NotImplementedError(
              f'no SDF grid for meshes {geom_dataid_np[gs][gi < 0]}')
        return m.sdf_grids[gi], m.sdf_grid_aabb[gi], 0, 0

      # partition by the (static) plugin-name pair: a registered geom
      # SDF plugin replaces the voxel grid with its analytic distance
      # (ref collision_sdf.py:798-844 dispatches on geom_plugin_index)
      pname = m.geom_plugin
      g1s_np, g2s_np = np.asarray(g1s), np.asarray(g2s)
      plug_keys = [(pname[a], pname[b]) for a, b in zip(g1s_np, g2s_np)]
      for pk in sorted(set(plug_keys)):
        idxs_np = np.array([i for i, q in enumerate(plug_keys) if q == pk],
                           np.int32)
        sub1, sub2 = g1s_np[idxs_np], g2s_np[idxs_np]
        sh1 = has1 and not pk[0]
        sh2 = has2 and not pk[1]
        g1v, g1a, ax1v, ax1a = grids_for(sub1, sh1)
        g2v, g2a, ax2v, ax2a = grids_for(sub2, sh2)
        fn = collision_sdf.sdf_pair_collider(
            m, t1, t2, 0 if sh1 else -1, 0 if sh2 else -1, ninit,
            iters, pk[0], pk[1])
        dist_k, pos_k, frame_k = jax.vmap(
            fn, in_axes=(0, 0, 0, 0, ax1v, ax1a, 0,
                         0, 0, 0, 0, ax2v, ax2a, 0))(
            d.geom_xpos[sub1], d.geom_xmat[sub1], m.geom_size[sub1],
            m.geom_aabb[sub1], g1v, g1a, m.geom_plugin_attr[sub1],
            d.geom_xpos[sub2], d.geom_xmat[sub2], m.geom_size[sub2],
            m.geom_aabb[sub2], g2v, g2a, m.geom_plugin_attr[sub2])
        sub_params = tuple(pp[idxs_np] for pp in params)
        pack(dist_k, pos_k, frame_k, sub_params, sub1, sub2, ninit)
      continue

    fn = collision_primitive.COLLIDERS.get((t1, t2))
    k = collision_primitive.MAX_CONTACTS.get((t1, t2), 1)
    needs_verts = GeomType.MESH in (t1, t2)
    is_mpr = fn is None
    if is_mpr:
      # generic convex fallback; multi-contact manifold where flat-on-
      # flat contact is possible (unless MULTICCD disabled)
      fn, k = collision_convex.collider(t1, t2, int(m.opt.disableflags))
    needs_margin = is_mpr or (t1, t2) in collision_primitive.NEEDS_MARGIN
    margin_arr = params[4]

    threshold = (_CULL_THRESHOLD if (is_mpr or needs_verts)
                 else _CULL_THRESHOLD_CHEAP)
    cull = len(glist) > threshold and t1 != GeomType.PLANE
    if cull:
      # bounding-sphere cull + closest-K compaction
      c1 = d.geom_xpos[g1s]
      c2 = d.geom_xpos[g2s]
      dvec = c1 - c2
      d2 = jnp.sum(dvec * dvec, axis=-1)
      rsum = m.geom_rbound[g1s] + m.geom_rbound[g2s] + margin_arr
      overlap = d2 <= rsum * rsum
      kk = _cull_k(nconmax, len(glist))
      key = jnp.where(overlap, -d2, -jnp.inf)
      _, sel = jax.lax.top_k(key, kk)
      valid = overlap[sel]
      ncull_dropped = ncull_dropped + jnp.maximum(
          0, jnp.sum(overlap.astype(jnp.int32)) - kk)
      g1j = jnp.take(jnp.asarray(g1s, jnp.int32), sel)
      g2j = jnp.take(jnp.asarray(g2s, jnp.int32), sel)
      args = [d.geom_xpos[g1j], d.geom_xmat[g1j], m.geom_size[g1j],
              d.geom_xpos[g2j], d.geom_xmat[g2j], m.geom_size[g2j]]
      if needs_verts or is_mpr:
        def hull_dyn(gj, t):
          if t != GeomType.MESH:
            return jnp.zeros((kk, 1, 4), m.mesh_hullvert_small.dtype)
          did = jnp.take(jnp.asarray(geom_dataid, jnp.int32), gj)
          return m.mesh_hullvert_small[did]
        args += [hull_dyn(g1j, t1), hull_dyn(g2j, t2)]
      if needs_margin:
        args.append(jnp.take(margin_arr, sel))
      dist_k, pos_k, frame_k = jax.vmap(fn)(*args)
      sel_params = tuple(jnp.take(pp, sel, axis=0) for pp in params)
      pack(dist_k, pos_k, frame_k, sel_params, g1j, g2j, k, valid=valid)
      continue

    args = [d.geom_xpos[g1s], d.geom_xmat[g1s], m.geom_size[g1s],
            d.geom_xpos[g2s], d.geom_xmat[g2s], m.geom_size[g2s]]
    if needs_verts or is_mpr:
      # hull vertex buffers for mesh geoms (zeros for non-mesh side)
      def hull(gs, t):
        if t != GeomType.MESH:
          return jnp.zeros((len(gs), 1, 4), m.mesh_hullvert.dtype)
        return m.mesh_hullvert[geom_dataid[gs]]
      args += [hull(g1s, t1), hull(g2s, t2)]
    if needs_margin:
      args.append(margin_arr)
    # one traced collider per type-pair group, vmapped over its pairs
    dist_k, pos_k, frame_k = jax.vmap(fn)(*args)
    pack(dist_k, pos_k, frame_k, params, g1s, g2s, k)

  # flex (deformable) candidates: plane-vertex + primitive-triangle
  # narrowphase (collision_flex.py), appended after rigid candidates so
  # the compaction keeps C's rigid-then-flex ordering
  if nflex_cand:
    parts.extend(collision_flex.candidate_parts(m, d, dtype))

  return finalize(d, parts, ncull_dropped, dtype)


def collide_pair(m: Model, d: Data, g1: int, g2: int, margin):
  """Narrowphase for one static geom pair outside the contact pipeline
  (used by geom-distance sensors): returns (dist, pos, frame) candidate
  arrays. Geoms are ordered by type like the driver."""
  t1, t2 = m.geom_type[g1], m.geom_type[g2]
  if t1 > t2:
    g1, g2, t1, t2 = g2, g1, t2, t1
  fn = collision_primitive.COLLIDERS.get((t1, t2))
  args = [d.geom_xpos[g1], d.geom_xmat[g1], m.geom_size[g1],
          d.geom_xpos[g2], d.geom_xmat[g2], m.geom_size[g2]]
  geom_dataid = m.geom_dataid
  if fn is None:
    fn = collision_convex.mpr(t1, t2)
    def hull(g, t):
      if t != GeomType.MESH:
        return jnp.zeros((1, 4), m.mesh_hullvert.dtype)
      return m.mesh_hullvert[geom_dataid[g]]
    args += [hull(g1, t1), hull(g2, t2), margin]
  elif GeomType.MESH in (t1, t2):
    args += [jnp.zeros((1, 4), m.mesh_hullvert.dtype)
             if t1 != GeomType.MESH else m.mesh_hullvert[geom_dataid[g1]],
             m.mesh_hullvert[geom_dataid[g2]]
             if t2 == GeomType.MESH else jnp.zeros(
                 (1, 4), m.mesh_hullvert.dtype)]
  return fn(*args)


def _static_condim(m: Model, g1: int, g2: int, pairid: int = -1) -> int:
  if pairid >= 0:
    return m.pair_dim[pairid]
  p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
  if p1 > p2:
    return m.geom_condim[g1]
  if p2 > p1:
    return m.geom_condim[g2]
  return max(m.geom_condim[g1], m.geom_condim[g2])
