"""Host-side model compiler and host<->device transfer.

``put_model`` mirrors the reference's precomputation role
(mujoco_warp/_src/io.py:77-647): it validates supported features, converts
the C-compiled ``mujoco.MjModel`` into our pytree ``Model`` with structural
metadata baked into static tuples, and precomputes the kinematic-tree
levels, dof ancestry mask, and filtered collision pair lists.

MJCF ingestion deliberately stays on host via the ``mujoco`` package —
the reference makes the same call (SURVEY §3.2) and reusing the C model
compiler is the correct engineering choice on any backend. Only the
functions that take an ``MjModel`` import it, so stepping a Model (for
example one loaded from a ``snapshot``) needs only JAX and numpy.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

from . import types
from .types import Contact, Data, Model, Option, Statistic

if TYPE_CHECKING:
  import mujoco


def _tup(x) -> tuple:
  """numpy int array -> nested tuple of python ints (hashable static)."""
  a = np.asarray(x)
  if a.ndim == 1:
    return tuple(int(v) for v in a)
  return tuple(_tup(r) for r in a)


def _jp(x, dtype=None) -> jax.Array:
  a = np.asarray(x)
  if dtype is None:
    dtype = jnp.float32 if a.dtype.kind == 'f' else a.dtype
  return jnp.asarray(a, dtype=dtype)


# Feature subsets currently supported (grown over time; the reference keeps
# the same friendly-rejection policy, io.py:90-174).
_SUPPORTED_JOINTS = {0, 1, 2, 3}
_SUPPORTED_GEOMS = {
    types.GeomType.PLANE, types.GeomType.SPHERE, types.GeomType.CAPSULE,
    types.GeomType.ELLIPSOID, types.GeomType.CYLINDER, types.GeomType.BOX,
    types.GeomType.MESH, types.GeomType.HFIELD, types.GeomType.SDF,
}
_SUPPORTED_INTEGRATORS = {
    types.IntegratorType.EULER, types.IntegratorType.RK4,
    types.IntegratorType.IMPLICITFAST,
}
_SUPPORTED_SOLVERS = {types.SolverType.CG, types.SolverType.NEWTON}


def _validate(mjm: mujoco.MjModel):
  for jtype in set(mjm.jnt_type):
    if jtype not in _SUPPORTED_JOINTS:
      raise NotImplementedError(f'joint type {jtype} not supported')
  if mjm.opt.integrator not in _SUPPORTED_INTEGRATORS:
    raise NotImplementedError(
        f'integrator {mjm.opt.integrator} not supported')
  if mjm.opt.solver not in _SUPPORTED_SOLVERS:
    raise NotImplementedError(f'solver {mjm.opt.solver} not supported')
  if mjm.nflex:
    from . import flex as flex_mod
    flex_mod.validate(mjm)
  if mjm.nplugin:
    # geom (SDF) plugins only — the reference's envelope exactly
    # (ref io.py:132-139 rejects body/actuator/sensor plugins, then
    # io.py:415-442 keeps geom plugins for the SDF collider)
    if (mjm.body_plugin != -1).any():
      raise NotImplementedError('body plugins not supported')
    if (mjm.actuator_plugin != -1).any():
      raise NotImplementedError('actuator plugins not supported')
    if (mjm.sensor_plugin != -1).any():
      raise NotImplementedError('sensor plugins not supported')
    slot_names = _plugin_slot_names()
    for g in range(mjm.ngeom):
      p = int(mjm.geom_plugin[g])
      if p < 0:
        continue
      if mjm.geom_type[g] != types.GeomType.SDF:
        raise NotImplementedError(
            f'geom {g}: plugins are only supported on sdf geoms')
      name = slot_names.get(int(mjm.plugin[p]))
      if name is None:
        raise NotImplementedError(
            f'geom {g}: its plugin is not a registered SDF plugin '
            f'(collision_sdf.register_sdf_plugin); registered: '
            f'{sorted(slot_names.values())}')
  from . import sensor as sensor_mod
  for s in range(mjm.nsensor):
    if mjm.sensor_type[s] not in sensor_mod.SUPPORTED_SENSORS:
      raise NotImplementedError(
          f'sensor type {mjm.sensor_type[s]} not supported')


def _body_levels(parentid: np.ndarray) -> tuple[tuple[int, ...], ...]:
  """Group bodies 1..nbody-1 by tree depth for level-synchronous scans."""
  nbody = len(parentid)
  depth = np.zeros(nbody, dtype=int)
  for b in range(1, nbody):
    depth[b] = depth[parentid[b]] + 1
  levels = []
  for lvl in range(1, depth.max() + 1 if nbody > 1 else 1):
    ids = tuple(int(b) for b in np.nonzero(depth == lvl)[0])
    if ids:
      levels.append(ids)
  return tuple(levels)


def _dof_vpre_mask(mjm: mujoco.MjModel) -> np.ndarray:
  """(nv, nv) mask V: V[j, k] = 1 iff dof k contributes to the partial
  body velocity 'seen' by dof j when computing cdof_dot[j] =
  motion_cross(v_pre(j), cdof[j]) (C mj_comVel accumulation order):
  strict tree ancestors of j, EXCLUDING same-joint dofs — except a free
  joint's rotational dofs, which see their own joint's linear dofs.
  Turns the per-body com_vel scan into one matmul."""
  nv = mjm.nv
  V = np.zeros((nv, nv), dtype=np.float32)
  for j in range(nv):
    jnt_j = int(mjm.dof_jntid[j])
    k = int(mjm.dof_parentid[j])
    while k >= 0:
      same_joint = int(mjm.dof_jntid[k]) == jnt_j
      if not same_joint:
        V[j, k] = 1.0
      else:
        jt = int(mjm.jnt_type[jnt_j])
        dadr = int(mjm.jnt_dofadr[jnt_j])
        if jt == 0 and j - dadr >= 3 and k - dadr < 3:  # free: rot sees lin
          V[j, k] = 1.0
      k = int(mjm.dof_parentid[k])
  return V


def _dof_ancestry(dof_parentid: np.ndarray) -> tuple:
  """Per-dof ancestor chains (incl. self) and the dense (nv, nv) mask used
  to assemble qM from composite inertias with one masked einsum."""
  nv = len(dof_parentid)
  rows = []
  mask = np.zeros((nv, nv), dtype=np.float32)
  for i in range(nv):
    chain = []
    j = i
    while j >= 0:
      chain.append(int(j))
      mask[i, j] = 1.0
      j = int(dof_parentid[j])
    rows.append(tuple(reversed(chain)))
  return tuple(rows), mask


def geom_pair_key(t1: int, t2: int) -> tuple[int, int]:
  return (t1, t2) if t1 <= t2 else (t2, t1)


def _mesh_hulls(mjm: mujoco.MjModel) -> np.ndarray:
  """(nmesh, VMAX, 4) padded convex-hull vertices (xyz + valid flag) in
  geom frame. Uses the compiler's hull graph (mesh_graph vert_globalid)
  when present, else all vertices (reference gjk support walks the same
  hull via mesh_graph hill-climbing, collision_gjk.py:98)."""
  hulls = []
  for i in range(mjm.nmesh):
    vadr, vnum = int(mjm.mesh_vertadr[i]), int(mjm.mesh_vertnum[i])
    verts = mjm.mesh_vert[vadr:vadr + vnum]
    gadr = int(mjm.mesh_graphadr[i])
    if gadr >= 0:
      g = mjm.mesh_graph[gadr:]
      numvert = int(g[0])
      vert_globalid = g[2 + numvert:2 + 2 * numvert]
      verts = verts[vert_globalid]
    hulls.append(verts)
  if not hulls:
    return np.zeros((0, 1, 4), dtype=np.float32)
  vmax = max(len(h) for h in hulls)
  out = np.zeros((len(hulls), vmax, 4), dtype=np.float32)
  for i, h in enumerate(hulls):
    out[i, :len(h), :3] = h
    out[i, :len(h), 3] = 1.0
  return out


def _decimate_hulls(hulls: np.ndarray, vmax: int | None = None
                    ) -> np.ndarray:
  """Farthest-point-subsample each padded hull to <= vmax vertices.

  Used by the culled/compacted narrowphase path, where hull buffers are
  gathered per selected pair per world — full hulls (1000+ verts on the
  aloha/kitchen assets) would blow the gather. Decimation keeps the
  support function conservative-ish (slightly shrunken hull); contact
  error is bounded by the local hull coarsening. MJWT_HULL_MAX tunes it."""
  import os
  if vmax is None:
    vmax = int(os.environ.get('MJWT_HULL_MAX', 64))
  nmesh, v, _ = hulls.shape
  if v <= vmax:
    return hulls
  out = np.zeros((nmesh, vmax, 4), dtype=hulls.dtype)
  for i in range(nmesh):
    verts = hulls[i][hulls[i, :, 3] > 0, :3]
    n = len(verts)
    if n <= vmax:
      out[i, :n, :3] = verts
      out[i, :n, 3] = 1.0
      continue
    # farthest-point sampling seeded at the extreme-x vertex
    chosen = [int(np.argmax(verts[:, 0]))]
    dist = np.linalg.norm(verts - verts[chosen[0]], axis=1)
    for _ in range(vmax - 1):
      nxt = int(np.argmax(dist))
      chosen.append(nxt)
      dist = np.minimum(dist, np.linalg.norm(verts - verts[nxt], axis=1))
    out[i, :vmax, :3] = verts[chosen]
    out[i, :vmax, 3] = 1.0
  return out


def _pair_filter_matrices(mjm: mujoco.MjModel):
  """Vectorized (ngeom, ngeom) pair admissibility — the same predicate
  as _collision_pairs (contype/conaffinity, same-weld, parent-child,
  <exclude>), plus the explicit <pair> id matrix. O(ngeom^2) numpy, used
  for SAP precompute where the python double loop is too slow."""
  n = mjm.ngeom
  ct = mjm.geom_contype.astype(np.int64)
  ca = mjm.geom_conaffinity.astype(np.int64)
  affin = ((ct[:, None] & ca[None, :]) | (ct[None, :] & ca[:, None])) != 0
  bid = mjm.geom_bodyid
  weld = mjm.body_weldid[bid]
  ok = affin & (weld[:, None] != weld[None, :])
  if not (mjm.opt.disableflags & types.DisableBit.FILTERPARENT):
    wpar = mjm.body_weldid[mjm.body_parentid[mjm.body_weldid]][bid]
    par = ((wpar[:, None] == weld[None, :]) |
           (wpar[None, :] == weld[:, None]))
    par &= (weld[:, None] != 0) & (weld[None, :] != 0)
    ok &= ~par
  for s in mjm.exclude_signature:
    b1, b2 = int(s) >> 16, int(s) & 0xFFFF
    m1 = bid == b1
    m2 = bid == b2
    ok &= ~(m1[:, None] & m2[None, :])
    ok &= ~(m2[:, None] & m1[None, :])
  pairid = np.full((n, n), -1, np.int32)
  for p in range(mjm.npair):
    g1, g2 = int(mjm.pair_geom1[p]), int(mjm.pair_geom2[p])
    ok[g1, g2] = ok[g2, g1] = True
    pairid[g1, g2] = pairid[g2, g1] = p
  np.fill_diagonal(ok, False)
  return ok, pairid


_SAP_THRESHOLD_DEFAULT = 10_000


def _sap_precompute(mjm: mujoco.MjModel):
  """Auto-select the SAP broadphase when the filtered pair count makes
  the static NXN candidate list intractable (reference io.py:349-354:
  NXN below 250k pairs; our XLA NXN path pays per-candidate work every
  step, so the default threshold is lower, MJWT_SAP_THRESHOLD).

  Returns (sap_meta, leaves, nxn_candidates_or_None): None means 'use
  the static NXN path'."""
  import os
  from . import collision_sap
  from . import collision_primitive
  from . import collision_convex

  threshold = int(os.environ.get('MJWT_SAP_THRESHOLD',
                                 _SAP_THRESHOLD_DEFAULT))
  empty = ((), dict(sap_pairs=np.zeros((0, 2), np.int32),
                    sap_pairid=np.zeros((0,), np.int32)), None)
  n = mjm.ngeom
  if n < 2:
    return empty
  ok, pairid = _pair_filter_matrices(mjm)
  count = int(np.triu(ok, 1).sum())
  if count < threshold:
    return empty

  gtype = mjm.geom_type.astype(np.int32)
  # SAP handles primitive/convex families; hfield & SDF pairs need
  # per-geom static grids -> keep the NXN path for those models
  special = {int(types.GeomType.HFIELD), int(types.GeomType.SDF)}
  if any(int(t) in special for t in np.unique(gtype)):
    return empty

  ti = gtype[:, None]
  tj = gtype[None, :]
  kmin = np.minimum(ti, tj)
  kmax = np.maximum(ti, tj)
  iu = np.triu_indices(n, 1)
  present = sorted({(int(a), int(b))
                    for a, b in zip(kmin[iu][ok[iu]], kmax[iu][ok[iu]])})
  _PLANE = int(types.GeomType.PLANE)
  for key in present:
    supported = (key in collision_primitive.MAX_CONTACTS or
                 (key[0] in collision_convex.SUPPORT and
                  key[1] in collision_convex.SUPPORT) or
                 key[0] == _PLANE)
    if not supported:
      raise NotImplementedError(f'collision pair type {key} not supported')

  # plane pairs can't ride the sweep (a plane has no bounding interval,
  # geom_rbound = 0) — enumerate them statically like the NXN path
  plane_groups = []
  for (a, b) in [k for k in present if k[0] == _PLANE]:
    pl = np.nonzero(gtype == a)[0] if a == _PLANE else ()
    pairs = []
    for g1 in np.nonzero(gtype == _PLANE)[0]:
      for g2 in np.nonzero((gtype == b) & ok[g1])[0]:
        if int(g1) != int(g2):
          pairs.append((int(g1), int(g2), int(pairid[g1, g2])))
    if pairs:
      plane_groups.append((int(a), int(b), tuple(pairs)))
  present = [k for k in present if k[0] != _PLANE]

  # one (g1, g2, pairid) array slice per family, g1 carrying type1
  # (collider argument order), concatenated into the sap_pairs leaf
  fam_rows, fam_pids, families = [], [], []
  start = 0
  for (a, b) in present:
    mask = np.triu(ok, 1) & ((kmin == a) & (kmax == b))
    i1, i2 = np.nonzero(mask)
    swap = gtype[i1] != a
    g1 = np.where(swap, i2, i1).astype(np.int32)
    g2 = np.where(swap, i1, i2).astype(np.int32)
    fam_rows.append(np.stack([g1, g2], axis=1))
    fam_pids.append(pairid[i1, i2])
    families.append((int(a), int(b), start, int(len(i1))))
    start += len(i1)

  meta = collision_sap.SapMeta(
      families=tuple(families), plane_groups=tuple(plane_groups))
  leaves = dict(
      sap_pairs=(np.concatenate(fam_rows, 0) if fam_rows
                 else np.zeros((0, 2), np.int32)),
      sap_pairid=(np.concatenate(fam_pids, 0).astype(np.int32)
                  if fam_pids else np.zeros((0,), np.int32)))
  return meta, leaves, count


def _collision_pairs(mjm: mujoco.MjModel):
  """Static broadphase precompute: filtered geom pair list grouped by
  (type1, type2) with MuJoCo's contype/conaffinity, same-weld,
  parent-child, and <exclude> filters (reference io.py:269-302)."""
  from . import collision_primitive  # late import to avoid cycle

  from . import collision_convex

  filterparent = not (mjm.opt.disableflags
                      & types.DisableBit.FILTERPARENT)
  exclude_sigs = set(int(s) for s in mjm.exclude_signature)
  # explicit <pair> contacts bypass all filters and carry their own
  # parameters (reference io.py pair handling; C mj_collision)
  explicit = {}
  for p in range(mjm.npair):
    g1, g2 = int(mjm.pair_geom1[p]), int(mjm.pair_geom2[p])
    t1, t2 = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
    if t1 > t2:
      g1, g2, t1, t2 = g2, g1, t2, t1
    explicit[(g1, g2)] = p
  weld = mjm.body_weldid
  weld_parent = mjm.body_weldid[mjm.body_parentid[weld]]
  groups: dict[tuple[int, int], list] = {}
  npairs = 0
  for g1 in range(mjm.ngeom):
    for g2 in range(g1 + 1, mjm.ngeom):
      t1_, t2_ = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
      gk = (g1, g2) if t1_ <= t2_ else (g2, g1)
      if gk in explicit:
        continue  # handled below with pair params
      b1, b2 = int(mjm.geom_bodyid[g1]), int(mjm.geom_bodyid[g2])
      w1, w2 = int(weld[b1]), int(weld[b2])
      if w1 == w2:
        continue
      if filterparent and w1 != 0 and w2 != 0 and (
          int(weld_parent[b1]) == w2 or int(weld_parent[b2]) == w1):
        continue
      sig = ((b1 << 16) + b2) if b1 < b2 else ((b2 << 16) + b1)
      if sig in exclude_sigs:
        continue
      mask = (mjm.geom_contype[g1] & mjm.geom_conaffinity[g2]) or (
          mjm.geom_contype[g2] & mjm.geom_conaffinity[g1])
      if not mask:
        continue
      t1, t2 = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
      gg1, gg2 = (g1, g2) if t1 <= t2 else (g2, g1)
      key = geom_pair_key(t1, t2)
      hfield_ok = key[0] == types.GeomType.HFIELD and key[1] in (
          types.GeomType.SPHERE, types.GeomType.CAPSULE,
          types.GeomType.BOX, types.GeomType.ELLIPSOID,
          types.GeomType.CYLINDER)
      sdf_ok = types.GeomType.SDF in key and key[0] in (
          types.GeomType.PLANE, types.GeomType.SPHERE,
          types.GeomType.CAPSULE, types.GeomType.CYLINDER,
          types.GeomType.ELLIPSOID, types.GeomType.BOX,
          types.GeomType.MESH, types.GeomType.SDF)
      supported = (key in collision_primitive.MAX_CONTACTS or hfield_ok or
                   sdf_ok or
                   (key[0] in collision_convex.SUPPORT and
                    key[1] in collision_convex.SUPPORT))
      if not supported:
        raise NotImplementedError(
            f'collision pair type {key} not supported')
      groups.setdefault(key, []).append((gg1, gg2, -1))
      npairs += 1
  for (g1, g2), p in sorted(explicit.items()):
    t1, t2 = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
    key = geom_pair_key(t1, t2)
    hfield_ok = key[0] == types.GeomType.HFIELD
    supported = (key in collision_primitive.MAX_CONTACTS or hfield_ok or
                 (key[0] in collision_convex.SUPPORT and
                  key[1] in collision_convex.SUPPORT))
    if not supported:
      raise NotImplementedError(f'explicit pair type {key} not supported')
    groups.setdefault(key, []).append((g1, g2, p))
    npairs += 1
  pairs = tuple(
      (k[0], k[1], tuple(v)) for k, v in sorted(groups.items()))

  def _k(t1, t2):
    if t1 == types.GeomType.HFIELD:
      return 4  # collision_hfield._NCONH
    if (t1, t2) in collision_primitive.MAX_CONTACTS:
      return collision_primitive.MAX_CONTACTS[(t1, t2)]
    if types.GeomType.SDF in (t1, t2):
      return int(mjm.opt.sdf_initpoints)
    # MPR-routed convex pair: manifold slots depend on MULTICCD
    return collision_convex.manifold_ncon(t1, t2,
                                          int(mjm.opt.disableflags))

  ncand = sum(_k(t1, t2) * len(v) for t1, t2, v in pairs)
  return pairs, ncand


def _tendon_structure(mjm: mujoco.MjModel) -> tuple:
  """Static per-tendon wrap program (reference io.py:451-498 precomputes
  equivalent address lists). Entries:
    ('fixed', ((qposadr, dofadr, wrapadr), ...))          — joint tendon
    ('spatial', (op, ...)) with op one of
        ('site', siteid)
        ('geom', geomid, geomtype, side_siteid)           — wrap obstacle
        ('pulley', wrapadr)                               — branch divisor
  """
  out = []
  for t in range(mjm.ntendon):
    adr, num = int(mjm.tendon_adr[t]), int(mjm.tendon_num[t])
    wtypes = [int(w) for w in mjm.wrap_type[adr:adr + num]]
    if all(w == types.WrapType.JOINT for w in wtypes):
      joints = []
      for k in range(num):
        j = int(mjm.wrap_objid[adr + k])
        if mjm.jnt_type[j] not in (2, 3):  # slide/hinge only (C rule)
          raise NotImplementedError('fixed tendon on ball/free joint')
        joints.append((int(mjm.jnt_qposadr[j]), int(mjm.jnt_dofadr[j]),
                       adr + k))
      out.append(('fixed', tuple(joints)))
    else:
      ops = []
      for k in range(num):
        w = wtypes[k]
        objid = int(mjm.wrap_objid[adr + k])
        if w == types.WrapType.SITE:
          ops.append(('site', objid))
        elif w in (types.WrapType.SPHERE, types.WrapType.CYLINDER):
          side = int(mjm.wrap_prm[adr + k])  # side-site id, -1 if none
          ops.append(('geom', objid, int(mjm.geom_type[objid]), side))
        elif w == types.WrapType.PULLEY:
          ops.append(('pulley', adr + k))
        else:
          raise NotImplementedError(f'wrap type {w}')
      out.append(('spatial', tuple(ops)))
  return tuple(out)


def _sample_octree_grid(mjm: mujoco.MjModel, meshid: int,
                        res: int) -> tuple[np.ndarray, np.ndarray]:
  """Resample a compiled MuJoCo mesh octree SDF (mjm.oct_*) onto a dense
  res^3 voxel grid spanning the root AABB (reference collision_sdf.py
  find_oct + sample_volume_sdf read the octree per query; a dense grid
  turns every runtime query into one trilinear gather)."""
  root = int(mjm.mesh_octadr[meshid])
  aabb = np.asarray(mjm.oct_aabb).reshape(-1, 2, 3)
  child = np.asarray(mjm.oct_child).reshape(-1, 8)
  coeff = np.asarray(mjm.oct_coeff).reshape(-1, 8)
  center, half = aabb[root, 0], aabb[root, 1]
  lo, hi = center - half, center + half
  axes = [np.linspace(lo[k], hi[k], res) for k in range(3)]
  gx, gy, gz = np.meshgrid(*axes, indexing='ij')
  pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
  # clamp strictly inside the root so the descend stays in-box
  eps = 1e-6
  pts = np.clip(pts, lo + eps * (hi - lo), hi - eps * (hi - lo))

  node = np.full(len(pts), root, dtype=np.int64)
  for _ in range(24):  # octree depth bound
    vmin = aabb[node, 0] - aabb[node, 1]
    vmax = aabb[node, 0] + aabb[node, 1]
    coord = (pts - vmin) / np.maximum(vmax - vmin, 1e-12)
    is_leaf = (child[node] == -1).all(axis=1)
    oct_idx = ((coord[:, 0] >= 0.5).astype(np.int64) +
               2 * (coord[:, 1] >= 0.5).astype(np.int64) +
               4 * (coord[:, 2] >= 0.5).astype(np.int64))
    nxt = child[node, oct_idx]
    step = ~is_leaf & (nxt != -1)
    node = np.where(step, nxt + root, node)
    if not step.any():
      break
  vmin = aabb[node, 0] - aabb[node, 1]
  vmax = aabb[node, 0] + aabb[node, 1]
  t = (pts - vmin) / np.maximum(vmax - vmin, 1e-12)
  w = np.ones((len(pts), 8))
  for j in range(8):
    w[:, j] = ((t[:, 0] if j & 1 else 1 - t[:, 0]) *
               (t[:, 1] if j & 2 else 1 - t[:, 1]) *
               (t[:, 2] if j & 4 else 1 - t[:, 2]))
  vals = np.sum(w * coeff[node], axis=1)
  grid = vals.reshape(res, res, res).astype(np.float32)
  return grid, np.stack([center, half]).astype(np.float32)


def _voxel_chunk_dist(p, tri):                             # (P, 3), (F, 3, 3)
  a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
  ab, ac = b - a, c - a
  ap = p[:, None, :] - a[None, :, :]                # (P, F, 3)
  d1 = jnp.einsum('fi,pfi->pf', ab, ap)
  d2 = jnp.einsum('fi,pfi->pf', ac, ap)
  bp = p[:, None, :] - b[None, :, :]
  d3 = jnp.einsum('fi,pfi->pf', ab, bp)
  d4 = jnp.einsum('fi,pfi->pf', ac, bp)
  cp = p[:, None, :] - c[None, :, :]
  d5 = jnp.einsum('fi,pfi->pf', ab, cp)
  d6 = jnp.einsum('fi,pfi->pf', ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = jnp.maximum(va + vb + vc, 1e-20)
  v = jnp.clip(vb / denom, 0.0, 1.0)
  w = jnp.clip(vc / denom, 0.0, 1.0)
  # barycentric clamp fallback: project to edges/verts via clip chain
  v = jnp.where((d1 <= 0) & (d2 <= 0), 0.0, v)
  w = jnp.where((d1 <= 0) & (d2 <= 0), 0.0, w)
  v = jnp.where((d3 >= 0) & (d4 <= d3), 1.0, v)
  w = jnp.where((d3 >= 0) & (d4 <= d3), 0.0, w)
  v = jnp.where((d6 >= 0) & (d5 <= d6), 0.0, v)
  w = jnp.where((d6 >= 0) & (d5 <= d6), 1.0, w)
  e_ab = jnp.clip(jnp.where(jnp.abs(d1 - d3) > 1e-20,
                            d1 / jnp.maximum(d1 - d3, 1e-20), 0.0),
                  0.0, 1.0)
  on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  v = jnp.where(on_ab, e_ab, v)
  w = jnp.where(on_ab, 0.0, w)
  e_ac = jnp.clip(jnp.where(jnp.abs(d2 - d6) > 1e-20,
                            d2 / jnp.maximum(d2 - d6, 1e-20), 0.0),
                  0.0, 1.0)
  on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  v = jnp.where(on_ac, 0.0, v)
  w = jnp.where(on_ac, e_ac, w)
  e_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6),
                                          1e-20), 0.0, 1.0)
  on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
  v = jnp.where(on_bc, 1.0 - e_bc, v)
  w = jnp.where(on_bc, e_bc, w)
  closest = (a[None] + v[..., None] * ab[None] + w[..., None] * ac[None])
  dist = jnp.min(jnp.linalg.norm(p[:, None, :] - closest, axis=-1),
                 axis=1)
  # sign: +x ray crossing parity (Moller-Trumbore, watertight-ish)
  eps = 1e-12
  dirv = jnp.array([1.0, 0.0, 0.0], jnp.float32)
  pvec = jnp.cross(dirv, ac)                        # (F, 3)
  det = jnp.einsum('fi,fi->f', ab, pvec)
  inv = 1.0 / jnp.where(jnp.abs(det) < eps, 1.0, det)
  tvec = p[:, None, :] - a[None]
  u = jnp.einsum('pfi,fi->pf', tvec, pvec) * inv
  qvec = jnp.cross(tvec, ab[None])
  vv = jnp.einsum('pfi,i->pf', qvec, dirv) * inv
  tt = jnp.einsum('pfi,fi->pf', qvec, ac) * inv
  hit = ((jnp.abs(det) >= eps) & (u >= 0) & (vv >= 0) &
         (u + vv <= 1) & (tt > 0))
  crossings = jnp.sum(hit, axis=1)
  inside = (crossings % 2) == 1
  return jnp.where(inside, -dist, dist)


_VOXEL_JIT = None


def _voxel_chunk_jit():
  """One shared CPU-jitted voxel-distance program for ALL meshes
  (faces arrive padded to power-of-two buckets, so each bucket size
  compiles once instead of once per mesh)."""
  global _VOXEL_JIT
  if _VOXEL_JIT is None:
    _VOXEL_JIT = jax.jit(_voxel_chunk_dist, backend='cpu')
  return _VOXEL_JIT


def _voxelize_mesh_grid(mjm: mujoco.MjModel, meshid: int,
                        res: int) -> tuple[np.ndarray, np.ndarray]:
  """Signed-distance voxel grid for a plain (non-octree) mesh:
  unsigned distance to triangles, sign by +x ray-crossing parity.
  Heavy (res^3 x nface) — jitted on CPU and disk-cached by mesh hash."""
  import hashlib
  import os
  vadr, vnum = int(mjm.mesh_vertadr[meshid]), int(mjm.mesh_vertnum[meshid])
  fadr, fnum = int(mjm.mesh_faceadr[meshid]), int(mjm.mesh_facenum[meshid])
  verts = np.asarray(mjm.mesh_vert[vadr:vadr + vnum], np.float32)
  faces = np.asarray(mjm.mesh_face[fadr:fadr + fnum], np.int64)
  key = hashlib.sha1(verts.tobytes() + faces.tobytes() +
                     str(res).encode()).hexdigest()[:16]
  cache_dir = os.path.expanduser('~/.cache/mjwt_sdf')
  os.makedirs(cache_dir, exist_ok=True)
  cache = os.path.join(cache_dir, f'{key}.npz')
  if os.path.exists(cache):
    z = np.load(cache)
    return z['grid'], z['aabb']

  lo = verts.min(0)
  hi = verts.max(0)
  pad = 0.15 * (hi - lo).max() + 1e-4
  lo, hi = lo - pad, hi + pad
  center = 0.5 * (lo + hi)
  half = 0.5 * (hi - lo)
  axes = [np.linspace(lo[k], hi[k], res, dtype=np.float32)
          for k in range(3)]
  gx, gy, gz = np.meshgrid(*axes, indexing='ij')
  pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

  tri = verts[faces]                                  # (F, 3, 3)
  # pad the face count to a power-of-two bucket so every mesh in the
  # model shares ONE jitted distance program per bucket (23 per-mesh
  # CPU compiles took ~8 min on aloha_sdf; padded degenerate faces at
  # +1e6 never win the min and never cross the parity ray)
  fpad = max(128, 1 << int(np.ceil(np.log2(max(len(tri), 1)))))
  if fpad != len(tri):
    far = np.full((fpad - len(tri), 3, 3), 1e6, np.float32)
    tri = np.concatenate([tri, far], axis=0)

  fchunk = _voxel_chunk_jit()
  out = np.empty(len(pts), np.float32)
  step = 2048
  tri_dev = jnp.asarray(tri)
  npts = len(pts)
  if npts % step:                      # pad points to one static shape
    pts = np.concatenate(
        [pts, np.zeros((step - npts % step, 3), np.float32)])
  for i in range(0, npts, step):
    out[i:i + step] = np.asarray(
        fchunk(jnp.asarray(pts[i:i + step]), tri_dev))[:min(
            step, npts - i)]
  grid = out.reshape(res, res, res)
  aabb = np.stack([center, half]).astype(np.float32)
  np.savez(cache, grid=grid, aabb=aabb)
  return grid, aabb


def _plugin_slot_names() -> dict:
  """Global plugin-registry slot -> plugin name, for every name in the
  SDF plugin registry. The python bindings expose no slot->name API, so
  each registered name is probed by loading a one-instance model — the
  reference's own test registry learns slot ids the same way
  (ref test_data/collision_sdf/utils.py:44-70 register_sdf_plugins)."""
  import mujoco

  from . import collision_sdf
  out = {}
  for name in collision_sdf._SDF_PLUGINS:
    xml = (f'<mujoco><extension><plugin plugin="{name}">'
           f'<instance name="i0"/></plugin></extension></mujoco>')
    try:
      pm = mujoco.MjModel.from_xml_string(xml)
    except Exception:
      continue  # registered name not available in this mujoco build
    out[int(pm.plugin[0])] = name
  return out


def _geom_plugins(mjm: mujoco.MjModel):
  """Per-geom plugin names (static tuple, '' = none) + parsed float
  attribute table (ngeom, NPLUGINATTR). MuJoCo stores plugin config
  values as NUL-separated char strings in plugin_attr
  (ref io.py:415-442 parses the same buffer into vec_pluginattr)."""
  from . import collision_sdf
  names = [''] * mjm.ngeom
  attrs = np.zeros((max(mjm.ngeom, 1), collision_sdf.NPLUGINATTR),
                   np.float32)
  if mjm.nplugin == 0 or (mjm.geom_plugin == -1).all():
    return tuple(names), attrs
  slot_names = _plugin_slot_names()
  raw = np.asarray(mjm.plugin_attr).astype(np.uint8).tobytes()
  for g in range(mjm.ngeom):
    p = int(mjm.geom_plugin[g])
    if p < 0:
      continue
    names[g] = slot_names.get(int(mjm.plugin[p]), '')
    start = int(mjm.plugin_attradr[p])
    end = (int(mjm.plugin_attradr[p + 1]) if p + 1 < mjm.nplugin
           else len(raw))
    vals = []
    for tok in raw[start:end].split(b'\0'):
      tok = tok.strip()
      if not tok:
        continue
      try:
        vals.append(float(tok))
      except ValueError:
        vals.append(0.0)  # non-numeric config values have no SDF role
    k = min(len(vals), collision_sdf.NPLUGINATTR)
    attrs[g, :k] = vals[:k]
  return tuple(names), attrs


def _build_sdf_grids(mjm: mujoco.MjModel):
  """Voxel SDF grids for every mesh participating in an SDF collision
  pair. Returns (grids (n, R, R, R), aabbs (n, 2, 3), meshid->grid map)."""
  import os
  res = int(os.environ.get('MJWT_SDF_RES', 48))
  sdf_geoms = [g for g in range(mjm.ngeom)
               if mjm.geom_type[g] == types.GeomType.SDF]
  grid_of_mesh = [-1] * max(mjm.nmesh, 1)
  if not sdf_geoms:
    return (np.zeros((1, 1, 1, 1), np.float32),
            np.zeros((1, 2, 3), np.float32), grid_of_mesh)
  # meshes needing grids: every non-plugin SDF geom's mesh (a plugin
  # geom uses its analytic registered distance instead) + every plain
  # mesh that can pair with an SDF geom
  need = set()
  for g in sdf_geoms:
    if mjm.geom_dataid[g] >= 0 and mjm.geom_plugin[g] < 0:
      need.add(int(mjm.geom_dataid[g]))
  for g in range(mjm.ngeom):
    if (mjm.geom_type[g] != types.GeomType.MESH or
        mjm.geom_dataid[g] < 0):
      continue
    # only meshes whose contype/conaffinity can actually pair with an
    # SDF geom (voxelization is expensive)
    for h in sdf_geoms:
      if ((mjm.geom_contype[g] & mjm.geom_conaffinity[h]) or
          (mjm.geom_contype[h] & mjm.geom_conaffinity[g])):
        need.add(int(mjm.geom_dataid[g]))
        break
  if not need:  # all SDF geoms plugin-backed, no mesh partners
    return (np.zeros((1, 1, 1, 1), np.float32),
            np.zeros((1, 2, 3), np.float32), grid_of_mesh)
  grids, aabbs = [], []
  for meshid in sorted(need):
    if mjm.mesh_octadr[meshid] >= 0:
      grid, aabb = _sample_octree_grid(mjm, meshid, res)
    else:
      grid, aabb = _voxelize_mesh_grid(mjm, meshid, res)
    grid_of_mesh[meshid] = len(grids)
    grids.append(grid)
    aabbs.append(aabb)
  return (np.stack(grids), np.stack(aabbs), grid_of_mesh)


def _mesh_faces(mjm: mujoco.MjModel) -> tuple[np.ndarray, np.ndarray]:
  """Morton-clustered padded triangles + per-cluster AABBs for every
  mesh (bvh.py — the reference's mesh-BVH role, ref bvh.py:35,
  ray.py:701-799). Returns (faces (nmesh, cmax*CLUSTER, 3, 3),
  aabb (nmesh, cmax, 2, 3)). The flat face array doubles as the plain
  ray_mesh sweep input (padding triangles are degenerate zeros and
  never hit), so no second copy is stored."""
  from . import bvh
  if mjm.nmesh == 0:
    return (np.zeros((0, 1, 3, 3), dtype=np.float32),
            np.zeros((0, 1, 2, 3), dtype=np.float32))
  fmax = max(1, int(mjm.mesh_facenum.max()))
  cmax = (fmax + bvh.CLUSTER - 1) // bvh.CLUSTER
  out = np.zeros((mjm.nmesh, cmax * bvh.CLUSTER, 3, 3), dtype=np.float32)
  aabb = np.empty((mjm.nmesh, cmax, 2, 3), dtype=np.float32)
  for i in range(mjm.nmesh):
    fadr, fnum = int(mjm.mesh_faceadr[i]), int(mjm.mesh_facenum[i])
    faces = mjm.mesh_vert[mjm.mesh_vertadr[i] +
                          mjm.mesh_face[fadr:fadr + fnum]]
    out[i], aabb[i] = bvh.build_clusters(faces.astype(np.float32), cmax)
  return out, aabb


def _hfield_data(mjm: mujoco.MjModel) -> np.ndarray:
  """(nhfield, max_nrow, max_ncol) padded normalized height grids."""
  if mjm.nhfield == 0:
    return np.zeros((0, 1, 1), dtype=np.float32)
  rmax = int(mjm.hfield_nrow.max())
  cmax = int(mjm.hfield_ncol.max())
  out = np.zeros((mjm.nhfield, rmax, cmax), dtype=np.float32)
  for i in range(mjm.nhfield):
    nr, nc = int(mjm.hfield_nrow[i]), int(mjm.hfield_ncol[i])
    adr = int(mjm.hfield_adr[i])
    out[i, :nr, :nc] = mjm.hfield_data[adr:adr + nr * nc].reshape(nr, nc)
  return out


def put_model(mjm: mujoco.MjModel) -> Model:
  import mujoco
  _validate(mjm)
  _sdf_grids_cached = _build_sdf_grids(mjm)
  _geom_plugins_cached = _geom_plugins(mjm)
  _mesh_faces_cached = _mesh_faces(mjm)
  from . import flex as flex_mod
  flex_meta, flex_leaves = flex_mod.build(mjm)
  tactile_meta, tactile_leaves = _build_tactile(mjm)

  opt = Option(
      timestep=_jp(mjm.opt.timestep),
      tolerance=_jp(max(mjm.opt.tolerance, 1e-6)),  # f32 floor, ref io.py:182
      ls_tolerance=_jp(mjm.opt.ls_tolerance),
      gravity=_jp(mjm.opt.gravity),
      wind=_jp(mjm.opt.wind),
      magnetic=_jp(mjm.opt.magnetic),
      density=_jp(mjm.opt.density),
      viscosity=_jp(mjm.opt.viscosity),
      impratio=_jp(mjm.opt.impratio),
      o_margin=_jp(mjm.opt.o_margin),
      o_solref=_jp(mjm.opt.o_solref),
      o_solimp=_jp(mjm.opt.o_solimp),
      o_friction=_jp(mjm.opt.o_friction),
      integrator=int(mjm.opt.integrator),
      cone=int(mjm.opt.cone),
      solver=int(mjm.opt.solver),
      iterations=int(mjm.opt.iterations),
      ls_iterations=int(mjm.opt.ls_iterations),
      # parallel multi-alpha linesearch: ~6 fused kernels vs ~100 for the
      # iterative variant (the reference defaults to the iterative one,
      # solver.py:481 offers both). It exploits phi'
      # being piecewise-LINEAR, which the elliptic cone term breaks, so
      # elliptic models default to the iterative (safeguarded-Newton)
      # variant.
      ls_parallel=int(mjm.opt.cone) != int(types.ConeType.ELLIPTIC),
      sdf_iterations=int(mjm.opt.sdf_iterations),
      sdf_initpoints=int(mjm.opt.sdf_initpoints),
      disableflags=int(mjm.opt.disableflags),
      enableflags=int(mjm.opt.enableflags),
      run_collision_detection=True,
  )

  dof_ancestor_rows, ancestor_mask = _dof_ancestry(mjm.dof_parentid)

  # tree-sparse qM above the dense-viability cap (flex/cloth scale;
  # reference CSR qM path, io.py:575-635 — the reference itself rejects
  # dense above nv=60, io.py:142-144). Packed (nM,) storage +
  # level-scheduled LDL; see sparse.py.
  import logging as _logging
  import os as _os
  qm_meta = None
  if mjm.nv > int(_os.environ.get('MJWT_SPARSE_NV', '128')):
    # eligible only when no consumer needs a dense qM: the Newton
    # solver assembles a dense Hessian, implicitfast a dense qDeriv,
    # tendon armature a dense rank-update. Ineligible models keep the
    # dense path (works, just O(nv^2) memory — the reference makes the
    # same dense/sparse split on jacobian= and solver, io.py:142-144).
    eligible = (mjm.opt.solver == mujoco.mjtSolver.mjSOL_CG and
                mjm.opt.integrator !=
                mujoco.mjtIntegrator.mjINT_IMPLICITFAST and
                not (mjm.ntendon and np.any(mjm.tendon_armature)))
    if eligible:
      from . import sparse as sparse_mod
      qm_meta = sparse_mod.QMMeta(mjm.dof_parentid)
    else:
      _logging.getLogger(__name__).warning(
          'nv=%d exceeds MJWT_SPARSE_NV but the model is not eligible '
          'for sparse qM (needs solver="CG", non-implicitfast '
          'integrator, no tendon armature); using dense (nv, nv) '
          'storage', mjm.nv)

  # subtree mask: c in subtree(b) iff b is on c's parent chain (or c == b)
  nbody = mjm.nbody
  subtree_mask = np.zeros((nbody, nbody), dtype=np.float32)
  for c in range(nbody):
    b = c
    while b >= 0:
      subtree_mask[b, c] = 1.0
      if b == 0:
        break
      b = int(mjm.body_parentid[b])
  body_dof_mask = np.zeros((nbody, mjm.nv), dtype=np.float32)
  for b in range(nbody):
    bb = b
    while bb > 0:
      adr, num = int(mjm.body_dofadr[bb]), int(mjm.body_dofnum[bb])
      body_dof_mask[b, adr:adr + num] = 1.0
      bb = int(mjm.body_parentid[bb])
  sap_meta, sap_leaves, sap_count = _sap_precompute(mjm)
  if sap_meta:
    collision_pairs, nxn_candidates = (), sap_count
  else:
    collision_pairs, nxn_candidates = _collision_pairs(mjm)

  # static condim per pair drives the efc row layout
  condims = [1]
  if sap_meta:
    # vectorized condim mixing over the admissible-pair matrix
    ok, pidm = _pair_filter_matrices(mjm)
    pr = mjm.geom_priority.astype(np.int32)
    cd = mjm.geom_condim.astype(np.int32)
    mixed = np.where(pr[:, None] > pr[None, :], cd[:, None],
                     np.where(pr[None, :] > pr[:, None], cd[None, :],
                              np.maximum(cd[:, None], cd[None, :])))
    if mjm.npair:
      mixed = np.where(pidm >= 0, mjm.pair_dim[np.maximum(pidm, 0)], mixed)
    if ok.any():
      condims.append(int(mixed[ok].max()))
  for _, _, glist in collision_pairs:
    for g1, g2, pid in glist:
      if pid >= 0:
        condims.append(int(mjm.pair_dim[pid]))
      else:
        condims.append(_pair_condim(mjm, g1, g2))
  # flex contact candidates mix geom vs flex condim by priority
  for g, f in {(g, f) for g, _, f in flex_meta.plane_pairs} | {
      (g, f) for _, g, _, f in flex_meta.tri_pairs}:
    pg, pf = int(mjm.geom_priority[g]), int(mjm.flex_priority[f])
    if pg > pf:
      condims.append(int(mjm.geom_condim[g]))
    elif pf > pg:
      condims.append(int(mjm.flex_condim[f]))
    else:
      condims.append(max(int(mjm.geom_condim[g]), int(mjm.flex_condim[f])))
  condim_max = max(condims)

  mocap_bodies = np.nonzero(mjm.body_mocapid >= 0)[0]
  mocap_pos0 = mjm.body_pos[mocap_bodies] if len(
      mocap_bodies) else np.zeros((0, 3))
  mocap_quat0 = mjm.body_quat[mocap_bodies] if len(
      mocap_bodies) else np.zeros((0, 4))

  return Model(
      nq=mjm.nq, nv=mjm.nv, nu=mjm.nu, na=mjm.na, nbody=mjm.nbody,
      njnt=mjm.njnt, ngeom=mjm.ngeom, nsite=mjm.nsite, ncam=mjm.ncam,
      nlight=mjm.nlight, neq=mjm.neq, nmocap=mjm.nmocap,
      ngravcomp=mjm.ngravcomp, nsensor=mjm.nsensor,
      nsensordata=mjm.nsensordata, npair=mjm.npair, nexclude=mjm.nexclude,
      ntendon=mjm.ntendon, nwrap=mjm.nwrap,
      body_parentid=_tup(mjm.body_parentid),
      body_rootid=_tup(mjm.body_rootid),
      body_weldid=_tup(mjm.body_weldid),
      body_mocapid=_tup(mjm.body_mocapid),
      body_jntadr=_tup(mjm.body_jntadr),
      body_jntnum=_tup(mjm.body_jntnum),
      body_dofadr=_tup(mjm.body_dofadr),
      body_dofnum=_tup(mjm.body_dofnum),
      body_geomadr=_tup(mjm.body_geomadr),
      body_geomnum=_tup(mjm.body_geomnum),
      body_treeid=_tup(mjm.body_treeid),
      body_levels=_body_levels(mjm.body_parentid),
      jnt_type=_tup(mjm.jnt_type),
      jnt_qposadr=_tup(mjm.jnt_qposadr),
      jnt_dofadr=_tup(mjm.jnt_dofadr),
      jnt_bodyid=_tup(mjm.jnt_bodyid),
      jnt_limited=_tup(mjm.jnt_limited),
      jnt_actfrclimited=_tup(mjm.jnt_actfrclimited),
      jnt_actgravcomp=_tup(mjm.jnt_actgravcomp),
      dof_bodyid=_tup(mjm.dof_bodyid),
      dof_jntid=_tup(mjm.dof_jntid),
      dof_parentid=_tup(mjm.dof_parentid),
      dof_treeid=_tup(mjm.dof_treeid),
      dof_ancestor_rows=dof_ancestor_rows,
      dof_hasfrictionloss=_tup(mjm.dof_frictionloss > 0),
      geom_type=_tup(mjm.geom_type),
      geom_bodyid=_tup(mjm.geom_bodyid),
      geom_dataid=_tup(mjm.geom_dataid),
      geom_condim=_tup(mjm.geom_condim),
      geom_priority=_tup(mjm.geom_priority),
      site_bodyid=_tup(mjm.site_bodyid),
      site_type=_tup(mjm.site_type),
      cam_bodyid=_tup(mjm.cam_bodyid),
      cam_mode=_tup(mjm.cam_mode),
      cam_targetbodyid=_tup(mjm.cam_targetbodyid),
      cam_resolution=_tup(mjm.cam_resolution),
      light_bodyid=_tup(mjm.light_bodyid),
      light_mode=_tup(mjm.light_mode),
      light_targetbodyid=_tup(mjm.light_targetbodyid),
      eq_type=_tup(mjm.eq_type),
      eq_obj1id=_tup(mjm.eq_obj1id),
      eq_obj2id=_tup(mjm.eq_obj2id),
      eq_objtype=_tup(mjm.eq_objtype),
      actuator_trntype=_tup(mjm.actuator_trntype),
      actuator_dyntype=_tup(mjm.actuator_dyntype),
      actuator_gaintype=_tup(mjm.actuator_gaintype),
      actuator_biastype=_tup(mjm.actuator_biastype),
      actuator_trnid=_tup(mjm.actuator_trnid),
      actuator_actadr=_tup(mjm.actuator_actadr),
      actuator_actnum=_tup(mjm.actuator_actnum),
      actuator_ctrllimited=_tup(mjm.actuator_ctrllimited),
      actuator_forcelimited=_tup(mjm.actuator_forcelimited),
      actuator_actlimited=_tup(mjm.actuator_actlimited),
      actuator_actearly=_tup(mjm.actuator_actearly),
      tendon_adr=_tup(mjm.tendon_adr),
      tendon_num=_tup(mjm.tendon_num),
      tendon_limited=_tup(mjm.tendon_limited),
      tendon_hasfrictionloss=_tup(mjm.tendon_frictionloss > 0),
      tendon_structure=_tendon_structure(mjm),
      wrap_type=_tup(mjm.wrap_type),
      wrap_objid=_tup(mjm.wrap_objid),
      sensor_type=_tup(mjm.sensor_type),
      sensor_datatype=_tup(mjm.sensor_datatype),
      sensor_objtype=_tup(mjm.sensor_objtype),
      sensor_objid=_tup(mjm.sensor_objid),
      sensor_reftype=_tup(mjm.sensor_reftype),
      sensor_refid=_tup(mjm.sensor_refid),
      sensor_adr=_tup(mjm.sensor_adr),
      sensor_dim=_tup(mjm.sensor_dim),
      sensor_needstage=_tup(mjm.sensor_needstage),
      sensor_intprm=_tup(getattr(mjm, 'sensor_intprm',
                                 np.zeros((mjm.nsensor, 1)))),
      collision_pairs=collision_pairs,
      nxn_candidates=nxn_candidates,
      condim_max=condim_max,
      pair_dim=_tup(mjm.pair_dim),
      has_damping=bool(np.any(mjm.dof_damping > 0)),
      has_tendon_armature=bool(np.any(
          getattr(mjm, 'tendon_armature', np.zeros(1)) > 0)),
      fluid_active=bool(mjm.opt.density > 0 or mjm.opt.viscosity > 0 or
                        np.any(mjm.opt.wind != 0)),
      body_fluid_ellipsoid=tuple(
          bool(np.any(mjm.geom_fluid[
              mjm.body_geomadr[b]:mjm.body_geomadr[b] +
              mjm.body_geomnum[b], 0] > 0))
          for b in range(mjm.nbody)),
      opt=opt,
      stat=Statistic(meaninertia=_jp(mjm.stat.meaninertia)),
      qpos0=_jp(mjm.qpos0),
      qpos_spring=_jp(mjm.qpos_spring),
      body_pos=_jp(mjm.body_pos),
      body_quat=_jp(mjm.body_quat),
      body_ipos=_jp(mjm.body_ipos),
      body_iquat=_jp(mjm.body_iquat),
      body_mass=_jp(mjm.body_mass),
      body_subtreemass=_jp(mjm.body_subtreemass),
      body_inertia=_jp(mjm.body_inertia),
      body_invweight0=_jp(mjm.body_invweight0),
      body_gravcomp=_jp(mjm.body_gravcomp),
      jnt_solref=_jp(mjm.jnt_solref),
      jnt_solimp=_jp(mjm.jnt_solimp),
      jnt_pos=_jp(mjm.jnt_pos),
      jnt_axis=_jp(mjm.jnt_axis),
      jnt_stiffness=_jp(mjm.jnt_stiffness),
      jnt_range=_jp(mjm.jnt_range),
      jnt_actfrcrange=_jp(mjm.jnt_actfrcrange),
      jnt_margin=_jp(mjm.jnt_margin),
      dof_solref=_jp(mjm.dof_solref),
      dof_solimp=_jp(mjm.dof_solimp),
      dof_frictionloss=_jp(mjm.dof_frictionloss),
      dof_armature=_jp(mjm.dof_armature),
      dof_damping=_jp(mjm.dof_damping),
      dof_invweight0=_jp(mjm.dof_invweight0),
      dof_M0=_jp(mjm.dof_M0),
      geom_pos=_jp(mjm.geom_pos),
      geom_quat=_jp(mjm.geom_quat),
      geom_size=_jp(mjm.geom_size),
      geom_fluid=_jp(mjm.geom_fluid),
      geom_friction=_jp(mjm.geom_friction),
      geom_solref=_jp(mjm.geom_solref),
      geom_solimp=_jp(mjm.geom_solimp),
      geom_solmix=_jp(mjm.geom_solmix),
      geom_margin=_jp(mjm.geom_margin),
      geom_gap=_jp(mjm.geom_gap),
      geom_rbound=_jp(mjm.geom_rbound),
      geom_aabb=_jp(mjm.geom_aabb.reshape(mjm.ngeom, 2, 3)
                    if mjm.ngeom else np.zeros((0, 2, 3))),
      site_pos=_jp(mjm.site_pos),
      site_quat=_jp(mjm.site_quat),
      site_size=_jp(mjm.site_size),
      cam_pos=_jp(mjm.cam_pos),
      cam_quat=_jp(mjm.cam_quat),
      cam_poscom0=_jp(mjm.cam_poscom0),
      cam_pos0=_jp(mjm.cam_pos0),
      cam_mat0=_jp(mjm.cam_mat0.reshape(mjm.ncam, 3, 3)),
      cam_fovy=_jp(mjm.cam_fovy),
      light_pos=_jp(mjm.light_pos),
      light_dir=_jp(mjm.light_dir),
      light_poscom0=_jp(mjm.light_poscom0),
      light_pos0=_jp(mjm.light_pos0),
      light_dir0=_jp(mjm.light_dir0),
      eq_solref=_jp(mjm.eq_solref),
      eq_solimp=_jp(mjm.eq_solimp),
      eq_data=_jp(mjm.eq_data),
      eq_active0=_jp(mjm.eq_active0, dtype=bool),
      actuator_dynprm=_jp(mjm.actuator_dynprm),
      actuator_gainprm=_jp(mjm.actuator_gainprm),
      actuator_biasprm=_jp(mjm.actuator_biasprm),
      actuator_ctrlrange=_jp(mjm.actuator_ctrlrange),
      actuator_forcerange=_jp(mjm.actuator_forcerange),
      actuator_actrange=_jp(mjm.actuator_actrange),
      actuator_gear=_jp(mjm.actuator_gear),
      actuator_cranklength=_jp(mjm.actuator_cranklength),
      actuator_acc0=_jp(mjm.actuator_acc0),
      actuator_lengthrange=_jp(mjm.actuator_lengthrange),
      actuator_length0=_jp(mjm.actuator_length0),
      tendon_solref_lim=_jp(mjm.tendon_solref_lim),
      tendon_solimp_lim=_jp(mjm.tendon_solimp_lim),
      tendon_solref_fri=_jp(mjm.tendon_solref_fri),
      tendon_solimp_fri=_jp(mjm.tendon_solimp_fri),
      tendon_length0=_jp(mjm.tendon_length0),
      tendon_range=_jp(mjm.tendon_range),
      tendon_margin=_jp(mjm.tendon_margin),
      tendon_stiffness=_jp(mjm.tendon_stiffness),
      tendon_damping=_jp(mjm.tendon_damping),
      tendon_armature=_jp(getattr(mjm, 'tendon_armature',
                                  np.zeros(mjm.ntendon))),
      tendon_frictionloss=_jp(mjm.tendon_frictionloss),
      tendon_lengthspring=_jp(mjm.tendon_lengthspring),
      tendon_invweight0=_jp(mjm.tendon_invweight0),
      wrap_prm=_jp(mjm.wrap_prm),
      pair_solref=_jp(mjm.pair_solref),
      pair_solreffriction=_jp(mjm.pair_solreffriction),
      pair_solimp=_jp(mjm.pair_solimp),
      pair_margin=_jp(mjm.pair_margin),
      pair_gap=_jp(mjm.pair_gap),
      pair_friction=_jp(mjm.pair_friction),
      exclude_signature=_jp(mjm.exclude_signature, dtype=jnp.int32),
      sensor_cutoff=_jp(mjm.sensor_cutoff),
      mocap_pos0=_jp(mocap_pos0),
      mocap_quat0=_jp(mocap_quat0),
      nkey=mjm.nkey,
      nmesh=mjm.nmesh,
      mesh_hullvert=_jp(_mesh_hulls(mjm)),
      mesh_hullvert_small=_jp(_decimate_hulls(_mesh_hulls(mjm))),
      mesh_faces=_jp(_mesh_faces_cached[0]),
      mesh_cluster_aabb=_jp(_mesh_faces_cached[1]),
      sdf_grids=_jp(_sdf_grids_cached[0]),
      sdf_grid_aabb=_jp(_sdf_grids_cached[1]),
      sdf_grid_of_mesh=_tup(_sdf_grids_cached[2]),
      geom_plugin=_geom_plugins_cached[0],
      geom_plugin_attr=_jp(_geom_plugins_cached[1]),
      nhfield=mjm.nhfield,
      hfield_nrow=_tup(mjm.hfield_nrow),
      hfield_ncol=_tup(mjm.hfield_ncol),
      hfield_data=_jp(_hfield_data(mjm)),
      hfield_size=_jp(mjm.hfield_size),
      key_time=_jp(mjm.key_time),
      key_qpos=_jp(mjm.key_qpos),
      key_qvel=_jp(mjm.key_qvel),
      key_act=_jp(mjm.key_act),
      key_ctrl=_jp(mjm.key_ctrl),
      key_mpos=_jp(mjm.key_mpos.reshape(mjm.nkey, -1, 3) if mjm.nkey
                   else np.zeros((0, mjm.nmocap, 3))),
      key_mquat=_jp(mjm.key_mquat.reshape(mjm.nkey, -1, 4) if mjm.nkey
                    else np.zeros((0, mjm.nmocap, 4))),
      dof_ancestor_mask=_jp(ancestor_mask),
      body_subtree_mask=_jp(subtree_mask),
      body_dof_ancestor_mask=_jp(body_dof_mask),
      dof_vpre_mask=_jp(_dof_vpre_mask(mjm)),
      flex_meta=flex_meta,
      tactile_meta=tactile_meta,
      sap_meta=sap_meta,
      qm_meta=qm_meta,
      **{k: (_jp(v, dtype=jnp.int32) if v.dtype.kind == 'i' else _jp(v))
         for k, v in {**flex_leaves, **tactile_leaves,
                      **sap_leaves}.items()},
  )


def _build_tactile(mjm: mujoco.MjModel) -> tuple:
  """Taxel tables for TACTILE sensors (reference io.py:553-561
  taxel_vertadr/taxel_sensorid; sensor kernel sensor.py:2122). Each
  sensor's taxels are the vertices of its mesh (objid), attached to its
  geom (refid); candidate touching geoms are enumerated statically by
  contype/conaffinity vs the sensor geom."""
  import mujoco
  _TACTILE = int(mujoco.mjtSensor.mjSENS_TACTILE)
  sensors = [s for s in range(mjm.nsensor)
             if int(mjm.sensor_type[s]) == _TACTILE]
  if not sensors:
    z = np.zeros
    return (), dict(taxel_pos=z((0, 3), np.float32),
                    taxel_normal=z((0, 3), np.float32),
                    taxel_tang=z((0, 2, 3), np.float32))

  # geom types with an analytic SDF for the depth query (collision_sdf
  # _primitive_sdf); mesh "other" geoms need a voxel grid — reject for
  # now (same policy as other unsupported-feature validation)
  sdf_ok = {0, 2, 3, 4, 5, 6}   # plane sphere capsule ellipsoid cyl box
  meta, pos_l, nrm_l, tan_l = [], [], [], []
  t0 = 0
  for s in sensors:
    mesh = int(mjm.sensor_objid[s])
    g = int(mjm.sensor_refid[s])
    va, vn = int(mjm.mesh_vertadr[mesh]), int(mjm.mesh_vertnum[mesh])
    na, nn = int(mjm.mesh_normaladr[mesh]), int(mjm.mesh_normalnum[mesh])
    verts = np.asarray(mjm.mesh_vert[va:va + vn], np.float32)
    has_frame = nn == 3 * vn
    if has_frame:
      nrm = np.asarray(mjm.mesh_normal[na:na + 3 * vn:3], np.float32)
      t1 = np.asarray(mjm.mesh_normal[na + 1:na + 3 * vn:3], np.float32)
      t2 = np.asarray(mjm.mesh_normal[na + 2:na + 3 * vn:3], np.float32)
      tang = np.stack([t1, t2], axis=1)
    elif nn == vn:
      nrm = np.asarray(mjm.mesh_normal[na:na + vn], np.float32)
      tang = np.zeros((vn, 2, 3), np.float32)
    else:
      # shared-normal meshes: fall back to radial-from-centroid normals
      c = verts.mean(axis=0)
      nrm = verts - c
      nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                             1e-12)
      tang = np.zeros((vn, 2, 3), np.float32)
    # candidate other geoms: affinity-filtered, not welded to the sensor
    pw = int(mjm.body_weldid[mjm.geom_bodyid[g]])
    groups: dict[int, list[int]] = {}
    for og in range(mjm.ngeom):
      if int(mjm.body_weldid[mjm.geom_bodyid[og]]) == pw:
        continue
      ok = ((int(mjm.geom_contype[g]) & int(mjm.geom_conaffinity[og])) or
            (int(mjm.geom_contype[og]) & int(mjm.geom_conaffinity[g])))
      if not ok:
        continue
      gt = int(mjm.geom_type[og])
      if gt not in sdf_ok:
        raise NotImplementedError(
            f'tactile sensor vs geom type {gt} not supported')
      groups.setdefault(gt, []).append(og)
    meta.append((s, g, t0, vn, bool(has_frame),
                 tuple((gt, tuple(gs)) for gt, gs in sorted(groups.items()))))
    pos_l.append(verts)
    nrm_l.append(nrm.astype(np.float32))
    tan_l.append(tang.astype(np.float32))
    t0 += vn
  return tuple(meta), dict(taxel_pos=np.concatenate(pos_l, 0),
                           taxel_normal=np.concatenate(nrm_l, 0),
                           taxel_tang=np.concatenate(tan_l, 0))


def _pair_condim(mjm: mujoco.MjModel, g1: int, g2: int) -> int:
  """Static condim for a geom pair (priority rules, mj_contactParam)."""
  p1, p2 = int(mjm.geom_priority[g1]), int(mjm.geom_priority[g2])
  if p1 > p2:
    return int(mjm.geom_condim[g1])
  if p2 > p1:
    return int(mjm.geom_condim[g2])
  return max(int(mjm.geom_condim[g1]), int(mjm.geom_condim[g2]))


# ---------------------------------------------------------------------------
# efc row layout (static; see constraint.py for assembly)
# ---------------------------------------------------------------------------


def efc_layout(m: Model, nconmax: int):
  """Static efc row layout: (ne, nf, nl, contact row stride, njmax).

  Unlike the reference's per-world atomic row allocation
  (constraint.py:2209), rows live at fixed addresses with an active mask —
  the XLA-native formulation (no dynamic shapes, no atomics)."""
  ne = 0
  for i in range(m.neq):
    etype = types.EqType(m.eq_type[i])
    if etype == types.EqType.FLEX:
      # one row per edge of the flex (reference constraint.py:677)
      ne += m.flex_meta.edgenum[m.eq_obj1id[i]]
    else:
      ne += {types.EqType.CONNECT: 3, types.EqType.WELD: 6,
             types.EqType.JOINT: 1, types.EqType.TENDON: 1}[etype]
  nf = sum(m.dof_hasfrictionloss) + sum(m.tendon_hasfrictionloss)
  nl = sum(1 for i in range(m.njnt) if m.jnt_limited[i]) + sum(
      1 for t in range(m.ntendon) if m.tendon_limited[t])
  if m.opt.cone == types.ConeType.PYRAMIDAL:
    stride = max(2 * (m.condim_max - 1), 1)
  else:
    stride = m.condim_max
  njmax = ne + nf + nl + nconmax * stride
  return ne, nf, nl, stride, njmax


def _moment0(m: Model) -> jax.Array:
  """Initial actuator_moment. For scalar-joint transmission the moment
  matrix is CONSTANT (one-hot x gear), so make_data prefills it. All
  other transmissions get zeros and smooth.transmission fills them per
  step."""
  from .types import JointType, TrnType
  nu, nv = m.nu, m.nv
  if nu == 0:
    return jnp.zeros((nu, nv), jnp.float32)
  simple = all(
      m.actuator_trntype[u] == TrnType.JOINT and
      m.jnt_type[m.actuator_trnid[u][0]] in (JointType.SLIDE,
                                             JointType.HINGE)
      for u in range(nu))
  if not simple:
    return jnp.zeros((nu, nv), jnp.float32)
  try:
    gear = np.asarray(jax.device_get(m.actuator_gear))
  except Exception:  # traced/batched Model leaf: fall back to zeros
    return jnp.zeros((nu, nv), jnp.float32)
  if gear.ndim != 2:
    return jnp.zeros((nu, nv), jnp.float32)
  gear0 = gear[:, 0]
  moment = np.zeros((nu, nv), np.float32)
  for u in range(nu):
    moment[u, int(m.jnt_dofadr[m.actuator_trnid[u][0]])] = gear0[u]
  return jnp.asarray(moment)


def make_data(m: Model, nconmax: int | None = None,
              njmax: int | None = None) -> Data:
  """Allocate a single-world Data at qpos0 (vmap this and put_model's output
  stays shared). nconmax defaults mirror the reference ladder heuristic
  (io.py:664-688) in spirit: enough for the static candidate count.

  Overflow semantics: if more than nconmax candidates hit in a step, the
  nconmax deepest are kept and the rest dropped; ``d.ncollision`` counts
  all hits while ``d.ncon`` counts the kept ones, so
  ``ncollision > ncon`` signals contact overflow (the reference warns
  in-kernel, forward.py:192-210 — here the counters are the signal).

  njmax: optional row budget check. The static efc layout derived from
  nconmax already guarantees capacity, so njmax cannot change the
  allocation; a value below the static requirement is an error (the
  requested budget would be silently exceeded)."""
  from . import collision_flex
  ncand = m.nxn_candidates + collision_flex.n_candidates(m)
  if nconmax is None:
    nconmax = max(min(ncand, 64), 1)
  nconmax = max(nconmax, 1)
  if m.ngeom == 0 or ncand == 0:
    nconmax = 0      # no candidate pairs: no contacts possible
  _, _, _, _, njmax_actual = efc_layout(m, nconmax)
  if njmax is not None and njmax < njmax_actual:
    raise ValueError(
        f'njmax={njmax} is below the static efc row requirement '
        f'{njmax_actual} for nconmax={nconmax}; rows live at fixed '
        f'addresses so the budget cannot be honored — raise njmax or '
        f'lower nconmax')
  nv, nq, nu, na, nbody = m.nv, m.nq, m.nu, m.na, m.nbody
  f = jnp.float32
  z = lambda *s: jnp.zeros(s, dtype=f)
  zi = lambda *s: jnp.zeros(s, dtype=jnp.int32)

  contact = Contact(
      dist=z(nconmax), pos=z(nconmax, 3), frame=z(nconmax, 3, 3),
      includemargin=z(nconmax), friction=z(nconmax, 5),
      solref=z(nconmax, 2), solreffriction=z(nconmax, 2),
      solimp=z(nconmax, 5), dim=zi(nconmax), geom=-jnp.ones(
          (nconmax, 2), dtype=jnp.int32), efc_address=-jnp.ones(
              (nconmax,), dtype=jnp.int32),
      vert=-jnp.ones((nconmax, 3), dtype=jnp.int32), vertw=z(nconmax, 3))

  d = Data(
      time=z(), energy=z(2), ncon=zi(), ne=zi(), nf=zi(), nl=zi(),
      nefc=zi(), ncollision=zi(), solver_niter=zi(),
      qpos=m.qpos0, qvel=z(nv), act=z(na), ctrl=z(nu),
      qacc_warmstart=z(nv),
      mocap_pos=m.mocap_pos0.astype(f), mocap_quat=m.mocap_quat0.astype(f),
      qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
      eq_active=m.eq_active0,
      xpos=z(nbody, 3), xquat=z(nbody, 4), xmat=z(nbody, 3, 3),
      xipos=z(nbody, 3), ximat=z(nbody, 3, 3),
      xanchor=z(m.njnt, 3), xaxis=z(m.njnt, 3),
      geom_xpos=z(m.ngeom, 3), geom_xmat=z(m.ngeom, 3, 3),
      site_xpos=z(m.nsite, 3), site_xmat=z(m.nsite, 3, 3),
      cam_xpos=z(m.ncam, 3), cam_xmat=z(m.ncam, 3, 3),
      light_xpos=z(m.nlight, 3), light_xdir=z(m.nlight, 3),
      subtree_com=z(nbody, 3), cinert=z(nbody, 10), cdof=z(nv, 6),
      crb=z(nbody, 10), cvel=z(nbody, 6), cdof_dot=z(nv, 6),
      cacc=z(nbody, 6), cfrc_int=z(nbody, 6), cfrc_ext=z(nbody, 6),
      subtree_linvel=z(nbody, 3), subtree_angmom=z(nbody, 3),
      qM=(z(m.qm_meta.nM) if m.qm_meta is not None else z(nv, nv)),
      qLD=(z(m.qm_meta.nM) if m.qm_meta is not None else z(nv, nv)),
      actuator_length=z(nu), actuator_moment=_moment0(m),
      actuator_velocity=z(nu), actuator_force=z(nu), act_dot=z(na),
      ten_length=z(m.ntendon), ten_J=z(m.ntendon, nv),
      ten_velocity=z(m.ntendon),
      flexvert_xpos=z(m.flex_meta.nvert, 3),
      flexedge_length=z(m.flex_meta.nedge),
      flexedge_velocity=z(m.flex_meta.nedge),
      qfrc_spring=z(nv), qfrc_damper=z(nv), qfrc_gravcomp=z(nv),
      qfrc_fluid=z(nv), qfrc_passive=z(nv), qfrc_bias=z(nv),
      qfrc_actuator=z(nv), qfrc_smooth=z(nv), qacc_smooth=z(nv),
      qfrc_constraint=z(nv), qfrc_inverse=z(nv), qacc=z(nv),
      contact=contact,
      efc_type=zi(njmax_actual), efc_id=zi(njmax_actual),
      efc_J=z(njmax_actual, nv), efc_pos=z(njmax_actual),
      efc_margin=z(njmax_actual), efc_D=z(njmax_actual),
      efc_vel=z(njmax_actual), efc_aref=z(njmax_actual),
      efc_frictionloss=z(njmax_actual), efc_force=z(njmax_actual),
      efc_active=jnp.zeros(njmax_actual, dtype=bool),
      sensordata=z(m.nsensordata),
  )
  return d


def put_data(mjm: mujoco.MjModel, mjd: mujoco.MjData, m: Model,
             nconmax: int | None = None) -> Data:
  """Copy one world of host MjData into a fresh Data."""
  d = make_data(m, nconmax=nconmax)
  f = jnp.float32
  d = d.replace(
      time=_jp(mjd.time, f), qpos=_jp(mjd.qpos), qvel=_jp(mjd.qvel),
      act=_jp(mjd.act), ctrl=_jp(mjd.ctrl),
      qacc_warmstart=_jp(mjd.qacc_warmstart),
      mocap_pos=_jp(mjd.mocap_pos), mocap_quat=_jp(mjd.mocap_quat),
      qfrc_applied=_jp(mjd.qfrc_applied),
      xfrc_applied=_jp(mjd.xfrc_applied),
      eq_active=_jp(mjd.eq_active, bool),
      qacc=_jp(mjd.qacc),
  )
  return d


def get_data_into(mjd: mujoco.MjData, m: Model, d: Data):
  """Copy one world of device Data back into host MjData (reference
  io.py:1243), including the active contacts (compacted into MjData's
  variable-size contact array so the native viewer can render them)."""
  ncon = int(d.ncon)
  # MjData contact array is resized by mj_forward; emulate by writing
  # into the existing buffer up to its capacity
  ncap = len(mjd.contact.dist) if hasattr(mjd.contact, 'dist') else 0
  nwrite = min(ncon, ncap) if ncap else 0
  for i in range(nwrite):
    mjd.contact.dist[i] = float(d.contact.dist[i])
    mjd.contact.pos[i] = np.asarray(d.contact.pos[i])
    mjd.contact.frame[i] = np.asarray(d.contact.frame[i]).reshape(-1)
    mjd.contact.geom[i] = np.asarray(d.contact.geom[i])
    mjd.contact.dim[i] = int(d.contact.dim[i])
    mjd.contact.friction[i] = np.asarray(d.contact.friction[i])
    mjd.contact.includemargin[i] = float(d.contact.includemargin[i])
  for name in ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qacc',
               'qacc_warmstart', 'mocap_pos', 'mocap_quat',
               'xpos', 'xquat', 'xipos', 'xanchor', 'xaxis',
               'geom_xpos', 'site_xpos', 'subtree_com', 'cdof', 'cvel',
               'qfrc_bias', 'qfrc_passive', 'qfrc_actuator',
               'qfrc_smooth', 'qacc_smooth', 'qfrc_constraint',
               'actuator_length', 'actuator_velocity', 'actuator_force',
               'sensordata'):
    val = np.asarray(getattr(d, name))
    tgt = getattr(mjd, name)
    if np.isscalar(tgt) or getattr(tgt, 'shape', ()) == ():
      setattr(mjd, name, float(val))
    else:
      tgt[...] = val.reshape(tgt.shape)
  for name, attr in (('xmat', 'xmat'), ('ximat', 'ximat'),
                     ('geom_xmat', 'geom_xmat'), ('site_xmat', 'site_xmat')):
    val = np.asarray(getattr(d, name))
    getattr(mjd, attr)[...] = val.reshape(getattr(mjd, attr).shape)


def reset_data(m: Model, d: Data, keyframe: int | None = None) -> Data:
  """Reset to qpos0 or a keyframe (the RL env-reset primitive;
  reference io.py:1458). Under vmap, combine with jnp.where masks for
  selective per-world reset (see reset_data_masked)."""
  fresh = make_data(m, nconmax=d.contact.dist.shape[0])
  if keyframe is not None:
    fresh = fresh.replace(
        time=m.key_time[keyframe], qpos=m.key_qpos[keyframe],
        qvel=m.key_qvel[keyframe], act=m.key_act[keyframe],
        ctrl=m.key_ctrl[keyframe],
        mocap_pos=m.key_mpos[keyframe], mocap_quat=m.key_mquat[keyframe])
  return fresh


def reset_data_masked(m: Model, batch: Data, reset_mask: jax.Array,
                      keyframe: int | None = None) -> Data:
  """Selective per-world reset: worlds where reset_mask is True return
  to the initial state, others keep flowing (the reference's
  reset=bitmask path, io.py:1458)."""
  nworld = batch.qpos.shape[0]
  fresh = reset_data(m, jax.tree_util.tree_map(lambda x: x[0], batch),
                     keyframe=keyframe)

  def mix(f, b):
    mask = reset_mask.reshape((nworld,) + (1,) * (b.ndim - 1))
    return jnp.where(mask, jnp.broadcast_to(f, b.shape), b)

  return jax.tree_util.tree_map(mix, fresh, batch)


def find_keys(mjm: mujoco.MjModel, prefix: str) -> list[int]:
  """Keyframe ids whose name starts with prefix (reference io.py:2591)."""
  import mujoco
  out = []
  for k in range(mjm.nkey):
    name = mujoco.mj_id2name(mjm, mujoco.mjtObj.mjOBJ_KEY, k)
    if name and name.startswith(prefix):
      out.append(k)
  return out


def make_trajectory(mjm: mujoco.MjModel, keys: list[int]) -> np.ndarray:
  """Stack keyframe ctrl rows into a (len(keys), nu) replay trajectory
  (reference io.py:2603)."""
  return np.stack([mjm.key_ctrl[k] for k in keys])


# ---------------------------------------------------------------------------
# override_model: string-path option overrides ("opt.solver=cg")
# (reference io.py:2498-2588 — shared by tests and CLIs)
# ---------------------------------------------------------------------------

_ENUM_FIELDS = {
    'solver': {'cg': types.SolverType.CG, 'newton': types.SolverType.NEWTON},
    'integrator': {'euler': types.IntegratorType.EULER,
                   'rk4': types.IntegratorType.RK4,
                   'implicitfast': types.IntegratorType.IMPLICITFAST},
    'cone': {'pyramidal': types.ConeType.PYRAMIDAL,
             'elliptic': types.ConeType.ELLIPTIC},
}
_FLAG_FIELDS = {
    'disableflags': types.DisableBit,
    'enableflags': types.EnableBit,
}
_INT_OPT = {'iterations', 'ls_iterations'}
_BOOL_OPT = {'ls_parallel', 'run_collision_detection'}


def override_model(m: Model, overrides: list[str] | str) -> Model:
  """Apply "opt.field=value" overrides; enum names, '|' flag unions,
  ints/floats and bools are parsed (reference io.py:2498)."""
  if isinstance(overrides, str):
    overrides = [overrides]
  opt = m.opt
  for ov in overrides:
    path, _, value = ov.partition('=')
    path = path.strip()
    value = value.strip()
    if not path.startswith('opt.'):
      raise ValueError(f'only opt.* overrides supported, got {path}')
    field = path[4:]
    if field in _ENUM_FIELDS:
      new = int(_ENUM_FIELDS[field][value.lower()])
      if field == 'cone':
        # keep the linesearch default consistent with the cone type
        # (parallel LS assumes piecewise-linear phi'; see put_model)
        opt = dataclasses.replace(
            opt, ls_parallel=new != int(types.ConeType.ELLIPTIC))
    elif field in _FLAG_FIELDS:
      enum_t = _FLAG_FIELDS[field]
      new = 0
      for part in value.split('|'):
        part = part.strip().upper()
        new |= int(enum_t[part])
    elif field in _INT_OPT:
      new = int(value)
    elif field in _BOOL_OPT:
      new = value.lower() in ('1', 'true', 'yes')
    elif hasattr(opt, field):
      cur = getattr(opt, field)
      vals = [float(v) for v in value.split()]
      new = jnp.asarray(vals[0] if len(vals) == 1 else vals,
                        dtype=jnp.float32)
      if hasattr(cur, 'shape') and cur.shape:
        new = jnp.broadcast_to(new, cur.shape)
    else:
      raise ValueError(f'unknown option {field}')
    opt = dataclasses.replace(opt, **{field: new})
  return dataclasses.replace(m, opt=opt)


def set_length_range(m: Model, mjm: mujoco.MjModel | None = None,
                     simulate: bool = False, **kwargs) -> Model:
  """Refresh Model.actuator_lengthrange (reference io.py:2465
  set_length_range; C mj_setLengthRange).

  Default (simulate=False) is the reference's own semantics: joint and
  tendon transmissions with limits copy the limit range scaled by gear
  (gear-sign aware); other actuators keep (0, 0). This path is pure
  device math — it works on vmapped/randomized Model batches (gear and
  ranges may be traced arrays).

  simulate=True runs C mj_setLengthRange instead (drives each actuator
  to its limits with the native engine — covers general transmissions,
  single model only; kwargs map to mjLROpt fields, requires mjm)."""
  if simulate:
    if mjm is None:
      raise ValueError('simulate=True needs the source MjModel')
    import mujoco
    opt = mujoco.MjLROpt()
    for k, v in kwargs.items():
      setattr(opt, k, v)
    mjd = mujoco.MjData(mjm)
    for u in range(mjm.nu):
      mujoco.mj_setLengthRange(mjm, mjd, u, opt)
    return dataclasses.replace(
        m, actuator_lengthrange=_jp(mjm.actuator_lengthrange))

  if m.nu == 0:
    return m
  from .types import TrnType
  gear0 = m.actuator_gear[..., :, 0]                   # (..., nu)
  lr = jnp.zeros(m.actuator_gear.shape[:-1] + (2,), gear0.dtype)
  for u in range(m.nu):
    trn = m.actuator_trntype[u]
    oid = m.actuator_trnid[u][0]
    if trn in (TrnType.JOINT, TrnType.JOINTINPARENT):
      if not m.jnt_limited[oid]:
        continue
      rng = m.jnt_range[..., oid, :]
    elif trn == TrnType.TENDON:
      if not m.tendon_limited[oid]:
        continue
      rng = m.tendon_range[..., oid, :]
    else:
      continue                    # site/body/slidercrank: no limit copy
    g = gear0[..., u]
    lo = jnp.where(g >= 0, rng[..., 0] * g, rng[..., 1] * g)
    hi = jnp.where(g >= 0, rng[..., 1] * g, rng[..., 0] * g)
    lr = lr.at[..., u, 0].set(lo).at[..., u, 1].set(hi)
  return dataclasses.replace(m, actuator_lengthrange=lr)


# ---------------------------------------------------------------------------
# set_const: on-device recompute of derived constants after mutating
# model parameters (domain randomization; reference io.py:2197-2465)
# ---------------------------------------------------------------------------


def set_const(m: Model) -> Model:
  """Recompute derived model constants after mass/inertia/geometry
  edits (reference io.py:2197-2465, C mj_setConst): body_subtreemass,
  dof_M0/meaninertia, dof/body/tendon invweight0, tendon_length0,
  actuator_acc0, cam/light reference poses, and position-actuator
  dampratio resolution — all on device via one forward pass at qpos0,
  enabling jit-able domain randomization."""
  from . import smooth
  from .types import JointType
  _hi = dict(precision=jax.lax.Precision.HIGHEST)
  subtreemass = jnp.einsum('bc,c->b', m.body_subtree_mask, m.body_mass,
                           **_hi)
  m = dataclasses.replace(m, body_subtreemass=subtreemass)
  if m.nv == 0:
    return m

  # forward pass at qpos0 to rebuild position-stage products
  d0 = make_data(m, nconmax=1)
  d0 = smooth.kinematics(m, d0)
  d0 = smooth.com_pos(m, d0)
  d0 = smooth.camlight(m, d0)
  d0 = smooth.tendon(m, d0)
  d0 = smooth.crb(m, d0)
  if m.qm_meta is not None:
    # init-time only: densify the packed values for the invweight
    # linear algebra below (the runtime never materializes this)
    from . import sparse as sparse_mod
    qM = sparse_mod.to_dense(m.qm_meta, d0.qM)
    d0 = d0.replace(qLD=sparse_mod.factor(m.qm_meta, d0.qM))
  else:
    d0 = d0.replace(qLD=jnp.linalg.cholesky(d0.qM))
    qM = d0.qM
  d0 = smooth.transmission(m, d0)
  dof_M0 = jnp.diagonal(qM)
  meaninertia = jnp.mean(dof_M0)

  # diag of A = M^-1 with per-joint averaging (reference
  # _finalize_dof_invweight0): FREE averages trans/rot triples, BALL
  # averages its 3 dofs, scalar joints take their own entry
  minv = jnp.linalg.inv(qM)
  a_diag = jnp.diagonal(minv)
  dof_invweight0 = a_diag
  for j in range(m.njnt):
    jt, dadr = m.jnt_type[j], m.jnt_dofadr[j]
    if jt == JointType.FREE:
      dof_invweight0 = dof_invweight0.at[dadr:dadr + 3].set(
          jnp.mean(a_diag[dadr:dadr + 3]))
      dof_invweight0 = dof_invweight0.at[dadr + 3:dadr + 6].set(
          jnp.mean(a_diag[dadr + 3:dadr + 6]))
    elif jt == JointType.BALL:
      dof_invweight0 = dof_invweight0.at[dadr:dadr + 3].set(
          jnp.mean(a_diag[dadr:dadr + 3]))

  # body_invweight0[b] = [mean diag of Jp M^-1 Jp^T, same for Jr] with
  # the body com Jacobian at xipos (reference _compute_body_jac_row /
  # _finalize_body_invweight0; welded bodies inherit their weld root)
  import numpy as np
  mask = m.body_dof_ancestor_mask                         # (nbody, nv)
  root_com = d0.subtree_com[np.asarray(m.body_rootid), :]
  offset = d0.xipos - root_com                            # (nbody, 3)
  jacr = d0.cdof[None, :, :3] * mask[:, :, None]          # (nbody, nv, 3)
  jacp = (d0.cdof[None, :, 3:] - jnp.cross(
      jnp.broadcast_to(offset[:, None, :], jacr.shape),
      d0.cdof[None, :, :3])) * mask[:, :, None]
  j6 = jnp.concatenate([jacp, jacr], axis=-1)             # (nbody, nv, 6)
  jm = jnp.einsum('bnr,nk->bkr', j6, minv, **_hi)
  a6 = jnp.einsum('bkr,bkr->br', jm, j6, **_hi)           # (nbody, 6)
  binv = jnp.stack([jnp.mean(a6[:, :3], axis=1),
                    jnp.mean(a6[:, 3:], axis=1)], axis=1)
  binv = binv[np.asarray(m.body_weldid), :]
  binv = binv.at[0].set(0.0)

  updates = dict(dof_M0=dof_M0, dof_invweight0=dof_invweight0,
                 body_invweight0=binv,
                 stat=dataclasses.replace(m.stat, meaninertia=meaninertia))

  if m.ntendon:
    tinv = jnp.einsum('tn,nk,tk->t', d0.ten_J, minv, d0.ten_J, **_hi)
    updates.update(tendon_invweight0=tinv, tendon_length0=d0.ten_length)

  if m.ncam:
    cb = np.asarray(m.cam_bodyid)
    updates.update(cam_pos0=d0.cam_xpos - d0.xpos[cb],
                   cam_poscom0=d0.cam_xpos - d0.subtree_com[cb],
                   cam_mat0=d0.cam_xmat)
  if m.nlight:
    lb = np.asarray(m.light_bodyid)
    updates.update(light_pos0=d0.light_xpos - d0.xpos[lb],
                   light_poscom0=d0.light_xpos - d0.subtree_com[lb],
                   light_dir0=d0.light_xdir)

  if m.nu:
    macc = jnp.einsum('un,nk->uk', d0.actuator_moment, minv, **_hi)
    acc0 = jnp.sqrt(jnp.sum(macc * macc, axis=1))
    updates['actuator_acc0'] = acc0
    # dampratio resolution (reference _resolve_dampratio): position
    # actuators with biasprm[2] = dampratio > 0 get biasprm[2] =
    # -dampratio * 2 sqrt(kp * reflected inertia)
    biasprm = m.actuator_biasprm
    for u in range(m.nu):
      if (m.actuator_biastype[u] == types.BiasType.AFFINE and
          float(np.asarray(m.actuator_biasprm[u, 2])) > 0):
        kp = m.actuator_gainprm[u, 0]
        mom = d0.actuator_moment[u]
        w = mom * mom
        denom = jnp.maximum(jnp.sum(w), 1e-12)
        refl = jnp.sum(w * dof_M0) / denom
        damp = -m.actuator_biasprm[u, 2] * 2.0 * jnp.sqrt(
            jnp.maximum(kp * refl, 0.0))
        biasprm = biasprm.at[u, 2].set(damp)
    updates['actuator_biasprm'] = biasprm

  return dataclasses.replace(m, **updates)
