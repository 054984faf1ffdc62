"""Flex (deformable) support: precompute, kinematics, passive forces.

Fixed-shape reformulation of the reference flex stack (reference
smooth.py:228-330 `_flex_vertices`/`_flex_edges`,
passive.py:567-746 `_flex_elasticity`/`_flex_bending`):

- The reference launches one thread per vertex/edge/element with inner
  loops over flex membership and per-body jacobian dofs. Here every
  quantity is a vectorized array op over static index tables baked at
  put_model time (vertex -> body, edge -> verts, element -> edges).
- Vertex velocities use the closed form v = b + a x (p - c) where
  a = sum_k mask*qvel_k*cdof_ang_k and b = sum_k mask*qvel_k*cdof_lin_k
  are two (nvert, nv) @ (nv, 3) mask matmuls instead of the
  reference's per-dof scalar loops (smooth.py:304-328).
- Force accumulation follows the reference's point-mass convention
  (passive.py:659-662: qfrc[body_dofadr + x] += F[x]), which assumes
  flex vertex bodies are pinned or carry 3 world-aligned slide dofs;
  put_model validates this.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .types import Data, DisableBit, Model

# local-edge endpoint tables per flex dim (reference passive.py:605-614)
_EDGE_TABLE = {
    1: ((0, 1),),
    2: ((1, 2), (2, 0), (0, 1)),
    3: ((0, 1), (1, 2), (2, 0), (2, 3), (0, 3), (1, 3)),
}


class FlexMeta(NamedTuple):
  """Static flex structure (hashable — lives in Model meta)."""
  nflex: int = 0
  nvert: int = 0
  nedge: int = 0
  nelem: int = 0
  dim: Tuple[int, ...] = ()
  vertadr: Tuple[int, ...] = ()
  vertnum: Tuple[int, ...] = ()
  edgeadr: Tuple[int, ...] = ()
  edgenum: Tuple[int, ...] = ()
  elemadr: Tuple[int, ...] = ()
  elemnum: Tuple[int, ...] = ()
  damping: Tuple[float, ...] = ()
  edge_equality: Tuple[bool, ...] = ()
  vert_bodyid: Tuple[int, ...] = ()
  vert_dofadr: Tuple[int, ...] = ()   # -1 = pinned (no dofs)
  centered: Tuple[bool, ...] = ()
  # collision params per flex (C mjModel flex_* contact fields)
  radius: Tuple[float, ...] = ()
  contype: Tuple[int, ...] = ()
  conaffinity: Tuple[int, ...] = ()
  condim: Tuple[int, ...] = ()
  priority: Tuple[int, ...] = ()
  solmix: Tuple[float, ...] = ()
  friction: Tuple[Tuple[float, ...], ...] = ()   # (nflex, 3)
  solref: Tuple[Tuple[float, ...], ...] = ()     # (nflex, 2)
  solimp: Tuple[Tuple[float, ...], ...] = ()     # (nflex, 5)
  margin: Tuple[float, ...] = ()
  gap: Tuple[float, ...] = ()
  # collision surface triangles (dim2 elements + dim3 shell faces),
  # GLOBAL vertex ids; empty for dim1 flexes
  tri: Tuple[Tuple[int, int, int], ...] = ()
  tri_flexid: Tuple[int, ...] = ()
  # filtered contact candidates (contype/conaffinity applied at build):
  plane_pairs: Tuple[Tuple[int, int, int], ...] = ()  # (geom, gvert, flex)
  tri_pairs: Tuple[Tuple[int, int, int, int], ...] = ()  # (gtype, geom, tri, flex)
  # static edge topology (numpy mirrors of the Model.flex_edge* leaves,
  # for use INSIDE jit traces — reading the traced leaves there crashes)
  edge: Tuple[Tuple[int, int], ...] = ()              # (nfe, 2) global ids
  edgeflap: Tuple[Tuple[int, int], ...] = ()          # (nfe, 2), -1 = none
  elem_enda: Tuple[Tuple[int, ...], ...] = ()         # (nel, maxe) verts
  elem_endb: Tuple[Tuple[int, ...], ...] = ()         # (nel, maxe) verts


def validate(mjm) -> None:
  """Reject flex features outside the supported envelope."""
  for f in range(mjm.nflex):
    if mjm.flex_interp[f] != 0:
      raise NotImplementedError('flex trilinear interpolation (nodal) '
                                'not supported')
  for v in range(mjm.nflexvert):
    b = int(mjm.flex_vertbodyid[v])
    dofnum = int(mjm.body_dofnum[b])
    if dofnum == 0:
      continue                         # pinned vertex
    if dofnum != 3:
      raise NotImplementedError(
          'flex vertex bodies must be pinned or have 3 slide dofs')
    jadr = int(mjm.body_jntadr[b])
    for k in range(3):
      if int(mjm.jnt_type[jadr + k]) != 2:       # mjJNT_SLIDE
        raise NotImplementedError('flex vertex joints must be slides')
    axes = mjm.jnt_axis[jadr:jadr + 3]
    if not np.allclose(axes, np.eye(3), atol=1e-9):
      raise NotImplementedError('flex vertex slide axes must be world '
                                'aligned (flexcomp convention)')
    if not np.allclose(mjm.body_quat[b], [1, 0, 0, 0], atol=1e-9):
      raise NotImplementedError('flex vertex bodies must be unrotated')


def build(mjm) -> tuple:
  """(FlexMeta, dict of Model array leaves) from an MjModel."""
  nflex = int(mjm.nflex)
  if not nflex:
    z = np.zeros
    leaves = dict(
        flex_edge=z((0, 2), np.int32), flex_edgeflap=z((0, 2), np.int32),
        flex_elem_edge=z((0, 1), np.int32),
        flex_elem_enda=z((0, 1), np.int32),
        flex_elem_endb=z((0, 1), np.int32),
        flex_stiffness=z((0, 21), np.float32),
        flex_bending=z((0, 17), np.float32),
        flexedge_length0=z((0,), np.float32),
        flexedge_invweight0=z((0,), np.float32),
        flex_vertlocal=z((0, 3), np.float32),
        flex_vert_bodyid=z((0,), np.int32),
        flex_vert_dofadr=z((0,), np.int32),
    )
    return FlexMeta(), leaves

  validate(mjm)
  nfv, nfe, nel = int(mjm.nflexvert), int(mjm.nflexedge), int(mjm.nflexelem)
  dims = tuple(int(d) for d in mjm.flex_dim)
  maxe = max(len(_EDGE_TABLE[d]) for d in dims)

  # global edge endpoints
  edge = np.zeros((nfe, 2), np.int32)
  for f in range(nflex):
    ea, en = int(mjm.flex_edgeadr[f]), int(mjm.flex_edgenum[f])
    va = int(mjm.flex_vertadr[f])
    edge[ea:ea + en] = mjm.flex_edge[ea:ea + en] + va

  # edge flap vertices (bending; -1 when absent)
  flap = -np.ones((nfe, 2), np.int32)
  for f in range(nflex):
    ea, en = int(mjm.flex_edgeadr[f]), int(mjm.flex_edgenum[f])
    va = int(mjm.flex_vertadr[f])
    fl = mjm.flex_edgeflap[ea:ea + en]
    valid = fl >= 0
    flap[ea:ea + en] = np.where(valid, fl + va, -1)

  # element -> local-edge -> (global edge id, global endpoints)
  elem_edge = np.zeros((nel, maxe), np.int32)
  elem_enda = np.zeros((nel, maxe), np.int32)
  elem_endb = np.zeros((nel, maxe), np.int32)
  for f in range(nflex):
    d = dims[f]
    et = _EDGE_TABLE[d]
    va = int(mjm.flex_vertadr[f])
    ea = int(mjm.flex_edgeadr[f])
    for le in range(len(et)):
      for k in range(int(mjm.flex_elemnum[f])):
        el = int(mjm.flex_elemadr[f]) + k
        dataadr = int(mjm.flex_elemdataadr[f]) + k * (d + 1)
        a, b = et[le]
        elem_enda[el, le] = int(mjm.flex_elem[dataadr + a]) + va
        elem_endb[el, le] = int(mjm.flex_elem[dataadr + b]) + va
        eadr = int(mjm.flex_elemedgeadr[f]) + k * len(et)
        elem_edge[el, le] = ea + int(mjm.flex_elemedge[eadr + le])
    # unused local-edge slots point at edge 0 with zero metric rows

  stiff = np.asarray(mjm.flex_stiffness, np.float32).reshape(nel, 21)
  bend = (np.asarray(mjm.flex_bending, np.float32).reshape(nfe, 17)
          if mjm.flex_bending.size else np.zeros((nfe, 17), np.float32))

  vert_dofadr = []
  for v in range(nfv):
    b = int(mjm.flex_vertbodyid[v])
    vert_dofadr.append(int(mjm.body_dofadr[b])
                       if int(mjm.body_dofnum[b]) == 3 else -1)

  # collision surface triangles: dim2 elements are triangles; dim3
  # flexes expose their shell faces (reference collision_flex.py:381,532)
  tri, tri_flexid = [], []
  for f in range(nflex):
    va = int(mjm.flex_vertadr[f])
    if dims[f] == 2:
      for k in range(int(mjm.flex_elemnum[f])):
        da = int(mjm.flex_elemdataadr[f]) + k * 3
        tri.append((int(mjm.flex_elem[da]) + va,
                    int(mjm.flex_elem[da + 1]) + va,
                    int(mjm.flex_elem[da + 2]) + va))
        tri_flexid.append(f)
    elif dims[f] == 3:
      for k in range(int(mjm.flex_shellnum[f])):
        da = int(mjm.flex_shelldataadr[f]) + k * 3
        tri.append((int(mjm.flex_shell[da]) + va,
                    int(mjm.flex_shell[da + 1]) + va,
                    int(mjm.flex_shell[da + 2]) + va))
        tri_flexid.append(f)

  # candidate (geom, vertex/triangle) contact pairs, affinity-filtered
  # (reference collision_flex.py loops all geoms per thread and filters
  # at runtime, :470-473; the static list replaces that filter)
  _PLANE, _SPHERE, _CAPSULE, _CYL, _BOX = 0, 2, 3, 5, 6
  prim = (_SPHERE, _CAPSULE, _CYL, _BOX)
  tri_flexid_np = np.asarray(tri_flexid, np.int32)
  plane_pairs, tri_pairs = [], []
  for g in range(mjm.ngeom):
    gt = int(mjm.geom_type[g])
    for f in range(nflex):
      ok = ((int(mjm.geom_contype[g]) & int(mjm.flex_conaffinity[f])) or
            (int(mjm.flex_contype[f]) & int(mjm.geom_conaffinity[g])))
      if not ok:
        continue
      va, vn = int(mjm.flex_vertadr[f]), int(mjm.flex_vertnum[f])
      if gt == _PLANE:
        plane_pairs += [(g, v, f) for v in range(va, va + vn)]
      elif gt in prim:
        tri_pairs += [(gt, g, int(t), f)
                      for t in np.nonzero(tri_flexid_np == f)[0]]

  meta = FlexMeta(
      nflex=nflex, nvert=nfv, nedge=nfe, nelem=nel,
      dim=dims,
      vertadr=tuple(int(x) for x in mjm.flex_vertadr),
      vertnum=tuple(int(x) for x in mjm.flex_vertnum),
      edgeadr=tuple(int(x) for x in mjm.flex_edgeadr),
      edgenum=tuple(int(x) for x in mjm.flex_edgenum),
      elemadr=tuple(int(x) for x in mjm.flex_elemadr),
      elemnum=tuple(int(x) for x in mjm.flex_elemnum),
      damping=tuple(float(x) for x in mjm.flex_damping),
      edge_equality=tuple(bool(x) for x in mjm.flex_edgeequality),
      vert_bodyid=tuple(int(x) for x in mjm.flex_vertbodyid),
      vert_dofadr=tuple(vert_dofadr),
      centered=tuple(bool(x) for x in mjm.flex_centered),
      radius=tuple(float(x) for x in mjm.flex_radius),
      contype=tuple(int(x) for x in mjm.flex_contype),
      conaffinity=tuple(int(x) for x in mjm.flex_conaffinity),
      condim=tuple(int(x) for x in mjm.flex_condim),
      priority=tuple(int(x) for x in mjm.flex_priority),
      solmix=tuple(float(x) for x in mjm.flex_solmix),
      friction=tuple(tuple(float(y) for y in x) for x in mjm.flex_friction),
      solref=tuple(tuple(float(y) for y in x) for x in mjm.flex_solref),
      solimp=tuple(tuple(float(y) for y in x) for x in mjm.flex_solimp),
      margin=tuple(float(x) for x in mjm.flex_margin),
      gap=tuple(float(x) for x in mjm.flex_gap),
      edge=tuple((int(a), int(b)) for a, b in edge),
      edgeflap=tuple((int(a), int(b)) for a, b in flap),
      elem_enda=tuple(tuple(int(x) for x in row) for row in elem_enda),
      elem_endb=tuple(tuple(int(x) for x in row) for row in elem_endb),
      tri=tuple(tri), tri_flexid=tuple(tri_flexid),
      plane_pairs=tuple(plane_pairs), tri_pairs=tuple(tri_pairs),
  )
  leaves = dict(
      flex_edge=edge, flex_edgeflap=flap,
      flex_elem_edge=elem_edge, flex_elem_enda=elem_enda,
      flex_elem_endb=elem_endb,
      flex_stiffness=stiff, flex_bending=bend,
      flexedge_length0=np.asarray(mjm.flexedge_length0, np.float32),
      flexedge_invweight0=np.asarray(mjm.flexedge_invweight0, np.float32),
      flex_vertlocal=np.asarray(mjm.flex_vert, np.float32).reshape(nfv, 3),
      flex_vert_bodyid=np.asarray(mjm.flex_vertbodyid, np.int32),
      flex_vert_dofadr=np.asarray(vert_dofadr, np.int32),
  )
  return meta, leaves


# ---------------------------------------------------------------------------
# runtime stages (single world; vmapped by callers)
# ---------------------------------------------------------------------------


def kinematics(m: Model, d: Data) -> Data:
  """flexvert_xpos, flexedge_length, flexedge_velocity (reference
  smooth.py:228-330)."""
  fx = m.flex_meta
  if not fx.nflex:
    return d
  bodyid = np.asarray(fx.vert_bodyid)
  centered = np.concatenate([
      np.full(fx.vertnum[f], fx.centered[f]) for f in range(fx.nflex)])
  xpos_b = d.xpos[bodyid]                           # (nfv, 3)
  xmat_b = d.xmat[bodyid]                           # (nfv, 3, 3)
  local = jnp.einsum('vij,vj->vi', xmat_b, m.flex_vertlocal)
  vert = jnp.where(jnp.asarray(centered)[:, None], xpos_b, xpos_b + local)

  # vertex velocities: v = b + a x (p - c_root), a/b via mask matmuls
  mask = m.body_dof_ancestor_mask[bodyid]           # (nfv, nv)
  qv = d.qvel[None, :] * mask                       # (nfv, nv)
  cd_ang = d.cdof[:, :3]
  cd_lin = d.cdof[:, 3:]
  a = qv @ cd_ang                                   # (nfv, 3)
  b = qv @ cd_lin
  rootid = np.asarray([0 if bi < 0 else bi for bi in
                       np.asarray(m.body_rootid)[bodyid]])
  com = d.subtree_com[rootid]
  vvel = b + jnp.cross(a, vert - com)

  e0, e1 = m.flex_edge[:, 0], m.flex_edge[:, 1]
  vec = vert[e1] - vert[e0]
  length = jnp.linalg.norm(vec, axis=-1)
  dirv = vec / jnp.maximum(length, 1e-15)[:, None]
  evel = jnp.sum(dirv * (vvel[e1] - vvel[e0]), axis=-1)
  return d.replace(flexvert_xpos=vert, flexedge_length=length,
                   flexedge_velocity=evel)


def _accumulate(m: Model, verts, forces: jax.Array) -> jax.Array:
  """Scatter per-vertex 3-forces into (nv,) qfrc at the vertex slide
  dofs (reference passive.py:659-662 point-mass convention). `verts`
  is a STATIC index table (numpy, or a concrete Model leaf)."""
  fx = m.flex_meta
  dofadr = np.asarray(fx.vert_dofadr)
  if not isinstance(verts, np.ndarray):
    verts = np.asarray(jax.device_get(verts))
  vd = dofadr[verts]                                # (...,) base dof or -1
  valid = vd >= 0
  cols = np.where(valid[..., None], vd[..., None] + np.arange(3), 0)
  vals = jnp.where(jnp.asarray(valid)[..., None], forces, 0.0)
  out = jnp.zeros((m.nv,), forces.dtype)
  return out.at[jnp.asarray(cols.reshape(-1))].add(vals.reshape(-1))


def elasticity(m: Model, d: Data) -> jax.Array:
  """(nv,) qfrc from element elasticity + damping (reference
  passive.py:567-669)."""
  fx = m.flex_meta
  dt = d.qpos.dtype
  timestep = m.opt.timestep
  dsbl_damper = bool(m.opt.disableflags & DisableBit.DAMPER)

  # per-element damping coefficient + local edge validity
  kD = np.zeros((fx.nelem, 1), np.float32)
  nedge_of = np.zeros((fx.nelem,), np.int32)
  for f in range(fx.nflex):
    sl = slice(fx.elemadr[f], fx.elemadr[f] + fx.elemnum[f])
    kD[sl] = 0.0 if dsbl_damper else fx.damping[f]
    nedge_of[sl] = len(_EDGE_TABLE[fx.dim[f]])
  maxe = m.flex_elem_edge.shape[1]
  evalid = (np.arange(maxe)[None, :] < nedge_of[:, None])  # (nel, maxe)

  ge = m.flex_elem_edge                              # (nel, maxe) global
  L = d.flexedge_length[ge]
  L0 = m.flexedge_length0[ge]
  vel = d.flexedge_velocity[ge]
  kd = jnp.asarray(kD) / timestep
  prev = L - vel * timestep
  elong = L * L - L0 * L0 + (L * L - prev * prev) * kd
  elong = elong * jnp.asarray(evalid, dt)

  # metric: symmetric (maxe, maxe) from packed upper triangle
  # (reference passive.py:644-649; packing consumes indices in
  # (ed1, ed2>=ed1) order over the flex's own nedge)
  met = np.zeros((fx.nelem, maxe, maxe), np.int32)   # index into 21-pack
  for f in range(fx.nflex):
    ne = len(_EDGE_TABLE[fx.dim[f]])
    idx = 0
    for e1 in range(ne):
      for e2 in range(e1, ne):
        for el in range(fx.elemadr[f], fx.elemadr[f] + fx.elemnum[f]):
          met[el, e1, e2] = idx
          met[el, e2, e1] = idx
        idx += 1
  metric = m.flex_stiffness[jnp.arange(fx.nelem)[:, None, None],
                            jnp.asarray(met)]        # (nel, maxe, maxe)
  metric = metric * jnp.asarray(evalid[:, :, None] & evalid[:, None, :], dt)

  coef = jnp.einsum('ekl,ek->el', metric, elong)     # (nel, maxe)
  # static endpoint tables from flex_meta — the Model leaves are tracers
  # inside jit(step) and _accumulate needs concrete indices
  A = np.asarray(fx.elem_enda, np.int32).reshape(fx.nelem, maxe)
  B = np.asarray(fx.elem_endb, np.int32).reshape(fx.nelem, maxe)
  xa = d.flexvert_xpos[A]
  xb = d.flexvert_xpos[B]
  fedge = -coef[..., None] * (xa - xb)               # force on endpoint A
  return _accumulate(m, A, fedge) + _accumulate(m, B, -fedge)


def bending(m: Model, d: Data) -> jax.Array:
  """(nv,) qfrc from dihedral bending (dim=2 flexes; reference
  passive.py:671-746). flex_bending rows: 16 Hessian entries + 1
  nonlinear coefficient. Rayleigh (stiffness-proportional) damping acts
  on the linear part: f -= damping * H @ xdot (C mj_passive flex
  bending; verified numerically vs mjd.qfrc_passive)."""
  fx = m.flex_meta
  dt = d.qpos.dtype
  flap = np.asarray(fx.edgeflap, np.int32).reshape(fx.nedge, 2)
  edge = np.asarray(fx.edge, np.int32).reshape(fx.nedge, 2)
  # rows with a full quad and a dim-2 flex; per-edge damping coef
  dim_of = np.zeros((fx.nedge,), np.int32)
  damp_of = np.zeros((fx.nedge,), np.float32)
  for f in range(fx.nflex):
    sl = slice(fx.edgeadr[f], fx.edgeadr[f] + fx.edgenum[f])
    dim_of[sl] = fx.dim[f]
    damp_of[sl] = fx.damping[f]
  if bool(m.opt.disableflags & DisableBit.DAMPER):
    damp_of[:] = 0.0
  active = (dim_of == 2) & (flap[:, 1] >= 0)
  v = np.concatenate([edge, np.maximum(flap, 0)], axis=1)  # (nfe, 4)

  # vertex velocities: slide-dof gather (pinned verts -> 0)
  dofadr = np.asarray(fx.vert_dofadr)
  valid = dofadr >= 0
  cols = np.where(valid[:, None], dofadr[:, None] + np.arange(3), 0)
  vvel = jnp.where(jnp.asarray(valid)[:, None], d.qvel[jnp.asarray(cols)],
                   0.0)                              # (nfv, 3)

  x = d.flexvert_xpos[v]                             # (nfe, 4, 3)
  xdot = vvel[v]                                     # (nfe, 4, 3)
  bendmat = m.flex_bending[:, :16].reshape(fx.nedge, 4, 4)
  xd = x + jnp.asarray(damp_of)[:, None, None] * xdot
  lin = -jnp.einsum('eij,ejx->eix', bendmat, xd)     # (nfe, 4, 3)

  c16 = m.flex_bending[:, 16]
  v0, v1, v2, v3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
  f1 = jnp.cross(v2 - v0, v3 - v0)
  f2 = jnp.cross(v3 - v0, v1 - v0)
  f3 = jnp.cross(v1 - v0, v2 - v0)
  f0 = -(f1 + f2 + f3)
  frc = jnp.stack([f0, f1, f2, f3], axis=1)          # (nfe, 4, 3)
  force = lin - c16[:, None, None] * frc
  force = force * jnp.asarray(active, dt)[:, None, None]
  return _accumulate(m, v, force)


def passive_force(m: Model, d: Data) -> jax.Array:
  """Total flex passive force -> (nv,) (added to qfrc_spring)."""
  fx = m.flex_meta
  if not fx.nflex:
    return jnp.zeros((m.nv,), d.qpos.dtype)
  qf = elasticity(m, d)
  if any(dim == 2 for dim in fx.dim):
    qf = qf + bending(m, d)
  return qf
