"""Batch raytracing renderer (reference: mujoco_warp/_src/render.py —
megakernel raytracer at 516, texture sampling at 44, lighting at 420).

Vectorized formulation: rays for all (camera, pixel) pairs are one
vectorized closest-hit sweep over all geoms (the reference's `_ray`
world-parallel kernel pattern, ray.py:909) — no BVH; the masked dense
sweep is the natural VPU formulation at benchmark-class geom counts.
Shading mirrors the reference exactly: hemispheric ambient, per-light
Lambert with point/spot attenuation (render.py:463-475), any-hit shadow
rays at 0.3 visibility (render.py:472-512), material/texture base color
(plane uv textures, render.py:65-84). Outputs float RGB [0,1], depth
along the ray, and int32 geom segmentation per pixel.

`vmap` over worlds renders every world's cameras in one program.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import math
from . import ray as ray_mod
from .types import Data, GeomType, Model, _pytree

_INF = 1e10


def _cam_resolutions(rc) -> list:
  """[(W, H)] per selected camera (back-compat: () = uniform)."""
  res = getattr(rc, 'resolutions', ()) or ()
  if len(res) == len(rc.cam_ids) and len(res) > 0:
    return list(res)
  return [(rc.width, rc.height)] * len(rc.cam_ids)


@_pytree(meta=('width', 'height', 'cam_ids', 'geom_texid', 'use_shadows',
               'use_textures', 'light_type', 'light_castshadow',
               'resolutions', 'mesh_has_uv'))
class RenderContext:
  """Static camera/light/texture setup (reference types.py:1899
  RenderContext; built by create_render_context = io.py:2649).
  `resolutions` is a per-camera ((W, H), ...) tuple enabling
  heterogeneous camera sizes (reference render.py:593-604 cumulative
  ray addressing); () falls back to the uniform width x height."""
  width: int
  height: int
  cam_ids: Tuple[int, ...]
  resolutions: Tuple[Tuple[int, int], ...]
  geom_texid: Tuple[int, ...]   # per-geom texture id (-1 = none)
  use_shadows: bool
  use_textures: bool
  light_type: Tuple[int, ...]        # 0 spot, 1 directional, 2 point
  light_castshadow: Tuple[bool, ...]
  geom_rgba: jax.Array       # (ngeom, 4) material- resolved base color
  geom_texrepeat: jax.Array  # (ngeom, 2)
  fovy: jax.Array            # (ncam_sel,) degrees
  textures: jax.Array        # (ntex, TH, TW, 3) float [0,1] (or (0,...))
  mesh_has_uv: Tuple[bool, ...]  # per-mesh: texcoords present
  mesh_face_uv: jax.Array    # (nmesh, Fpad, 3, 2) per-corner texcoords
                             # in m.mesh_faces' Morton-clustered order


def create_render_context(mjm, m: Model, width: int = 64,
                          height: int = 64, cam_ids=None,
                          use_shadows: bool = True,
                          use_textures: bool = True,
                          resolutions=None) -> RenderContext:
  """Build a RenderContext (reference io.py:2649 create_render_context:
  texture upload, material resolution, light flags). `resolutions` is
  an optional per-camera [(W, H), ...]; by default each camera uses its
  MJCF <camera resolution="..."> when set, else width x height."""
  if cam_ids is None:
    cam_ids = tuple(range(m.ncam))
  fovy = np.asarray([mjm.cam_fovy[c] for c in cam_ids], np.float32)
  if resolutions is None:
    res = []
    cam_res = getattr(mjm, 'cam_resolution', None)
    for c in cam_ids:
      if cam_res is not None and int(cam_res[c][0]) > 1:
        res.append((int(cam_res[c][0]), int(cam_res[c][1])))
      else:
        res.append((int(width), int(height)))
    resolutions = tuple(res)
  else:
    resolutions = tuple((int(w), int(h)) for (w, h) in resolutions)

  # resolve material color / texture per geom (reference render.py:686)
  rgba = np.array(mjm.geom_rgba, np.float32)
  texid = np.full(mjm.ngeom, -1, np.int32)
  texrepeat = np.ones((mjm.ngeom, 2), np.float32)
  for g in range(mjm.ngeom):
    mat = int(mjm.geom_matid[g])
    if mat >= 0:
      rgba[g] = mjm.mat_rgba[mat]
      tid = int(mjm.mat_texid[mat, 1])   # mjTEXROLE_RGB
      if tid >= 0 and use_textures:
        texid[g] = tid
        texrepeat[g] = mjm.mat_texrepeat[mat]

  used = sorted(set(int(t) for t in texid if t >= 0))
  if used:
    th = max(int(mjm.tex_height[t]) for t in used)
    tw = max(int(mjm.tex_width[t]) for t in used)
    tex = np.zeros((len(used), th, tw, 3), np.float32)
    remap = {t: i for i, t in enumerate(used)}
    for t in used:
      h, w = int(mjm.tex_height[t]), int(mjm.tex_width[t])
      nch = int(mjm.tex_nchannel[t])
      adr = int(mjm.tex_adr[t])
      img = np.asarray(mjm.tex_data[adr:adr + h * w * nch],
                       np.float32).reshape(h, w, nch) / 255.0
      # tile smaller textures up to the padded size (wrap addressing
      # below uses the padded extent)
      reps = (-(-th // h), -(-tw // w), 1)
      tex[remap[t]] = np.tile(img[..., :3] if nch >= 3 else
                              np.repeat(img, 3, -1), reps)[:th, :tw]
    texid = np.array([remap.get(int(t), -1) for t in texid], np.int32)
  else:
    tex = np.zeros((0, 1, 1, 3), np.float32)

  # flex surfaces render with flex_rgba; their color/texrepeat rows sit
  # at index ngeom + flexid (seg ids likewise)
  if int(mjm.nflex):
    rgba = np.concatenate(
        [rgba, np.asarray(mjm.flex_rgba, np.float32)], axis=0)
    texrepeat = np.concatenate(
        [texrepeat, np.ones((int(mjm.nflex), 2), np.float32)], axis=0)

  # per-face-corner mesh texcoords, reordered to match the
  # Morton-clustered face array m.mesh_faces (reference render.py:44
  # sample_texture MESH branch: barycentric uv from mesh_texcoord /
  # mesh_facetexcoord)
  from . import bvh as bvh_mod
  nmesh = int(mjm.nmesh)
  fpad = m.mesh_faces.shape[1] if nmesh else 1
  face_uv = np.zeros((max(nmesh, 1), fpad, 3, 2), np.float32)
  has_uv = [False] * max(nmesh, 1)
  if use_textures and nmesh and mjm.mesh_texcoord.size:
    for i in range(nmesh):
      if int(mjm.mesh_texcoordadr[i]) < 0:
        continue
      fadr, fnum = int(mjm.mesh_faceadr[i]), int(mjm.mesh_facenum[i])
      ftc = mjm.mesh_facetexcoord[fadr:fadr + fnum]        # (F, 3)
      uv = mjm.mesh_texcoord[int(mjm.mesh_texcoordadr[i]) + ftc]
      verts = mjm.mesh_vert[mjm.mesh_vertadr[i] +
                            mjm.mesh_face[fadr:fadr + fnum]]
      order = bvh_mod.cluster_order(verts.astype(np.float32))
      face_uv[i, :fnum] = uv[order]
      has_uv[i] = True

  return RenderContext(
      width=width, height=height, cam_ids=tuple(int(c) for c in cam_ids),
      resolutions=resolutions,
      geom_texid=tuple(int(t) for t in texid),
      use_shadows=bool(use_shadows and mjm.nlight),
      use_textures=bool(use_textures and used),
      light_type=tuple(int(t) for t in mjm.light_type),
      light_castshadow=tuple(bool(b) for b in mjm.light_castshadow),
      geom_rgba=jnp.asarray(rgba),
      geom_texrepeat=jnp.asarray(texrepeat),
      fovy=jnp.asarray(fovy),
      textures=jnp.asarray(tex),
      mesh_has_uv=tuple(has_uv),
      mesh_face_uv=jnp.asarray(face_uv))


def _normal_at(m: Model, d: Data, g: int, hit: jax.Array) -> jax.Array:
  """Outward surface normal of geom g at world point `hit` (analytic)."""
  gtype = GeomType(m.geom_type[g])
  p = d.geom_xpos[g]
  R = d.geom_xmat[g]
  s = m.geom_size[g]
  loc = R.T @ (hit - p)
  if gtype == GeomType.PLANE:
    return R[:, 2]
  if gtype == GeomType.SPHERE:
    return math.normalize(hit - p)
  if gtype == GeomType.CAPSULE:
    z = jnp.clip(loc[2], -s[1], s[1])
    return math.normalize(hit - (p + R[:, 2] * z))
  if gtype == GeomType.CYLINDER:
    side = math.normalize(
        R @ jnp.concatenate([math.normalize(loc[:2]),
                             jnp.zeros(1, loc.dtype)]))
    cap = R[:, 2] * jnp.sign(loc[2])
    on_cap = jnp.abs(loc[2]) > s[1] - 1e-5
    return jnp.where(on_cap, cap, side)
  if gtype == GeomType.ELLIPSOID:
    n_loc = math.normalize(loc / jnp.maximum(s * s, 1e-12))
    return math.normalize(R @ n_loc)
  if gtype == GeomType.BOX:
    q = jnp.abs(loc) - s[:3]
    ax = jnp.argmax(q)
    n_loc = jnp.zeros(3, loc.dtype).at[ax].set(jnp.sign(loc[ax]))
    return R @ n_loc
  if gtype == GeomType.HFIELD:
    # top-surface gradient normal (sides/base rare in renders)
    hid = m.geom_dataid[g]
    nr, nc = m.hfield_nrow[hid], m.hfield_ncol[hid]
    size = m.hfield_size[hid]
    grid = m.hfield_data[hid, :nr, :nc]
    u = jnp.clip((loc[0] / size[0] + 1.0) * 0.5 * (nc - 1), 0, nc - 1)
    v = jnp.clip((loc[1] / size[1] + 1.0) * 0.5 * (nr - 1), 0, nr - 1)
    i0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, nr - 2)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, nc - 2)
    dx = 2.0 * size[0] / (nc - 1)
    dy = 2.0 * size[1] / (nr - 1)
    gx = (grid[i0, j0 + 1] - grid[i0, j0]) * size[2] / dx
    gy = (grid[i0 + 1, j0] - grid[i0, j0]) * size[2] / dy
    return math.normalize(R @ jnp.stack([-gx, -gy, jnp.ones((),
                                                            loc.dtype)]))
  return math.normalize(hit - p)


def _render_geoms(m: Model):
  """Static list of renderable geom ids."""
  out = []
  for g in range(m.ngeom):
    gt = GeomType(m.geom_type[g])
    if gt in ray_mod.RAY_FN or (
        gt in (GeomType.MESH, GeomType.HFIELD) and m.geom_dataid[g] >= 0):
      out.append(g)
  return out


def _render_flexes(m: Model):
  """[(flexid, np tri-vertex-id array (T, 3))] of renderable flex
  surfaces (reference bvh.py:608-1095 flex surface extraction; our
  surface triangles are precomputed in FlexMeta.tri). Rendered with
  flat face normals; ids in seg maps are ngeom + flexid."""
  fx = m.flex_meta
  if not fx.nflex or not fx.tri:
    return []
  tri = np.asarray(fx.tri, np.int32)
  fid = np.asarray(fx.tri_flexid, np.int32)
  return [(f, tri[fid == f]) for f in sorted(set(int(x) for x in fid))]


def _ray_flex_hit(verts, tri, o, v):
  """Closest hit vs dynamic world-space flex triangles (T, 3 ids into
  verts); returns (t, world normal)."""
  a = verts[tri[:, 0]]
  e1 = verts[tri[:, 1]] - a
  e2 = verts[tri[:, 2]] - a
  pvec = jnp.cross(v[None, :], e2)
  det = jnp.einsum('fi,fi->f', e1, pvec)
  ok = jnp.abs(det) > 1e-12
  inv = 1.0 / jnp.where(ok, det, 1.0)
  tvec = o[None, :] - a
  u = jnp.einsum('fi,fi->f', tvec, pvec) * inv
  qvec = jnp.cross(tvec, e1)
  w = jnp.einsum('i,fi->f', v, qvec) * inv
  t = jnp.einsum('fi,fi->f', e2, qvec) * inv
  hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
  tall = jnp.where(hit, t, _INF)
  i = jnp.argmin(tall)
  n = jnp.cross(e1[i], e2[i])
  n = n * jnp.sign(-jnp.dot(n, v))
  return tall[i], math.normalize(n)


def _closest_hit(m: Model, d: Data, gids, origin, dirs, rc=None,
                 flexes=()):
  """Closest hit over `gids` (+ flex surfaces): (t (R,), slot (R,),
  normal (R, 3), uv (R, 2)). `origin` is (3,) shared or (R, 3) per ray.
  uv carries mesh texcoords for geoms whose mesh has them (zeros
  otherwise; the caller selects by slot). Flex slots follow the geom
  slots in order."""
  per_ray_origin = origin.ndim == 2
  o_of = (lambda i: origin) if not per_ray_origin else None
  zuv = jnp.zeros(2, dirs.dtype)
  ts, ns, uvs = [], [], []
  for g in gids:
    gt = GeomType(m.geom_type[g])
    if gt == GeomType.MESH:
      mid = int(m.geom_dataid[g])
      faces = m.mesh_faces[mid]
      if rc is not None and rc.mesh_has_uv[mid]:
        fuv = rc.mesh_face_uv[mid]
        fn = lambda o, v, g=g, faces=faces, fuv=fuv: (
            ray_mod.ray_mesh_hit_uv(faces, fuv, d.geom_xpos[g],
                                    d.geom_xmat[g], o, v))
      else:
        fn = lambda o, v, g=g, faces=faces: ray_mod.ray_mesh_hit(
            faces, d.geom_xpos[g], d.geom_xmat[g], o, v) + (zuv,)
    elif gt == GeomType.HFIELD:
      hid = m.geom_dataid[g]
      faces = ray_mod.hfield_faces(m, hid, dirs.dtype)
      def fn(o, v, g=g, hid=hid, faces=faces):
        t1, n1 = ray_mod.ray_mesh_hit(faces, d.geom_xpos[g],
                                      d.geom_xmat[g], o, v)
        t2 = ray_mod.ray_hfield(m, hid, d.geom_xpos[g], d.geom_xmat[g],
                                o, v)
        # walls/base: analytic normal fallback from _normal_at
        t = jnp.minimum(t1, t2)
        return t, n1, zuv
    else:
      rf = ray_mod.RAY_FN[gt]
      def fn(o, v, g=g, rf=rf):
        t = rf(d.geom_xpos[g], d.geom_xmat[g], m.geom_size[g], o, v)
        hitp = o + t * v
        return t, _normal_at(m, d, g, hitp), zuv
    if per_ray_origin:
      t_g, n_g, uv_g = jax.vmap(fn)(origin, dirs)
    else:
      t_g, n_g, uv_g = jax.vmap(lambda v: fn(origin, v))(dirs)
    ts.append(t_g)
    ns.append(n_g)
    uvs.append(uv_g)
  for _fid, tri_np in flexes:
    tri = jnp.asarray(tri_np)
    fn = lambda o, v, tri=tri: _ray_flex_hit(
        d.flexvert_xpos, tri, o, v) + (zuv,)
    if per_ray_origin:
      t_g, n_g, uv_g = jax.vmap(fn)(origin, dirs)
    else:
      t_g, n_g, uv_g = jax.vmap(lambda v: fn(origin, v))(dirs)
    ts.append(t_g)
    ns.append(n_g)
    uvs.append(uv_g)
  tstack = jnp.stack(ts)                             # (G, R)
  slot = jnp.argmin(tstack, axis=0)                  # (R,)
  tmin = jnp.take_along_axis(tstack, slot[None], axis=0)[0]
  nstack = jnp.stack(ns)                             # (G, R, 3)
  normal = jnp.take_along_axis(
      nstack, slot[None, :, None], axis=0)[0]
  uvstack = jnp.stack(uvs)                           # (G, R, 2)
  uv = jnp.take_along_axis(uvstack, slot[None, :, None], axis=0)[0]
  return tmin, slot, normal, uv


def _any_hit(m: Model, d: Data, gids, origins, dirs, tmax, flexes=()):
  """True per ray iff any geom is hit before tmax (shadow query)."""
  hit = jnp.zeros(dirs.shape[0], bool)
  for _fid, tri_np in flexes:
    tri = jnp.asarray(tri_np)
    t_g = jax.vmap(lambda o, v: _ray_flex_hit(
        d.flexvert_xpos, tri, o, v)[0])(origins, dirs)
    hit = hit | (t_g < tmax)
  for g in gids:
    gt = GeomType(m.geom_type[g])
    if gt == GeomType.MESH:
      faces = m.mesh_faces[m.geom_dataid[g]]
      fn = lambda o, v, g=g, faces=faces: ray_mod.ray_mesh(
          faces, d.geom_xpos[g], d.geom_xmat[g], o, v)
    elif gt == GeomType.HFIELD:
      hid = m.geom_dataid[g]
      fn = lambda o, v, g=g, hid=hid: ray_mod.ray_hfield(
          m, hid, d.geom_xpos[g], d.geom_xmat[g], o, v)
    else:
      rf = ray_mod.RAY_FN[gt]
      fn = lambda o, v, g=g, rf=rf: rf(
          d.geom_xpos[g], d.geom_xmat[g], m.geom_size[g], o, v)
    t_g = jax.vmap(fn)(origins, dirs)
    hit = hit | (t_g < tmax)
  return hit


def _sample_texture(rc: RenderContext, slot_tex, texrep, hit_local_xy):
  """Plane uv texture sample, nearest texel, wrap addressing
  (reference render.py:65-84 sample_texture)."""
  ntex, TH, TW, _ = rc.textures.shape
  u = hit_local_xy[:, 0] * texrep[:, 0]
  v = hit_local_xy[:, 1] * texrep[:, 1]
  u = u - jnp.floor(u)
  v = v - jnp.floor(v)
  ti = jnp.clip(slot_tex, 0, max(ntex - 1, 0))
  iy = jnp.clip((v * TH).astype(jnp.int32), 0, TH - 1)
  ix = jnp.clip((u * TW).astype(jnp.int32), 0, TW - 1)
  return rc.textures[ti, iy, ix]                     # (R, 3)


def render(m: Model, d: Data, rc: RenderContext):
  """Render all context cameras for one world in ONE packed ray batch
  (reference render.py:516 _render_megakernel + its per-camera
  heterogeneous resolutions via cumulative ray addressing, 593-604).
  Returns (rgb, depth, seg): stacked (ncam, H, W, ...) arrays when all
  cameras share a resolution, else per-camera LISTS of (H_i, W_i, ...)
  arrays."""
  dtype = d.qpos.dtype
  gids = _render_geoms(m)
  flexes = _render_flexes(m)
  res = _cam_resolutions(rc)                         # [(W_i, H_i)]
  uniform = len(set(res)) <= 1

  # pack every camera's rays into one flat (R, 3) batch with per-ray
  # origins — the shading below runs once over all cameras
  dir_list, org_list = [], []
  for ci, cam in enumerate(rc.cam_ids):
    Wc, Hc = res[ci]
    ys = (jnp.arange(Hc, dtype=dtype) + 0.5) / Hc - 0.5
    xs = (jnp.arange(Wc, dtype=dtype) + 0.5) / Wc - 0.5
    aspect = Wc / Hc
    fovy = rc.fovy[ci] * jnp.pi / 180.0
    tan_y = jnp.tan(0.5 * fovy)
    dir_cam = jnp.stack(jnp.broadcast_arrays(
        xs[None, :] * 2.0 * tan_y * aspect,
        -ys[:, None] * 2.0 * tan_y,
        -jnp.ones((Hc, Wc), dtype)), axis=-1)          # (H, W, 3)
    Rc = d.cam_xmat[cam]
    dirs_c = dir_cam.reshape(-1, 3) @ Rc.T             # (H*W, 3) world
    dir_list.append(jax.vmap(math.normalize)(dirs_c))
    org_list.append(jnp.broadcast_to(d.cam_xpos[cam],
                                     (Hc * Wc, 3)))

  def _split(flat, trailing=()):
    """Unpack the flat ray buffer back into per-camera images."""
    out, adr = [], 0
    for ci in range(len(rc.cam_ids)):
      Wc, Hc = res[ci]
      out.append(flat[adr:adr + Hc * Wc].reshape((Hc, Wc) + trailing))
      adr += Hc * Wc
    return out

  if not (gids or flexes) or not rc.cam_ids:
    rgbs = [jnp.zeros((h, w, 3), dtype) for (w, h) in res]
    depths = [jnp.full((h, w), -1.0, dtype) for (w, h) in res]
    segs = [jnp.full((h, w), -1, jnp.int32) for (w, h) in res]
    if uniform:
      return jnp.stack(rgbs), jnp.stack(depths), jnp.stack(segs)
    return rgbs, depths, segs

  dirs = jnp.concatenate(dir_list, axis=0)             # (R, 3)
  pc = jnp.concatenate(org_list, axis=0)               # (R, 3)

  if True:
    tmin, slot, normal, mesh_uv = _closest_hit(m, d, gids, pc, dirs, rc,
                                               flexes)
    hit_mask = tmin < _INF * 0.5
    # flex surfaces map to ids ngeom + flexid in seg/rgba tables
    gid_np = jnp.asarray(np.array(
        list(gids) + [m.ngeom + f for f, _ in flexes], np.int32))
    gid_arr = gid_np[slot]
    hits = pc + tmin[:, None] * dirs

    # base color: material-resolved rgba x texture (reference 686-717:
    # plane-local xy uv for planes, barycentric mesh texcoords for
    # meshes with <mesh texcoord>)
    base = rc.geom_rgba[gid_arr, :3]
    if rc.use_textures:
      nflex_slots = len(flexes)
      texid_np = np.asarray([rc.geom_texid[g] for g in gids] +
                            [-1] * nflex_slots, np.int32)
      is_plane_np = np.asarray(
          [GeomType(m.geom_type[g]) == GeomType.PLANE for g in gids] +
          [False] * nflex_slots)
      is_uvmesh_np = np.asarray(
          [GeomType(m.geom_type[g]) == GeomType.MESH and
           rc.mesh_has_uv[int(m.geom_dataid[g])] for g in gids] +
          [False] * nflex_slots)
      slot_tex = jnp.asarray(texid_np)[slot]
      textured = (slot_tex >= 0) & (jnp.asarray(is_plane_np)[slot] |
                                    jnp.asarray(is_uvmesh_np)[slot])
      # plane-local xy of the hit point, selected per slot; uv-mesh
      # slots take the barycentric texcoord from the hit instead
      locs = mesh_uv
      for k, g in enumerate(gids):
        if texid_np[k] < 0 or not is_plane_np[k]:
          continue
        lxy = (hits - d.geom_xpos[g]) @ d.geom_xmat[g][:, :2]
        locs = jnp.where((slot == k)[:, None], lxy, locs)
      texrep = rc.geom_texrepeat[gid_arr]
      texel = _sample_texture(rc, slot_tex, texrep, locs)
      base = jnp.where(textured[:, None], base * texel, base)

    # hemispheric ambient (reference render.py:719-725)
    hemi = 0.5 * (normal[:, 2] + 1.0)
    amb = (jnp.asarray([0.4, 0.4, 0.45], dtype)[None] * hemi[:, None] +
           jnp.asarray([0.1, 0.1, 0.12], dtype)[None] *
           (1.0 - hemi)[:, None])
    result = 0.5 * base * amb

    # per-light Lambert + shadows (reference render.py:420-512)
    for li in range(m.nlight):
      ltype = rc.light_type[li]
      lpos = d.light_xpos[li]
      ldir = d.light_xdir[li]
      if ltype == 1:                                 # directional
        L = jnp.broadcast_to(math.normalize(-ldir), dirs.shape)
        dist_l = jnp.full(dirs.shape[0], 1e8, dtype)
        atten = jnp.ones(dirs.shape[0], dtype)
      else:
        delta = lpos[None, :] - hits
        dist_l = jnp.linalg.norm(delta, axis=-1)
        L = delta / jnp.maximum(dist_l, 1e-12)[:, None]
        atten = 1.0 / (1.0 + 0.02 * dist_l * dist_l)
        if ltype == 0:                               # spot cone ramp
          cos_t = jnp.sum(-L * math.normalize(ldir)[None, :], axis=-1)
          atten = atten * jnp.clip((cos_t - 0.85) / 0.1, 0.0, 1.0)
      ndotl = jnp.maximum(0.0, jnp.sum(normal * L, axis=-1))
      visible = jnp.ones(dirs.shape[0], dtype)
      if rc.use_shadows and rc.light_castshadow[li]:
        sh_origin = hits + normal * 1e-4
        blocked = _any_hit(m, d, gids, sh_origin, L, dist_l - 1e-3,
                           flexes)
        visible = jnp.where(blocked & hit_mask, 0.3, 1.0)
      result = result + base * (ndotl * atten * visible)[:, None]

    rgb = jnp.clip(result, 0.0, 1.0)
    rgb = jnp.where(hit_mask[:, None], rgb, 0.0)

  rgbs = _split(rgb, (3,))
  depths = _split(jnp.where(hit_mask, tmin, -1.0))
  segs = _split(jnp.where(hit_mask, gid_arr, -1).astype(jnp.int32))
  if uniform:
    return jnp.stack(rgbs), jnp.stack(depths), jnp.stack(segs)
  return rgbs, depths, segs


def get_rgb(rgb: jax.Array) -> np.ndarray:
  """Float RGB -> uint8 (reference render_util.py:177)."""
  return np.asarray(jnp.clip(rgb * 255.0, 0, 255).astype(jnp.uint8))


def get_depth(depth: jax.Array) -> np.ndarray:
  return np.asarray(depth)


def get_segmentation(seg: jax.Array) -> np.ndarray:
  return np.asarray(seg)
