"""Mesh-cluster bounding-volume acceleration (the reference's bvh.py
role, re-designed for vector lanes).

The reference builds a binary BVH per mesh and walks it with a
per-thread stack (mujoco_warp/_src/bvh.py:35,297; ray.py:701-799).
Stack-based pointer chasing is the worst possible shape for vector
lanes, so this formulation flattens the hierarchy to ONE level of
fixed-size face clusters:

* build (host, put_model time): sort faces by the Morton code of their
  centroid, partition the sorted order into clusters of `CLUSTER`
  faces, store per-cluster AABBs. Morton order keeps clusters spatially
  compact, so cluster AABBs are tight — the same locality a BVH's
  leaves would have.
* query (device): slab-test the ray against all cluster AABBs at once
  (C clusters = F/CLUSTER boxes — 64x fewer than faces), sort clusters
  by entry distance, then march them in blocks of K under a
  ``lax.while_loop``: Moller-Trumbore on the K x CLUSTER gathered
  faces, stop as soon as the best hit is closer than the next
  cluster's entry (the standard BVH front-to-back early-out, expressed
  as a data-dependent trip count instead of a stack). Exact — never an
  approximation — with a typical cost of one or two blocks.

The scene-level BVH role (ref bvh.py scene build/refit) is played by
the broadphase's per-step world-AABB cull (collision_driver.py /
collision_sap.py); meshes are rigid so cluster AABBs never need
refitting.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

CLUSTER = 64      # faces per cluster (one lane-width of work)
_INF = 1e10


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------


def _morton3(x: np.ndarray) -> np.ndarray:
  """Interleave 10-bit quantized xyz into a 30-bit Morton code.
  x: (n, 3) in [0, 1]."""
  q = np.clip((x * 1023.0), 0, 1023).astype(np.uint64)

  def spread(v):
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v

  return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
          | (spread(q[:, 2]) << np.uint64(2)))


def cluster_order(faces: np.ndarray) -> np.ndarray:
  """The Morton permutation build_clusters applies to a mesh's faces —
  exposed so per-face side data (texcoords) can be reordered to match
  the clustered face array."""
  cent = faces.mean(axis=1)
  lo, hi = cent.min(axis=0), cent.max(axis=0)
  span = np.maximum(hi - lo, 1e-9)
  return np.argsort(_morton3((cent - lo) / span), kind='stable')


def build_clusters(faces: np.ndarray, cmax: int
                   ) -> tuple[np.ndarray, np.ndarray]:
  """Cluster one mesh's (F, 3, 3) triangles.

  Returns (clustered_faces (cmax*CLUSTER, 3, 3), aabb (cmax, 2, 3)).
  Padding faces are degenerate zeros (never hit); padding clusters get
  an inverted AABB (min > max) that fails every slab test."""
  f = faces.shape[0]
  faces = faces[cluster_order(faces)]

  out = np.zeros((cmax * CLUSTER, 3, 3), faces.dtype)
  out[:f] = faces
  aabb = np.empty((cmax, 2, 3), faces.dtype)
  aabb[:, 0] = _INF          # inverted: misses everything
  aabb[:, 1] = -_INF
  nclus = (f + CLUSTER - 1) // CLUSTER
  for c in range(nclus):
    blk = faces[c * CLUSTER:(c + 1) * CLUSTER].reshape(-1, 3)
    aabb[c, 0] = blk.min(axis=0)
    aabb[c, 1] = blk.max(axis=0)
  return out, aabb


# ---------------------------------------------------------------------------
# device-side query
# ---------------------------------------------------------------------------


def _moller(faces, p, v):
  """Min positive ray parameter over (..., 3, 3) triangles (local
  frame). Degenerate (zero) padding never hits."""
  a = faces[..., 0, :]
  e1 = faces[..., 1, :] - a
  e2 = faces[..., 2, :] - a
  pvec = jnp.cross(jnp.broadcast_to(v, e2.shape), e2)
  det = jnp.sum(e1 * pvec, axis=-1)
  ok = jnp.abs(det) > 1e-12
  inv = 1.0 / jnp.where(ok, det, 1.0)
  tvec = p - a
  u = jnp.sum(tvec * pvec, axis=-1) * inv
  qvec = jnp.cross(tvec, e1)
  w = jnp.sum(v * qvec, axis=-1) * inv
  t = jnp.sum(e2 * qvec, axis=-1) * inv
  hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
  return jnp.min(jnp.where(hit, t, _INF))


def ray_mesh_clustered(faces, aabb, pos, mat, pnt, vec, block: int = 2):
  """Exact closest-hit ray-mesh query through the cluster structure.

  faces: (cmax*CLUSTER, 3, 3) Morton-clustered local triangles
  aabb:  (cmax, 2, 3) per-cluster local AABBs
  pos/mat: geom world pose; pnt/vec: world ray. Returns min positive t
  (same contract as ray.ray_mesh)."""
  cmax = aabb.shape[0]
  p = mat.T @ (pnt - pos)
  v = mat.T @ vec

  # slab test all clusters at once
  vsafe = jnp.where(jnp.abs(v) < 1e-12, 1e-12, v)
  t0 = (aabb[:, 0] - p) / vsafe           # (cmax, 3)
  t1 = (aabb[:, 1] - p) / vsafe
  tlo = jnp.minimum(t0, t1).max(axis=-1)
  thi = jnp.maximum(t0, t1).min(axis=-1)
  hit = (thi >= jnp.maximum(tlo, 0.0)) & (thi >= 0)
  entry = jnp.where(hit, jnp.maximum(tlo, 0.0), _INF)

  order = jnp.argsort(entry)              # ascending entry distance
  entry_sorted = entry[order]
  cl_faces = faces.reshape(cmax, CLUSTER, 3, 3)

  def cond(state):
    i, best = state
    # march while clusters remain AND the next one could still beat
    # the current best hit (front-to-back early-out)
    return (i < cmax) & (entry_sorted[i] < best)

  def body(state):
    i, best = state
    # out-of-range indices clamp to the last cluster: re-testing real
    # faces is harmless (any face hit is genuine), so no masking needed
    idx = jnp.clip(i + jnp.arange(block), 0, cmax - 1)
    blk = cl_faces[order[idx]]            # (block, CLUSTER, 3, 3)
    return i + block, jnp.minimum(best, _moller(blk, p, v))

  _, best = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32),
                                            jnp.asarray(_INF, p.dtype)))
  return best
