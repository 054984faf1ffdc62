"""Tree-sparse mass matrix: CSR-like storage, level-scheduled LDL.

The joint-space inertia matrix M has kinematic-tree sparsity —
M[i, j] != 0 only when j is an ancestor-or-self of i — and LDL^T in
leaf-to-root order factors with ZERO fill-in. At flex scale
(cloth: nv=2706, ~900 independent 3-dof vertex bodies) the dense
(nv, nv) storage the engine uses elsewhere is 7.3M entries of which
~8k are structurally nonzero.

This module is the genuinely-sparse equivalent of the reference's CSR
qM + level-scheduled factorization (reference mujoco_warp
_src/smooth.py:1017-1104 `_qLD_acc`, _src/io.py:575-635 qLD_updates;
C MuJoCo mj_factorM/mj_solveLD), redesigned for XLA: the static
update/solve schedules are precomputed on the host as numpy index
arrays grouped into dependency levels, and each level executes as ONE
batched gather + scatter-add over all worlds — no Pallas needed, the
working set is O(nnz), and everything is batch-polymorphic
((..., nM) values).

Storage layout: one packed value vector per world, `vals[(..., nM)]`,
holding the LOWER triangle incl. diagonal, row-major (for each dof i:
its ancestors j in ascending order, then the diagonal (i, i)).
The factored form overwrites the same layout: L[i, j] (unit-lower,
scaled) at off-diagonal slots, D[i] at diagonal slots.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


class QMMeta:
  """Static sparse-qM structure. Hashable by content (lives in Model
  meta, so it is part of every jit cache key)."""

  def __init__(self, dof_parentid):
    parent = np.asarray(dof_parentid, dtype=np.int64)
    nv = len(parent)
    # ancestor chains incl self, ascending
    anc = []
    for i in range(nv):
      chain = []
      j = i
      while j >= 0:
        chain.append(int(j))
        j = int(parent[j])
      anc.append(list(reversed(chain)))

    rows, cols = [], []
    madr = {}
    for i in range(nv):
      for j in anc[i]:                       # ascending, ends at (i, i)
        madr[(i, j)] = len(rows)
        rows.append(i)
        cols.append(j)
    self.nv = nv
    self.nM = len(rows)
    self.row = np.asarray(rows, np.int32)
    self.col = np.asarray(cols, np.int32)
    self.diag_madr = np.asarray([madr[(i, i)] for i in range(nv)],
                                np.int32)
    self.is_offdiag = self.row != self.col
    # off-diagonal scaling: L[k, i] = M'[k, i] / D[k] (divide by the
    # ROW's diagonal)
    self.offdiag_madr = np.nonzero(self.is_offdiag)[0].astype(np.int32)
    self.offdiag_rowdiag = self.diag_madr[
        self.row[self.offdiag_madr]].astype(np.int32)

    # dependency levels: leaves at 0; a dof is processed only after all
    # its descendants (level(parent) > level(child))
    level = np.zeros(nv, np.int64)
    for k in range(nv - 1, -1, -1):
      p = parent[k]
      if p >= 0:
        level[p] = max(level[p], level[k] + 1)
    self.nlevel = int(level.max()) + 1 if nv else 0
    self.level = level.astype(np.int32)

    # factor schedule: per level of k, update triples over strict
    # ancestors (i >= j on one chain): M[i,j] -= M[k,i] M[k,j] / D[k]
    fac = []
    for lv in range(self.nlevel):
      ki, kj, tgt, kd = [], [], [], []
      for k in range(nv):
        if level[k] != lv:
          continue
        strict = anc[k][:-1]                 # exclude self
        dk = madr[(k, k)]
        for a_idx, i in enumerate(strict):
          for j in strict[:a_idx + 1]:       # j <= i (ascending order)
            ki.append(madr[(k, i)])
            kj.append(madr[(k, j)])
            tgt.append(madr[(i, j)])
            kd.append(dk)
      fac.append((np.asarray(ki, np.int32), np.asarray(kj, np.int32),
                  np.asarray(tgt, np.int32), np.asarray(kd, np.int32)))
    self.fac_levels = fac

    # solve schedule: per level of k, its strict-ancestor entries
    # (e_k dof, e_i ancestor dof, e_madr slot of L[k, i])
    sol = []
    for lv in range(self.nlevel):
      ek, ei, em = [], [], []
      for k in range(nv):
        if level[k] != lv:
          continue
        for i in anc[k][:-1]:
          ek.append(k)
          ei.append(i)
          em.append(madr[(k, i)])
      sol.append((np.asarray(ek, np.int32), np.asarray(ei, np.int32),
                  np.asarray(em, np.int32)))
    self.solve_levels = sol

    self._hash = hash((nv, self.nM, parent.tobytes()))

  def __hash__(self):
    return self._hash

  def __eq__(self, other):
    return (isinstance(other, QMMeta) and self.nv == other.nv and
            self.nM == other.nM and self._hash == other._hash)

  def __repr__(self):
    return f'QMMeta(nv={self.nv}, nM={self.nM}, nlevel={self.nlevel})'


# ---------------------------------------------------------------------------
# batched sparse ops — all batch-polymorphic over leading dims
# ---------------------------------------------------------------------------


def qm_from_crb(meta: QMMeta, cdof: jax.Array, crb_dof: jax.Array,
                armature: jax.Array) -> jax.Array:
  """Assemble packed qM values from composite inertias.

  cdof: (..., nv, 6) motion dofs, crb_dof: (..., nv, 6) = crb inertia of
  dof's body applied to cdof (inert_mul), armature: (nv,).
  qM[i, j] = cdof[j] . (I_b(i) cdof[i]) for j ancestor-or-self of i
  (reference smooth.py:889 _crb; C mj_crb)."""
  buf_i = jnp.take(crb_dof, meta.row, axis=-2)     # (..., nM, 6)
  cd_j = jnp.take(cdof, meta.col, axis=-2)         # (..., nM, 6)
  vals = jnp.sum(buf_i * cd_j, axis=-1)            # (..., nM)
  return vals.at[..., meta.diag_madr].add(armature)


def factor(meta: QMMeta, vals: jax.Array,
           diag: jax.Array | None = None) -> jax.Array:
  """Level-scheduled LDL^T of packed qM values (+ optional extra
  diagonal, e.g. Euler damping h*dof_damping — tree sparsity is
  preserved). Returns the packed factor: scaled L off-diagonal, D on
  the diagonal."""
  if diag is not None:
    vals = vals.at[..., meta.diag_madr].add(
        jnp.broadcast_to(diag, vals.shape[:-1] + (meta.nv,)))
  for ki, kj, tgt, kd in meta.fac_levels:
    if len(tgt) == 0:
      continue
    upd = -(jnp.take(vals, ki, axis=-1) * jnp.take(vals, kj, axis=-1) /
            jnp.maximum(jnp.take(vals, kd, axis=-1), 1e-15))
    vals = vals.at[..., tgt].add(upd)
  # scale: L[k, i] = M'[k, i] / D[k]
  if len(meta.offdiag_madr):
    dk = jnp.maximum(jnp.take(vals, meta.offdiag_rowdiag, axis=-1), 1e-15)
    vals = vals.at[..., meta.offdiag_madr].set(
        jnp.take(vals, meta.offdiag_madr, axis=-1) / dk)
  return vals


def solve(meta: QMMeta, ld: jax.Array, b: jax.Array) -> jax.Array:
  """Solve (L^T D L) x = b from the packed factor (C mj_solveLD;
  reference smooth.py:2697 fused sparse solve)."""
  x = b
  # x <- inv(L^T) x: leaves first (updates flow to ancestors)
  for ek, ei, em in meta.solve_levels:
    if len(ek) == 0:
      continue
    x = x.at[..., ei].add(-jnp.take(ld, em, axis=-1) *
                          jnp.take(x, ek, axis=-1))
  # x <- inv(D) x
  x = x / jnp.maximum(jnp.take(ld, meta.diag_madr, axis=-1), 1e-15)
  # x <- inv(L) x: roots first (each dof gathers from its ancestors)
  for ek, ei, em in reversed(meta.solve_levels):
    if len(ek) == 0:
      continue
    x = x.at[..., ek].add(-jnp.take(ld, em, axis=-1) *
                          jnp.take(x, ei, axis=-1))
  return x


def factor_solve(meta: QMMeta, vals: jax.Array, b: jax.Array,
                 diag: jax.Array | None = None):
  """Factor + solve; returns (x, packed factor)."""
  ld = factor(meta, vals, diag=diag)
  return solve(meta, ld, b), ld


def mul_m(meta: QMMeta, vals: jax.Array, x: jax.Array) -> jax.Array:
  """y = M x from packed (unfactored) qM values."""
  xv = jnp.take(x, meta.col, axis=-1) * vals       # (..., nM)
  y = jnp.zeros_like(x).at[..., meta.row].add(xv)
  # symmetric part (strict lower transposed)
  off = meta.offdiag_madr
  if len(off):
    xo = (jnp.take(x, meta.row[off], axis=-1) *
          jnp.take(vals, off, axis=-1))
    y = y.at[..., meta.col[off]].add(xo)
  return y


def to_dense(meta: QMMeta, vals: jax.Array) -> jax.Array:
  """Densify packed values (tests / oracle comparison only)."""
  shape = vals.shape[:-1] + (meta.nv, meta.nv)
  flat = jnp.zeros(vals.shape[:-1] + (meta.nv * meta.nv,), vals.dtype)
  lin_lower = meta.row.astype(np.int64) * meta.nv + meta.col
  flat = flat.at[..., lin_lower].set(vals)
  off = meta.offdiag_madr
  if len(off):
    lin_upper = meta.col[off].astype(np.int64) * meta.nv + meta.row[off]
    flat = flat.at[..., lin_upper].set(jnp.take(vals, off, axis=-1))
  return flat.reshape(shape)
