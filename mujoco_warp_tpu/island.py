"""Constraint-island discovery (reference: mujoco_warp/_src/island.py —
tree-tree adjacency + flood fill labelling d.tree_island; the reference
keeps it disconnected from step, forward.py:534-536, and so do we: the
partition exists for future per-island solving).

Vectorized formulation: the per-world serial DFS becomes fixed-iteration
min-label propagation over the tree-tree adjacency matrix — O(log ntree)
matmul-like sweeps, fully vectorized."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .types import Data, Model


def island(m: Model, d: Data) -> jax.Array:
  """Label each kinematic tree with its island id (= min tree id in the
  island); trees with no active constraints keep their own id. Returns
  (ntree,) int32 labels."""
  ntree = max(m.body_treeid) + 1 if m.nbody > 1 else 1
  tree_of_body = jnp.asarray(np.asarray(m.body_treeid, np.int32))
  adj = jnp.eye(ntree, dtype=bool)

  # contacts couple the trees of both geoms' bodies
  nconmax = d.contact.dist.shape[0]
  if nconmax and m.ngeom:
    geom_bodyid = jnp.asarray(m.geom_bodyid)
    g1 = d.contact.geom[:, 0]
    g2 = d.contact.geom[:, 1]
    act = (g1 >= 0) & (d.contact.dist < d.contact.includemargin)
    t1 = tree_of_body[geom_bodyid[jnp.maximum(g1, 0)]]
    t2 = tree_of_body[geom_bodyid[jnp.maximum(g2, 0)]]
    # world/static bodies carry treeid -1 (mjModel convention): they are
    # not part of any tree, so a contact with them couples nothing —
    # mask those out (the reference excludes static bodies likewise)
    act = act & (t1 >= 0) & (t2 >= 0)
    t1 = jnp.maximum(t1, 0)
    t2 = jnp.maximum(t2, 0)
    adj = adj.at[t1, t2].max(act)
    adj = adj.at[t2, t1].max(act)

  # equality constraints couple their objects' trees
  for i in range(m.neq):
    b1 = m.eq_obj1id[i]
    b2 = m.eq_obj2id[i]
    from .types import EqType
    if m.eq_type[i] in (EqType.CONNECT, EqType.WELD):
      t1s = int(m.body_treeid[b1])
      t2s = int(m.body_treeid[b2])
      if t1s < 0 or t2s < 0:  # world/static body: couples nothing
        continue
      adj = adj.at[t1s, t2s].max(d.eq_active[i])
      adj = adj.at[t2s, t1s].max(d.eq_active[i])

  # min-label propagation: label <- min over adjacent labels, ceil(log2)
  labels = jnp.arange(ntree, dtype=jnp.int32)
  iters = max(1, int(np.ceil(np.log2(max(ntree, 2)))) + 1)
  big = jnp.int32(ntree)

  def body(_, lab):
    neigh = jnp.where(adj, lab[None, :], big)
    return jnp.minimum(lab, jnp.min(neigh, axis=1))

  return jax.lax.fori_loop(0, iters, body, labels)
