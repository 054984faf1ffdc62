"""Constraint solver: projected Newton and CG on the primal qacc problem
(reference: mujoco_warp/_src/solver.py; C mj_solPrimal).

Structure: the whole solve is one ``lax.while_loop`` whose carried
state is a small pytree; per-world convergence uses a ``done`` flag
folded into every update — the XLA equivalent of the reference's
conditional CUDA graph ``wp.capture_while`` + per-world early-outs
(solver.py:3327-3343, 3151-3254).

All math is written **batch-polymorphic**: arrays are (..., nj, nv) /
(..., nj) with an optional leading world axis. ``solve`` is used both
single-world (tests, vmap fallback) and batch-native (the perf path,
``forward.step_batched``).

The linesearch is the exact convex piecewise-quadratic minimization
(reference's iterative variant, solver.py:887-1343) implemented as a
fixed-iteration safeguarded-Newton bisection over masked row quadratics —
branch-free, so it vectorizes over worlds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from . import linalg
from .types import (ConeType, ConstraintType, Data, DisableBit, Model,
                    SolverType)

_MINVAL = 1e-15
_EINSUM = dict(precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Ctx:
  qacc: jax.Array
  Ma: jax.Array          # M @ qacc
  jaref: jax.Array       # J @ qacc - aref
  force: jax.Array       # efc forces
  qfrc_constraint: jax.Array
  grad: jax.Array
  mgrad: jax.Array
  search: jax.Array
  prev_grad: jax.Array
  prev_mgrad: jax.Array
  cost: jax.Array
  prev_cost: jax.Array
  solver_niter: jax.Array
  done: jax.Array


def spd_solve(a: jax.Array, b: jax.Array) -> jax.Array:
  """SPD solve over an optional leading world axis (linalg.spd_solve).

  NOTE: for M-structured matrices prefer m_solve_* (sparse-qM aware);
  this entry serves general SPD systems (Newton Hessians)."""
  if a.ndim == 3:
    return jax.vmap(linalg.spd_solve)(a, b)
  return linalg.spd_solve(a, b)


def m_solve_factor(m: Model, a: jax.Array, b: jax.Array,
                   diag: jax.Array | None = None):
  """Factor + solve for MASS-MATRIX-structured systems (A = qM [+ diag]).
  Returns (x, factor); the factor is the packed sparse LD when the model
  is in sparse-qM mode and the dense Cholesky factor otherwise (pair
  with m_cho_solve)."""
  if m.qm_meta is not None:                 # packed (..., nM) values
    from . import sparse as sparse_mod
    return sparse_mod.factor_solve(m.qm_meta, a, b, diag=diag)
  if diag is not None:
    dmat = jnp.diag(diag)
    a = a + (dmat[None] if a.ndim == 3 else dmat)
  if a.ndim == 3:
    l = jax.vmap(linalg.cholesky)(a)
    return jax.vmap(linalg.cho_solve)(l, b), l
  l = linalg.cholesky(a)
  return linalg.cho_solve(l, b), l


def m_cho_solve(m: Model, fac: jax.Array, b: jax.Array) -> jax.Array:
  """Solve from the factor produced by m_solve_factor."""
  if m.qm_meta is not None:
    from . import sparse as sparse_mod
    return sparse_mod.solve(m.qm_meta, fac, b)
  if fac.ndim == 3:
    return jax.vmap(linalg.cho_solve)(fac, b)
  return linalg.cho_solve(fac, b)


def _mul_qm(m: Model, d: Data, x: jax.Array) -> jax.Array:
  """qM @ x, dense or packed-sparse depending on the model mode."""
  if m.qm_meta is not None:
    from . import sparse as sparse_mod
    return sparse_mod.mul_m(m.qm_meta, d.qM, x)
  return jnp.einsum('...ij,...j->...i', d.qM, x, **_EINSUM)


def _rescale(m: Model, value):
  return value / (jnp.maximum(m.stat.meaninertia, _MINVAL) *
                  jnp.maximum(1, m.nv))


def _row_masks(m: Model, efc_type):
  is_eq = efc_type == ConstraintType.EQUALITY
  is_fr = (efc_type == ConstraintType.FRICTION_DOF) | (
      efc_type == ConstraintType.FRICTION_TENDON)
  is_ell = efc_type == ConstraintType.CONTACT_ELLIPTIC
  is_oneside = ~is_eq & ~is_fr & ~is_ell
  return is_eq, is_fr, is_oneside


def _elliptic_layout(m: Model, d: Data):
  """Static (base, stride) of the contact row block, or None when the
  model has no elliptic contacts."""
  if m.opt.cone != ConeType.ELLIPTIC:
    return None
  nconmax = d.contact.dist.shape[-1]
  from . import io as io_mod
  ne, nf, nl, stride, njmax = io_mod.efc_layout(m, nconmax)
  if nconmax == 0 or stride < 2:
    return None
  return ne + nf + nl, stride, nconmax


def _elliptic_quantities(m: Model, d: Data, jaref):
  """Per-contact cone quantities from the contact block of jaref:
  returns (N, T, u, mu, s, is_ell_con) with shapes (..., C) / (..., C, S).
  u is the cone-scaled row vector (row 0 scaled by mu, friction rows by
  their own coefficient); s the per-row scale factors."""
  lay = _elliptic_layout(m, d)
  base, S, C = lay
  x = jaref[..., base:base + C * S]
  x = x.reshape(x.shape[:-1] + (C, S))
  friction = d.contact.friction                    # (..., C, 5)
  dim = d.contact.dim                              # (..., C)
  mu = friction[..., 0] / jnp.sqrt(jnp.maximum(m.opt.impratio, _MINVAL))
  import numpy as np
  r = np.arange(S)
  fr_row = friction[..., np.clip(r - 1, 0, 4)]     # (..., C, S)
  s = jnp.where(jnp.asarray(r == 0), mu[..., None], fr_row)  # (..., C, S)
  rowvalid = (jnp.asarray(r) < jnp.maximum(dim[..., None], 1)) & (
      jnp.asarray(r == 0) | (dim[..., None] > 1))
  u = x * s * rowvalid
  N = u[..., 0]
  T = jnp.sqrt(jnp.maximum(jnp.sum(u[..., 1:] ** 2, axis=-1), 0.0))
  is_ell_con = (dim > 1) & (d.contact.geom[..., 0] >= 0)
  return base, S, C, x, u, N, T, mu, s, rowvalid, is_ell_con


def _elliptic_zones(N, T, mu):
  top = N >= mu * T
  bottom = ~top & (mu * N + T <= 0)
  middle = ~top & ~bottom
  return top, bottom, middle


def _update_constraint(m: Model, d: Data, jaref):
  """Per-row force, cost, active state (reference solver.py:1805-1953).
  jaref: (..., nj). Returns (force, qfrc_constraint, cost, quad,
  cone_middle) where cone_middle (or None) marks elliptic contacts in
  the middle (cone-surface) zone."""
  is_eq, is_fr, is_one = _row_masks(m, d.efc_type)
  D = d.efc_D
  fl = d.efc_frictionloss
  rf = fl / jnp.maximum(D, _MINVAL)

  lin_neg = is_fr & (jaref <= -rf)
  lin_pos = is_fr & (jaref >= rf)
  quad_fr = is_fr & ~lin_neg & ~lin_pos
  quad_one = is_one & (jaref < 0.0)
  quad = is_eq | quad_fr | quad_one

  force = jnp.where(quad, -D * jaref, 0.0)
  force = jnp.where(lin_neg, fl, force)
  force = jnp.where(lin_pos, -fl, force)

  cost_rows = jnp.where(quad, 0.5 * D * jaref * jaref, 0.0)
  cost_rows = jnp.where(lin_neg, -fl * (0.5 * rf + jaref), cost_rows)
  cost_rows = jnp.where(lin_pos, -fl * (0.5 * rf - jaref), cost_rows)

  cone_middle = None
  if _elliptic_layout(m, d) is not None:
    # elliptic contacts: zone logic per contact block (reference
    # update_constraint_efc elliptic branch)
    (base, S, C, x, u, N, T, mu, s, rowvalid,
     is_ell) = _elliptic_quantities(m, d, jaref)
    top, bottom, middle = _elliptic_zones(N, T, mu)
    top, bottom, middle = [z & is_ell for z in (top, bottom, middle)]
    Dblk = d.efc_D[..., base:base + C * S]
    Dblk = Dblk.reshape(Dblk.shape[:-1] + (C, S))
    d0 = Dblk[..., 0]
    mu2 = mu * mu
    dm = d0 / jnp.maximum(mu2 * (1.0 + mu2), _MINVAL)
    nmt = N - mu * T
    f_norm = -dm * nmt * mu
    Tsafe = jnp.maximum(T, _MINVAL)
    f_fric = -f_norm[..., None] / Tsafe[..., None] * (u * s)
    f_mid = jnp.concatenate([f_norm[..., None], f_fric[..., 1:]], axis=-1)
    f_bot = -Dblk * x
    f_blk = jnp.where(middle[..., None], f_mid,
                      jnp.where(bottom[..., None], f_bot, 0.0)) * rowvalid
    c_mid = 0.5 * dm * nmt * nmt
    c_bot = jnp.sum(0.5 * Dblk * x * x * rowvalid, axis=-1)
    c_blk = jnp.where(middle, c_mid, jnp.where(bottom, c_bot, 0.0))
    # merge: replace rows of elliptic contacts in the flat arrays
    ell_rows = jnp.broadcast_to(is_ell[..., None],
                                is_ell.shape + (S,)).reshape(
        is_ell.shape[:-1] + (C * S,))
    force = force.at[..., base:base + C * S].set(
        jnp.where(ell_rows, f_blk.reshape(f_blk.shape[:-2] + (C * S,)),
                  force[..., base:base + C * S]))
    # cost: zero out the elliptic rows' independent cost, add block cost
    cost_rows = cost_rows.at[..., base:base + C * S].set(
        jnp.where(ell_rows, 0.0, cost_rows[..., base:base + C * S]))
    cost_rows = cost_rows.at[..., base].add(
        jnp.sum(jnp.where(is_ell, c_blk, 0.0), axis=-1))
    # quad flag: elliptic rows quadratic only in the bottom zone
    quad_blk = jnp.broadcast_to((bottom & is_ell)[..., None],
                                bottom.shape + (S,)) & rowvalid
    quad = quad.at[..., base:base + C * S].set(
        jnp.where(ell_rows,
                  quad_blk.reshape(quad_blk.shape[:-2] + (C * S,)),
                  quad[..., base:base + C * S]))
    cone_middle = middle & is_ell

  cost = jnp.sum(cost_rows, axis=-1)
  qfrc_constraint = jnp.einsum('...jn,...j->...n', d.efc_J, force,
                               **_EINSUM)
  return force, qfrc_constraint, cost, quad, cone_middle


def _gauss_cost(m: Model, d: Data, qacc, ma):
  return 0.5 * jnp.sum((ma - d.qfrc_smooth) * (qacc - d.qacc_smooth),
                       axis=-1)


def _update_gradient(m: Model, d: Data, ctx_grad_inputs, jaref=None,
                     cone_middle=None):
  """grad, and Mgrad via Newton Hessian or CG preconditioner."""
  ma, qfrc_constraint, quad = ctx_grad_inputs
  grad = ma - d.qfrc_smooth - qfrc_constraint
  if m.opt.solver == SolverType.NEWTON:
    dh = d.efc_D * quad.astype(d.efc_D.dtype)
    # H = M + J^T diag(Dh) J — batched matmul (reference solver.py:2368)
    jd = d.efc_J * dh[..., None]
    h = d.qM + jnp.einsum('...jn,...jk->...nk', jd, d.efc_J, **_EINSUM)
    if cone_middle is not None:
      # elliptic cone-surface Hessian correction H += Jc^T C Jc per
      # middle-zone contact (reference update_gradient_JTCJ math)
      (base, S, C, x, u, N, T, mu, s, rowvalid,
       is_ell) = _elliptic_quantities(m, d, jaref)
      Dblk = d.efc_D[..., base:base + C * S]
      d0 = Dblk.reshape(Dblk.shape[:-1] + (C, S))[..., 0]
      mu2 = mu * mu
      dm = d0 / jnp.maximum(mu2 * (1.0 + mu2), _MINVAL)
      Tsafe = jnp.maximum(T, _MINVAL)
      T3 = jnp.maximum(T * Tsafe * Tsafe, _MINVAL)
      import numpy as np
      r = np.arange(S)
      is0 = jnp.asarray(r == 0)
      # hcone in scaled coordinates (..., C, S, S)
      ui = u[..., :, None]
      uj = u[..., None, :]
      hc = (mu[..., None, None] * N[..., None, None] / T3[..., None, None]
            ) * ui * uj
      diag = jnp.eye(S, dtype=u.dtype)
      hc = hc + diag * (mu2 - mu * N / Tsafe)[..., None, None]
      # first row/column overrides
      mu_over_t = (mu / Tsafe)[..., None]
      hc = hc.at[..., 0, :].set(-mu_over_t * u)
      hc = hc.at[..., :, 0].set(-mu_over_t * u)
      hc = hc.at[..., 0, 0].set(1.0)
      scale = dm[..., None, None] * s[..., :, None] * s[..., None, :]
      mask = (cone_middle[..., None, None] &
              rowvalid[..., :, None] & rowvalid[..., None, :])
      Cblk = hc * scale * mask
      Jc = d.efc_J[..., base:base + C * S, :]
      Jc = Jc.reshape(Jc.shape[:-2] + (C, S, Jc.shape[-1]))
      h = h + jnp.einsum('...csn,...cst,...ctk->...nk', Jc, Cblk, Jc,
                         **_EINSUM)
      # f32 guard: the cone Hessian is PSD in exact arithmetic but can
      # round indefinite when impratio skews the row scales; a relative
      # Tikhonov floor keeps the factorization sane (error ~1e-7 rel,
      # far below the solver tolerance floor)
      nv = h.shape[-1]
      tr = jnp.trace(h, axis1=-2, axis2=-1) / nv
      h = h + (1e-7 * tr)[..., None, None] * jnp.eye(nv, dtype=h.dtype)
    mgrad = spd_solve(h, grad)
  else:
    mgrad = m_cho_solve(m, d.qLD, grad)
  return grad, mgrad


def _linesearch(m: Model, d: Data, ctx: _Ctx):
  """Exact convex piecewise-quadratic linesearch along ctx.search.
  All scalars are (...,) shaped (one per world)."""
  p = ctx.search
  mv = _mul_qm(m, d, p)
  jv = jnp.einsum('...jn,...n->...j', d.efc_J, p, **_EINSUM)

  # gauss quadratic: phi_g'(a) = g0 + a h0
  g0 = jnp.sum(p * (ctx.Ma - d.qfrc_smooth), axis=-1)
  h0 = jnp.sum(p * mv, axis=-1)

  is_eq, is_fr, is_one = _row_masks(m, d.efc_type)
  D = d.efc_D
  fl = d.efc_frictionloss
  rf = fl / jnp.maximum(D, _MINVAL)
  jaref = ctx.jaref

  ell = _elliptic_layout(m, d)
  if ell is not None:
    (base, S, C, x0blk, u0blk, _, _, mu_e, s_e, rowvalid_e,
     is_ell_con) = _elliptic_quantities(m, d, jaref)
    jvblk = jv[..., base:base + C * S]
    jvblk = jvblk.reshape(jvblk.shape[:-1] + (C, S)) * rowvalid_e
    vblk = jvblk * s_e                       # scaled jv rows
    Dblk_e = d.efc_D[..., base:base + C * S]
    Dblk_e = Dblk_e.reshape(Dblk_e.shape[:-1] + (C, S))
    d0_e = Dblk_e[..., 0]
    mu2_e = mu_e * mu_e
    dm_e = d0_e / jnp.maximum(mu2_e * (1.0 + mu2_e), _MINVAL)

  def phi_d(alpha):
    """(phi'(alpha), phi''(alpha)) — (...,) each; alpha (...,)."""
    x = jaref + alpha[..., None] * jv
    lin_neg = is_fr & (x <= -rf)
    lin_pos = is_fr & (x >= rf)
    quad = is_eq | (is_fr & ~lin_neg & ~lin_pos) | (is_one & (x < 0.0))
    d1_rows = jnp.where(quad, D * x * jv, 0.0)
    d1_rows = d1_rows + jnp.where(lin_neg, -fl * jv, 0.0)
    d1_rows = d1_rows + jnp.where(lin_pos, fl * jv, 0.0)
    d2_rows = jnp.where(quad, D * jv * jv, 0.0)
    d1 = g0 + alpha * h0 + jnp.sum(d1_rows, axis=-1)
    d2 = h0 + jnp.sum(d2_rows, axis=-1)
    if ell is not None:
      # cone contribution per elliptic contact (reference _eval_elliptic)
      xb = x[..., base:base + C * S]
      xb = xb.reshape(xb.shape[:-1] + (C, S)) * rowvalid_e
      ub = xb * s_e
      Na = ub[..., 0]
      N1 = vblk[..., 0]
      Ta = jnp.sqrt(jnp.maximum(jnp.sum(ub[..., 1:] ** 2, axis=-1),
                                _MINVAL))
      T1 = jnp.sum(ub[..., 1:] * vblk[..., 1:], axis=-1) / Ta
      T2 = (jnp.sum(vblk[..., 1:] ** 2, axis=-1) - T1 * T1) / Ta
      top, bottom, middle = _elliptic_zones(Na, Ta, mu_e)
      top, bottom, middle = [z & is_ell_con for z in (top, bottom, middle)]
      nmt = Na - mu_e * Ta
      n1mt1 = N1 - mu_e * T1
      d1_mid = dm_e * nmt * n1mt1
      d2_mid = dm_e * (n1mt1 * n1mt1 - nmt * mu_e * T2)
      d1_bot = jnp.sum(Dblk_e * xb * jvblk, axis=-1)
      d2_bot = jnp.sum(Dblk_e * jvblk * jvblk, axis=-1)
      d1 = d1 + jnp.sum(jnp.where(middle, d1_mid,
                                  jnp.where(bottom, d1_bot, 0.0)),
                        axis=-1)
      d2 = d2 + jnp.sum(jnp.where(middle, d2_mid,
                                  jnp.where(bottom, d2_bot, 0.0)),
                        axis=-1)
    return d1, d2

  zero = jnp.zeros_like(g0)
  p1_0, p2_0 = phi_d(zero)
  alpha0 = -p1_0 / jnp.maximum(p2_0, _MINVAL)
  alpha0 = jnp.maximum(alpha0, 0.0)

  if m.opt.ls_parallel:
    # Parallel multi-alpha linesearch (reference solver.py:481): phi' is
    # piecewise-LINEAR monotone (the cost is piecewise quadratic), so
    # bracket the root over log-spaced candidates around the
    # unconstrained Newton step, then one secant (exact within a piece)
    # + one Newton polish. ~6 fused kernels total instead of the
    # iterative variant's ~100.
    K = 10
    scales = jnp.logspace(-3.0, 0.7, K).astype(jaref.dtype)  # 1e-3..5
    alphas = alpha0[..., None] * scales          # (..., K)
    p1_k, _ = jax.vmap(phi_d, in_axes=-1, out_axes=-1)(alphas)
    # lo = largest candidate with phi' < 0; hi = smallest with phi' >= 0
    neg = p1_k < 0
    any_neg = jnp.any(neg, axis=-1)
    big = jnp.full_like(alphas, jnp.inf)
    # phi' is monotone: the largest negative-phi' candidate is the
    # bracket's lower end; alpha=0 (where phi' = p1_0 < 0) is the
    # implicit lower end when every candidate is already positive
    lo = jnp.where(any_neg, jnp.max(jnp.where(neg, alphas, 0.0), axis=-1),
                   0.0)
    p1_lo = jnp.where(any_neg,
                      jnp.max(jnp.where(neg, p1_k, -jnp.inf), axis=-1),
                      p1_0)
    hi = jnp.min(jnp.where(neg, big, alphas), axis=-1)
    p1_hi = jnp.min(jnp.where(neg, big, p1_k), axis=-1)
    any_hi = jnp.isfinite(hi)
    # secant within the bracket (exact if no kink between lo and hi)
    denom = jnp.where(jnp.abs(p1_hi - p1_lo) < _MINVAL, 1.0, p1_hi - p1_lo)
    secant = lo - p1_lo * (hi - lo) / denom
    # no bracket above: Newton from the largest candidate
    a_max = alphas[..., -1]
    p1_m, p2_m = phi_d(a_max)
    newton_tail = a_max - p1_m / jnp.maximum(p2_m, _MINVAL)
    alpha = jnp.where(any_hi, secant, jnp.maximum(newton_tail, 0.0))
    # Newton polish: converges across remaining kinks (phi convex).
    # Cap the step at a multiple of the largest bracket candidate so a
    # near-zero phi'' (f32) cannot launch a divergent alpha.
    alpha_cap = 10.0 * a_max
    for _ in range(3):
      p1_a, p2_a = phi_d(alpha)
      alpha = alpha - p1_a / jnp.maximum(p2_a, _MINVAL)
      alpha = jnp.clip(alpha, 0.0, alpha_cap)
    alpha = jnp.where(p1_0 >= 0, 0.0, alpha)
    return alpha, mv, jv

  def body(_, state):
    alpha, lo, hi, has_hi, done_ls = state
    p1, p2 = phi_d(alpha)
    new_lo = jnp.where(p1 < 0, alpha, lo)
    new_hi = jnp.where(p1 >= 0, alpha, hi)
    new_has_hi = has_hi | (p1 >= 0)
    newton = alpha - p1 / jnp.maximum(p2, _MINVAL)
    grow = jnp.maximum(newton, 2.0 * jnp.maximum(alpha, 1.0))
    bisect = 0.5 * (new_lo + new_hi)
    in_bracket = (newton > new_lo) & (newton < new_hi)
    nxt = jnp.where(new_has_hi,
                    jnp.where(in_bracket, newton, bisect), grow)
    tol = m.opt.ls_tolerance * jnp.maximum(
        m.stat.meaninertia, _MINVAL) * jnp.maximum(1, m.nv)
    new_done = done_ls | (jnp.abs(p1) < tol)
    alpha = jnp.where(new_done, alpha, nxt)
    return alpha, new_lo, new_hi, new_has_hi, new_done

  state = (alpha0, zero, alpha0, jnp.zeros_like(p1_0, bool), p1_0 >= 0)
  alpha, *_ = jax.lax.fori_loop(0, m.opt.ls_iterations, body, state)
  alpha = jnp.where(p1_0 >= 0, 0.0, alpha)
  return alpha, mv, jv


def _iteration(m: Model, d: Data, ctx: _Ctx) -> _Ctx:
  alpha, mv, jv = _linesearch(m, d, ctx)
  qacc = ctx.qacc + alpha[..., None] * ctx.search
  ma = ctx.Ma + alpha[..., None] * mv
  jaref = ctx.jaref + alpha[..., None] * jv

  force, qfrc_constraint, cost_c, quad, cone_mid = _update_constraint(
      m, d, jaref)
  cost = cost_c + _gauss_cost(m, d, qacc, ma)
  grad, mgrad = _update_gradient(m, d, (ma, qfrc_constraint, quad),
                                 jaref=jaref, cone_middle=cone_mid)

  if m.opt.solver == SolverType.CG:
    beta_num = jnp.sum(grad * (mgrad - ctx.prev_mgrad), axis=-1)
    beta_den = jnp.maximum(jnp.sum(ctx.prev_grad * ctx.prev_mgrad, axis=-1),
                           _MINVAL)
    beta = jnp.maximum(0.0, beta_num / beta_den)
    search = -mgrad + beta[..., None] * ctx.search
    prev_grad, prev_mgrad = grad, mgrad
  else:
    # Newton: search IS -mgrad; keep the CG-only carries dead (zeros)
    # so the while_loop carry stays small (copies cost real time)
    search = -mgrad
    prev_grad, prev_mgrad = ctx.prev_grad, ctx.prev_mgrad

  improvement = _rescale(m, ctx.cost - cost)
  gradient = _rescale(m, jnp.sqrt(jnp.sum(grad * grad, axis=-1)))
  niter = ctx.solver_niter + 1
  done = ctx.done | (improvement < m.opt.tolerance) | (
      gradient < m.opt.tolerance) | (niter >= m.opt.iterations)

  # masked commit: converged worlds keep their state
  def sel(new, old):
    dmask = ctx.done
    if new.ndim > dmask.ndim:
      dmask = dmask[..., None]
    return jnp.where(dmask, old, new)

  new_ctx = _Ctx(
      qacc=sel(qacc, ctx.qacc), Ma=sel(ma, ctx.Ma),
      jaref=sel(jaref, ctx.jaref), force=sel(force, ctx.force),
      qfrc_constraint=sel(qfrc_constraint, ctx.qfrc_constraint),
      grad=sel(grad, ctx.grad), mgrad=sel(mgrad, ctx.mgrad),
      search=sel(search, ctx.search),
      prev_grad=sel(prev_grad, ctx.prev_grad),
      prev_mgrad=sel(prev_mgrad, ctx.prev_mgrad),
      cost=sel(cost, ctx.cost), prev_cost=sel(ctx.cost, ctx.prev_cost),
      solver_niter=jnp.where(ctx.done, ctx.solver_niter, niter),
      done=jnp.where(ctx.done, ctx.done, done))
  return new_ctx


def solve(m: Model, d: Data) -> Data:
  """Entry point (reference solver.py:3296). Works single-world
  ((nj, nv) arrays) or batch-native ((W, nj, nv) arrays)."""
  njmax = d.efc_J.shape[-2]
  batch_shape = d.qpos.shape[:-1]
  if (njmax == 0 or m.nv == 0 or m.opt.iterations == 0 or
      m.opt.disableflags & DisableBit.CONSTRAINT):
    return d.replace(qacc=d.qacc_smooth,
                     qfrc_constraint=jnp.zeros_like(d.qacc_smooth),
                     solver_niter=jnp.zeros(batch_shape, jnp.int32))
  return _solve_xla(m, d)


def _solve_xla(m: Model, d: Data) -> Data:
  """The XLA-level Newton/CG solve (one while_loop over the batch)."""
  dtype = d.qpos.dtype
  batch_shape = d.qpos.shape[:-1]
  if m.opt.disableflags & DisableBit.WARMSTART:
    qacc = d.qacc_smooth
  else:
    qacc = d.qacc_warmstart

  ma = _mul_qm(m, d, qacc)
  jaref = jnp.einsum('...jn,...n->...j', d.efc_J, qacc,
                     **_EINSUM) - d.efc_aref
  force, qfrc_constraint, cost_c, quad, cone_mid = _update_constraint(
      m, d, jaref)
  cost = cost_c + _gauss_cost(m, d, qacc, ma)
  grad, mgrad = _update_gradient(m, d, (ma, qfrc_constraint, quad),
                                 jaref=jaref, cone_middle=cone_mid)

  ctx = _Ctx(
      qacc=qacc, Ma=ma, jaref=jaref, force=force,
      qfrc_constraint=qfrc_constraint, grad=grad, mgrad=mgrad,
      search=-mgrad, prev_grad=grad, prev_mgrad=mgrad, cost=cost,
      prev_cost=jnp.full(batch_shape, jnp.inf, dtype),
      solver_niter=jnp.zeros(batch_shape, jnp.int32),
      done=jnp.zeros(batch_shape, bool))

  # immediate convergence check on the initial gradient
  gradient0 = _rescale(m, jnp.sqrt(jnp.sum(grad * grad, axis=-1)))
  ctx = dataclasses.replace(ctx, done=gradient0 < m.opt.tolerance)

  ctx = jax.lax.while_loop(
      lambda c: ~jnp.all(c.done),
      lambda c: _iteration(m, d, c),
      ctx)

  return d.replace(
      qacc=ctx.qacc, qfrc_constraint=ctx.qfrc_constraint,
      efc_force=ctx.force, solver_niter=ctx.solver_niter)


del Any
