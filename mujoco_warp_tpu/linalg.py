"""Dense SPD linear algebra for one world (vmap supplies the batch).

Cholesky factorization and triangular solves go to XLA's own
``cholesky`` and ``triangular_solve``, which lower to library calls
(cuSOLVER and cuBLAS on a GPU, LAPACK on the CPU) and batch under vmap.
An unrolled elementwise formulation would fuse into the surrounding
kernels instead, but on the GPU it compiled into giant fused kernels
whose code generation dominated the step's compile time (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky(a: jax.Array) -> jax.Array:
  """Lower Cholesky factor of SPD (n, n); the strictly-upper part is
  zero."""
  if a.shape[-1] == 0:           # static-only models (nv = 0)
    return a
  return jnp.tril(jax.lax.linalg.cholesky(a, symmetrize_input=False))


def solve_lower(l: jax.Array, b: jax.Array) -> jax.Array:
  """Solve L x = b with lower-triangular L."""
  return jax.lax.linalg.triangular_solve(
      l, b[..., None], left_side=True, lower=True)[..., 0]


def solve_upper_t(l: jax.Array, b: jax.Array) -> jax.Array:
  """Solve L^T x = b with lower-triangular L."""
  return jax.lax.linalg.triangular_solve(
      l, b[..., None], left_side=True, lower=True, transpose_a=True)[..., 0]


def cho_solve(l: jax.Array, b: jax.Array) -> jax.Array:
  """Solve A x = b given A's lower Cholesky factor."""
  if l.shape[-1] == 0:
    return b
  return solve_upper_t(l, solve_lower(l, b))


def spd_solve(a: jax.Array, b: jax.Array) -> jax.Array:
  """Solve SPD A x = b."""
  return cho_solve(cholesky(a), b)
