"""Dense Cholesky/solves (linalg.py) against numpy, at the sizes the
models use: nv <= 32 (humanoid) and above (three_humanoids nv=81,
apollo). Reference analogue: block_cholesky.py's wp.tile blocked
factorization."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mujoco_warp_tpu import linalg


def _spd(n, seed):
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((n, n))
  return (a @ a.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize('n', [33, 40, 48, 81])
def test_blocked_cholesky_matches_numpy(n):
  a = _spd(n, n)
  l = np.asarray(linalg.cholesky(jnp.asarray(a)))
  l_np = np.linalg.cholesky(a)
  np.testing.assert_allclose(l, l_np, rtol=2e-4, atol=2e-4)
  # strictly-upper part must be zero (consumers rely on it)
  assert np.allclose(np.triu(l, 1), 0.0)


@pytest.mark.parametrize('n', [33, 81])
def test_blocked_spd_solve_matches_numpy(n):
  a = _spd(n, n + 1)
  b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
  x = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.asarray(b)))
  x_np = np.linalg.solve(a, b)
  np.testing.assert_allclose(x, x_np, rtol=2e-3, atol=2e-3)


def test_blocked_cho_solve_from_factor():
  n = 81
  a = _spd(n, 3)
  b = np.random.default_rng(9).standard_normal(n).astype(np.float32)
  l = linalg.cholesky(jnp.asarray(a))
  x = np.asarray(linalg.cho_solve(l, jnp.asarray(b)))
  np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=2e-3,
                             atol=2e-3)


def test_blocked_batched_under_vmap_and_jit():
  n, w = 40, 6
  aa = np.stack([_spd(n, 100 + i) for i in range(w)])
  bb = np.random.default_rng(1).standard_normal((w, n)).astype(
      np.float32)
  x = np.asarray(jax.jit(jax.vmap(linalg.spd_solve))(
      jnp.asarray(aa), jnp.asarray(bb)))
  for i in range(w):
    np.testing.assert_allclose(x[i], np.linalg.solve(aa[i], bb[i]),
                               rtol=2e-3, atol=2e-3)


def test_unrolled_path_unchanged_small_n():
  n = 7
  a = _spd(n, 5)
  b = np.random.default_rng(2).standard_normal(n).astype(np.float32)
  x = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.asarray(b)))
  np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-4,
                             atol=1e-4)


def test_batched_spd_solve():
  """solver.spd_solve over a leading world axis matches numpy."""
  import importlib
  solver = importlib.import_module('mujoco_warp_tpu.solver')
  rng = np.random.default_rng(0)
  q = rng.normal(size=(8, 5, 5)).astype(np.float32)
  a = jnp.asarray(q @ np.swapaxes(q, 1, 2) + 3 * np.eye(5,
                                                        dtype=np.float32))
  b = jnp.asarray(rng.normal(size=(8, 5)).astype(np.float32))
  x = solver.spd_solve(a, b)
  ref = np.linalg.solve(np.asarray(a), np.asarray(b)[..., None])[..., 0]
  np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-4, atol=1e-4)
