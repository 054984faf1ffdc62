"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).
chip_smoke.py runs them; by hand: MJWT_TEST_PLATFORM=cuda,cpu python -m
pytest tests/test_gpu.py -m gpu."""

import jax
import numpy as np
import pytest

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import models, parallel, snapshot


def _on(tree, device):
  return jax.tree.map(
      lambda x: jax.device_put(x, device) if isinstance(x, jax.Array)
      else x, tree)


@pytest.mark.gpu
def test_step_on_gpu_matches_cpu(gpu):
  """One humanoid step at the benchmark width on the card against the
  same step on JAX's CPU backend, for 64 sampled worlds. The limits are
  chip_smoke.py's TOL_CPU: TF32 products would exceed them."""
  m = snapshot.load(models.snapshot_path('humanoid'))
  b = parallel.make_batch(m, mjwt.make_data(m, nconmax=24), 8192,
                          qpos_noise=0.02)
  idx = np.sort(np.random.default_rng(1).choice(8192, 64, replace=False))
  cpu = jax.devices('cpu')[0]
  m_cpu = _on(m, cpu)
  ref = jax.jit(lambda x: mjwt.step_batched(m_cpu, x))(
      _on(jax.tree.map(lambda x: x[idx], b), cpu))
  out = jax.jit(lambda x: mjwt.step_batched(m, x))(b)
  for f, tol in (('qacc', 1e-3), ('qfrc_constraint', 3e-4),
                 ('efc_force', 3e-4)):
    a = np.asarray(getattr(out, f))[idx].reshape(64, -1)
    r = np.asarray(getattr(ref, f)).reshape(64, -1)
    scale = np.maximum(np.abs(r).max(axis=1), 1.0)
    assert (np.abs(a - r).max(axis=1) / scale).max() <= tol, f
