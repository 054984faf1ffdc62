"""Test harness: by default the suite runs on the CPU with 8 virtual
devices, so sharding tests work without several accelerators (analogue
of the reference's CPU-backend CI, mujoco_warp/conftest.py:21-52 +
ci.yml). MJWT_TEST_PLATFORM=cuda,cpu runs it on the GPU with the CPU
beside it; tests marked `gpu` take the `gpu` fixture and skip where the
default device is not a GPU.
"""

import os

import jax
import pytest

_platform = os.environ.get('MJWT_TEST_PLATFORM', 'cpu')
jax.config.update('jax_platforms', _platform)
if _platform == 'cpu':
  jax.config.update('jax_num_cpu_devices', 8)


@pytest.fixture
def gpu():
  """The default device, which must be a GPU: the test skips otherwise."""
  dev = jax.devices()[0]
  if dev.platform != 'gpu':
    pytest.skip('needs a GPU (MJWT_TEST_PLATFORM=cuda)')
  return dev
