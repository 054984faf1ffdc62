"""The persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is
set the package leaves the cache directory to JAX, otherwise it uses the
fixed <checkout>/.mjwt_cache."""

import os
import subprocess
import sys
import uuid

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# prints the cache directory in effect, then compiles a program no other
# test compiles (a fresh constant), small enough that the test lowers
# JAX's size and time floors to get it written
_CODE = """
import jax
import mujoco_warp_tpu
print(jax.config.jax_compilation_cache_dir, flush=True)
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)
jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
import jax.numpy as jnp
jax.jit(lambda x: jnp.sin(x) * %r)(jnp.ones(3)).block_until_ready()
"""


def _run(env):
  env = {**env, 'JAX_PLATFORMS': 'cpu'}
  code = _CODE % (uuid.uuid4().int % 10**6 / 7.0)
  out = subprocess.run([sys.executable, '-c', code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
  return out.stdout.splitlines()[0]


def _entries(path):
  return set(os.listdir(path)) if os.path.isdir(path) else set()


def test_cache_dir_from_environment(tmp_path):
  env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
  assert _run(env) == str(tmp_path)
  assert _entries(str(tmp_path))


def test_cache_dir_default_in_checkout():
  env = {k: v for k, v in os.environ.items()
         if k != 'JAX_COMPILATION_CACHE_DIR'}
  default = os.path.join(_REPO, '.mjwt_cache')
  before = _entries(default)
  assert _run(env) == default
  assert _entries(default) - before
