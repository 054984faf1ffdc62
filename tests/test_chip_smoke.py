"""chip_smoke.py's comparison helpers on CPU data, and its refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def test_world_err_is_relative_to_each_worlds_largest_entry():
  ref = np.array([[10.0, -20.0], [0.1, 0.2]])
  a = ref + np.array([[0.2, 0.0], [0.0, 0.05]])
  # world 0: 0.2 / 20; world 1: scale floored at 1, so 0.05 / 1
  np.testing.assert_allclose(chip_smoke.world_err(a, ref), [0.01, 0.05])


def test_world_err_flattens_trailing_axes():
  ref = np.ones((3, 2, 4))
  a = ref.copy()
  a[1, 1, 3] += 0.5
  np.testing.assert_allclose(chip_smoke.world_err(a, ref), [0, 0.5, 0])


def test_check_passes_within_and_fails_beyond_tolerance(capsys):
  assert chip_smoke.check('x', [1e-5, 2e-4], 2e-4)
  assert not chip_smoke.check('x', [1e-5, 3e-4], 2e-4)
  assert not chip_smoke.check('x', [np.nan], 1.0)
  assert capsys.readouterr().out.count('FAIL') == 2


def test_refuses_to_run_on_the_cpu():
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=_REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
  assert out.returncode != 0
  for line in out.stdout.splitlines():
    assert '"ok"' not in line, line
  assert 'not gpu' in out.stderr or 'no GPU' in out.stderr
