"""Benchmark scene assets (standard MJCF models)."""

import os

_DIR = os.path.dirname(__file__)


def path(name: str) -> str:
  return os.path.join(_DIR, name if name.endswith('.xml') else name + '.xml')


def snapshot_path(name: str) -> str:
  """The Model snapshot of a model (tools/write_model_snapshot.py)."""
  return os.path.join(_DIR, name + '.npz')


HUMANOID = path('humanoid')
THREE_HUMANOIDS = path('three_humanoids')
BOXES = path('boxes')
ARM = path('arm')
