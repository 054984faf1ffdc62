"""Model snapshots: ``put_model``'s output in one ``.npz`` file.

A snapshot lets a machine without C MuJoCo (the ``mujoco`` package) load
a Model and step it: ``load`` needs only JAX and numpy. The array leaves
are stored as arrays; the static fields (sizes, tree structure, pair
lists, option enums) as JSON in the same file, so loading unpickles
nothing. ``tools/write_model_snapshot.py`` writes the snapshots the repo
ships.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np

from .types import Model

_META_KEY = '__meta__'


def _encode(x, arrays: dict):
  if isinstance(x, (jax.Array, np.ndarray)):
    key = f'a{len(arrays)}'
    arrays[key] = np.asarray(x)
    return {'__array__': key, 'jax': isinstance(x, jax.Array)}
  if dataclasses.is_dataclass(x):
    cls = type(x)
    return {'__dataclass__': f'{cls.__module__}:{cls.__qualname__}',
            'fields': {f.name: _encode(getattr(x, f.name), arrays)
                       for f in dataclasses.fields(x)}}
  if isinstance(x, tuple) and hasattr(x, '_fields'):  # NamedTuple
    cls = type(x)
    return {'__namedtuple__': f'{cls.__module__}:{cls.__qualname__}',
            'fields': {k: _encode(v, arrays) for k, v in x._asdict().items()}}
  if isinstance(x, tuple):
    return {'__tuple__': [_encode(v, arrays) for v in x]}
  if isinstance(x, list):
    return [_encode(v, arrays) for v in x]
  if x is None or isinstance(x, (bool, int, float, str)):
    return x
  from .sparse import QMMeta
  if isinstance(x, QMMeta):  # rebuilt from the model's dof_parentid
    return {'__qm_meta__': True}
  raise TypeError(f'cannot snapshot a {type(x).__name__}')


def _class(path: str):
  module, name = path.split(':')
  if module.split('.')[0] != __name__.split('.')[0]:
    raise ValueError(f'snapshot names a class outside the package: {path}')
  return getattr(importlib.import_module(module), name)


def _decode(x, arrays):
  if isinstance(x, list):
    return [_decode(v, arrays) for v in x]
  if not isinstance(x, dict):
    return x
  if '__array__' in x:
    a = arrays[x['__array__']]
    return jnp.asarray(a) if x['jax'] else a
  if '__tuple__' in x:
    return tuple(_decode(v, arrays) for v in x['__tuple__'])
  if '__dataclass__' in x or '__namedtuple__' in x:
    cls = _class(x.get('__dataclass__') or x['__namedtuple__'])
    fields = {k: _decode(v, arrays) for k, v in x['fields'].items()}
    qm = fields.get('qm_meta')
    if isinstance(qm, dict) and qm.get('__qm_meta__'):
      from .sparse import QMMeta
      fields['qm_meta'] = QMMeta(fields['dof_parentid'])
    return cls(**fields)
  if '__qm_meta__' in x:
    return x
  raise ValueError(f'unknown snapshot entry: {sorted(x)}')


def save(m: Model, path: str) -> None:
  """Write Model ``m`` to ``path`` (an .npz file)."""
  arrays = {}
  meta = json.dumps(_encode(m, arrays))
  np.savez_compressed(path, **arrays, **{_META_KEY: np.asarray(meta)})


def load(path: str) -> Model:
  """Read a Model written by ``save``. Needs neither C MuJoCo nor
  pickle."""
  with np.load(path, allow_pickle=False) as f:
    arrays = {k: f[k] for k in f.files if k != _META_KEY}
    meta = json.loads(str(f[_META_KEY]))
  return _decode(meta, arrays)
