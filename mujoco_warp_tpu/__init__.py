"""mujoco_warp_tpu — a batched MuJoCo-class physics engine in JAX.

Same capabilities as the GPU reference (mujoco_warp), re-designed for
JAX/XLA: single-world pure-functional pipeline, vmap over worlds,
sharding over a device mesh. See SURVEY.md for the layer map.
"""

import os as _os

import jax as _jax

# Persistent compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it and the package sets nothing; otherwise the cache lives at
# a fixed path in the checkout (a fixed path, because the path is part of
# the cache key).
if not _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
  _jax.config.update('jax_compilation_cache_dir', _os.path.join(
      _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
      '.mjwt_cache'))
  _jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
  _jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)

from .io import (
    find_keys,
    get_data_into,
    make_data,
    make_trajectory,
    override_model,
    put_data,
    put_model,
    reset_data,
    reset_data_masked,
    set_const,
)
from .types import (
    BiasType,
    ConeType,
    ConstraintType,
    Contact,
    Data,
    DisableBit,
    DynType,
    EnableBit,
    EqType,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    ObjType,
    Option,
    SensorType,
    SolverType,
    State,
    Statistic,
    TrnType,
)
from .inverse import inverse
from .support import (
    contact_force,
    get_state,
    jac,
    mul_m,
    set_state,
    state_size,
    xfrc_accumulate,
)
from .forward import (
    euler,
    forward,
    forward_batched,
    fwd_acceleration,
    fwd_actuation,
    fwd_position,
    fwd_velocity,
    implicit,
    rungekutta4,
    step,
    step1,
    step2,
    step_batched,
)
from .solver import solve
from .collision_driver import collision
from .constraint import make_constraint
from . import collision_driver
from . import collision_primitive
from . import constraint
from . import derivative
from . import math
from . import passive
from . import sensor
from . import ray
from . import render
from . import smooth
from . import solver
from . import support

__version__ = '0.1.0'
