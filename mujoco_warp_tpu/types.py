"""Core data model: Model / Data / Option / Contact as JAX pytrees.

Design (contrast with reference mujoco_warp/_src/types.py):

* The reference stores per-world state as Warp arrays with a leading
  ``nworld`` dim and launches CUDA kernels over (world, entity) grids.
  Here every structure is a *single-world* pytree of jnp arrays; batching
  over worlds is ``jax.vmap`` of the pure ``step`` function and sharding of
  the resulting leading axis over a ``jax.sharding.Mesh`` (see parallel/).

* Structural metadata (tree topology, joint types, address tables —
  everything the reference precomputes in io.py:77-647) is stored in
  **static** meta fields as nested tuples of Python ints.  Under ``jit``
  these become trace-time constants, so gathers over the kinematic tree
  compile to static slices — the XLA equivalent of the reference baking
  structure into specialized Warp kernels (module="unique").

* Numeric parameters (masses, joint ranges, solref/solimp, actuator gains)
  are traced jnp leaves, so per-world model variation (the reference's
  batched "*" fields, io.py:42-64) is expressed with ``jax.vmap`` over
  Model instead of ``worldid % shape[0]`` indexing.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Enums (values match MuJoCo's C enums; reference types.py:166-638)
# ---------------------------------------------------------------------------


class DisableBit(enum.IntFlag):
  """Matches C mjtDisableBit (mujoco.mjtDisableBit) bit-for-bit."""
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17
  ISLAND = 1 << 18
  MULTICCD = 1 << 19


class EnableBit(enum.IntFlag):
  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3

  def dof_width(self) -> int:
    return {0: 6, 1: 3, 2: 1, 3: 1}[self.value]

  def qpos_width(self) -> int:
    return {0: 7, 1: 4, 2: 1, 3: 1}[self.value]


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  SDF = 8


class SolverType(enum.IntEnum):
  PGS = 0  # unsupported (reference also rejects it)
  CG = 1
  NEWTON = 2


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2  # unsupported
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3
  FLEX = 4


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class WrapType(enum.IntEnum):
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class ConstraintType(enum.IntEnum):
  """efc row types (mjtConstraint)."""
  EQUALITY = 0
  FRICTION_DOF = 1
  FRICTION_TENDON = 2
  LIMIT_JOINT = 3
  LIMIT_TENDON = 4
  CONTACT_FRICTIONLESS = 5
  CONTACT_PYRAMIDAL = 6
  CONTACT_ELLIPTIC = 7


class SensorType(enum.IntEnum):
  """mjtSensor (values verified against mujoco.mjtSensor)."""
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  CAMPROJECTION = 8
  JOINTPOS = 9
  JOINTVEL = 10
  TENDONPOS = 11
  TENDONVEL = 12
  ACTUATORPOS = 13
  ACTUATORVEL = 14
  ACTUATORFRC = 15
  JOINTACTFRC = 16
  TENDONACTFRC = 17
  BALLQUAT = 18
  BALLANGVEL = 19
  JOINTLIMITPOS = 20
  JOINTLIMITVEL = 21
  JOINTLIMITFRC = 22
  TENDONLIMITPOS = 23
  TENDONLIMITVEL = 24
  TENDONLIMITFRC = 25
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  FRAMELINACC = 33
  FRAMEANGACC = 34
  SUBTREECOM = 35
  SUBTREELINVEL = 36
  SUBTREEANGMOM = 37
  INSIDESITE = 38
  GEOMDIST = 39
  GEOMNORMAL = 40
  GEOMFROMTO = 41
  CONTACT = 42
  E_POTENTIAL = 43
  E_KINETIC = 44
  CLOCK = 45
  TACTILE = 46
  PLUGIN = 47
  USER = 48


class State(enum.IntFlag):
  """mjtState component bitflags (reference types.py:598-638)."""
  TIME = 1 << 0
  QPOS = 1 << 1
  QVEL = 1 << 2
  ACT = 1 << 3
  WARMSTART = 1 << 4
  CTRL = 1 << 5
  QFRC_APPLIED = 1 << 6
  XFRC_APPLIED = 1 << 7
  EQ_ACTIVE = 1 << 8
  MOCAP_POS = 1 << 9
  MOCAP_QUAT = 1 << 10
  PHYSICS = QPOS | QVEL | ACT
  FULLPHYSICS = TIME | PHYSICS
  USER = CTRL | QFRC_APPLIED | XFRC_APPLIED | EQ_ACTIVE | MOCAP_POS | \
      MOCAP_QUAT
  INTEGRATION = FULLPHYSICS | USER | WARMSTART


class ObjType(enum.IntEnum):
  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  GEOM = 5
  SITE = 6
  CAMERA = 7


# ---------------------------------------------------------------------------
# Pytree dataclass helper
# ---------------------------------------------------------------------------

IntTuple = Tuple[int, ...]


def _register(cls, meta: tuple[str, ...]):
  data = tuple(f.name for f in dataclasses.fields(cls) if f.name not in meta)
  jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
  return cls


def _pytree(meta: tuple[str, ...] = ()):
  def wrap(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace  # convenience, MJX-style
    return _register(cls, meta)
  return wrap


# ---------------------------------------------------------------------------
# Option / Statistic
# ---------------------------------------------------------------------------


@_pytree(meta=(
    'integrator', 'cone', 'solver', 'iterations', 'ls_iterations',
    'ls_parallel', 'disableflags', 'enableflags', 'run_collision_detection',
))
class Option:
  """Physics options. Continuous values are traced (per-world randomizable
  via vmap); enum/iteration-count fields are static (reference
  types.py:706-772)."""
  timestep: jax.Array
  tolerance: jax.Array
  ls_tolerance: jax.Array
  gravity: jax.Array
  wind: jax.Array
  magnetic: jax.Array
  density: jax.Array
  viscosity: jax.Array
  impratio: jax.Array
  o_margin: jax.Array
  o_solref: jax.Array
  o_solimp: jax.Array
  o_friction: jax.Array
  # static:
  integrator: int
  cone: int
  solver: int
  iterations: int
  ls_iterations: int
  ls_parallel: bool
  sdf_iterations: int
  sdf_initpoints: int
  disableflags: int
  enableflags: int
  run_collision_detection: bool


@_pytree()
class Statistic:
  meaninertia: jax.Array


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

_MODEL_META = (
    # sizes
    'nq', 'nv', 'nu', 'na', 'nbody', 'njnt', 'ngeom', 'nsite', 'ncam',
    'nlight', 'neq', 'nmocap', 'ngravcomp', 'nsensor', 'nsensordata',
    'npair', 'nexclude', 'ntendon', 'nwrap',
    # tree structure (tuples of ints)
    'body_parentid', 'body_rootid', 'body_weldid', 'body_mocapid',
    'body_jntadr', 'body_jntnum', 'body_dofadr', 'body_dofnum',
    'body_geomadr', 'body_geomnum', 'body_treeid',
    'body_levels',  # tuple of tuples: body ids grouped by tree depth
    'jnt_type', 'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'jnt_limited',
    'jnt_actfrclimited', 'jnt_actgravcomp',
    'dof_bodyid', 'dof_jntid', 'dof_parentid', 'dof_treeid',
    'dof_ancestor_rows',  # tuple[nv] of tuple: ancestor dof ids incl self
    'dof_hasfrictionloss',
    'geom_type', 'geom_bodyid', 'geom_dataid', 'geom_condim',
    'geom_priority',
    'site_bodyid', 'site_type',
    'cam_bodyid', 'cam_mode', 'cam_targetbodyid', 'cam_resolution',
    'light_bodyid', 'light_mode', 'light_targetbodyid',
    'eq_type', 'eq_obj1id', 'eq_obj2id', 'eq_objtype',
    'actuator_trntype', 'actuator_dyntype', 'actuator_gaintype',
    'actuator_biastype', 'actuator_trnid', 'actuator_actadr',
    'actuator_actnum', 'actuator_ctrllimited', 'actuator_forcelimited',
    'actuator_actlimited', 'actuator_actearly',
    'tendon_adr', 'tendon_num', 'tendon_limited', 'tendon_hasfrictionloss',
    'tendon_structure', 'wrap_type', 'wrap_objid',
    'sensor_type', 'sensor_datatype', 'sensor_objtype', 'sensor_objid',
    'sensor_reftype', 'sensor_refid', 'sensor_adr', 'sensor_dim',
    'sensor_needstage', 'sensor_intprm',
    # collision structure (precomputed filtered pairs, grouped by type pair)
    'nkey', 'nmesh', 'nhfield', 'hfield_nrow', 'hfield_ncol',
    'collision_pairs',   # tuple of (type1, type2, tuple[(g1, g2, pairid)])
    'sdf_grid_of_mesh',  # meshid -> sdf grid index (-1 = none)
    # per-geom SDF plugin name ('' = none) — geom plugins are the only
    # plugin kind the reference supports (ref io.py:132-139, 415-442)
    'geom_plugin',
    'nxn_candidates',    # total candidate contact slots (static)
    'condim_max',
    'pair_dim',          # static condim per explicit <pair>
    'has_damping',       # any dof_damping > 0 in the compiled model
    'fluid_active',      # density or viscosity or wind nonzero
    'has_tendon_armature',
    'body_fluid_ellipsoid',  # per-body: use ellipsoid fluid model
    'flex_meta',         # flex.FlexMeta (hashable static flex structure)
    # tactile sensors (reference sensor.py:2122 _sensor_tactile):
    # tuple per TACTILE sensor of (sensor_id, geom_id, taxel_start,
    # taxel_count, has_frame, other_groups) where other_groups is a
    # tuple of (geom_type, tuple(geom ids)) the sensor can touch
    'tactile_meta',
    # SAP broadphase (auto-selected for large filtered pair counts,
    # reference io.py:349-354 + collision_driver.py:554 sap_broadphase):
    # () = NXN static pair list, else a collision_sap.SapMeta
    'sap_meta',
    # tree-sparse qM storage (None = dense (nv, nv) qM/qLD):
    # a sparse.QMMeta with the packed layout + level-scheduled LDL
    # schedules (reference CSR qM + qLD_updates, io.py:575-635)
    'qm_meta',
)


@_pytree(meta=_MODEL_META)
class Model:
  """Static model. See module docstring for the meta/data split.
  Mirrors the reference Model (types.py:833-1603) + the put_model
  precomputation (io.py:77-647), reorganized for XLA."""
  # sizes ------------------------------------------------------------------
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  ncam: int
  nlight: int
  neq: int
  nmocap: int
  ngravcomp: int
  nsensor: int
  nsensordata: int
  npair: int
  nexclude: int
  ntendon: int
  nwrap: int
  # structure (static) ------------------------------------------------------
  body_parentid: IntTuple
  body_rootid: IntTuple
  body_weldid: IntTuple
  body_mocapid: IntTuple
  body_jntadr: IntTuple
  body_jntnum: IntTuple
  body_dofadr: IntTuple
  body_dofnum: IntTuple
  body_geomadr: IntTuple
  body_geomnum: IntTuple
  body_treeid: IntTuple
  body_levels: Tuple[IntTuple, ...]
  jnt_type: IntTuple
  jnt_qposadr: IntTuple
  jnt_dofadr: IntTuple
  jnt_bodyid: IntTuple
  jnt_limited: IntTuple
  jnt_actfrclimited: IntTuple
  jnt_actgravcomp: IntTuple
  dof_bodyid: IntTuple
  dof_jntid: IntTuple
  dof_parentid: IntTuple
  dof_treeid: IntTuple
  dof_ancestor_rows: Tuple[IntTuple, ...]
  dof_hasfrictionloss: IntTuple
  geom_type: IntTuple
  geom_bodyid: IntTuple
  geom_dataid: IntTuple
  geom_condim: IntTuple
  geom_priority: IntTuple
  site_bodyid: IntTuple
  site_type: IntTuple
  cam_bodyid: IntTuple
  cam_mode: IntTuple
  cam_targetbodyid: IntTuple
  cam_resolution: Tuple[IntTuple, ...]
  light_bodyid: IntTuple
  light_mode: IntTuple
  light_targetbodyid: IntTuple
  eq_type: IntTuple
  eq_obj1id: IntTuple
  eq_obj2id: IntTuple
  eq_objtype: IntTuple
  actuator_trntype: IntTuple
  actuator_dyntype: IntTuple
  actuator_gaintype: IntTuple
  actuator_biastype: IntTuple
  actuator_trnid: Tuple[IntTuple, ...]
  actuator_actadr: IntTuple
  actuator_actnum: IntTuple
  actuator_ctrllimited: IntTuple
  actuator_forcelimited: IntTuple
  actuator_actlimited: IntTuple
  actuator_actearly: IntTuple
  tendon_adr: IntTuple
  tendon_num: IntTuple
  tendon_limited: IntTuple
  tendon_hasfrictionloss: IntTuple
  tendon_structure: Tuple[Any, ...]
  wrap_type: IntTuple
  wrap_objid: IntTuple
  sensor_type: IntTuple
  sensor_datatype: IntTuple
  sensor_objtype: IntTuple
  sensor_objid: IntTuple
  sensor_reftype: IntTuple
  sensor_refid: IntTuple
  sensor_adr: IntTuple
  sensor_dim: IntTuple
  sensor_needstage: IntTuple
  sensor_intprm: Tuple[Any, ...]
  nkey: int
  nmesh: int
  nhfield: int
  hfield_nrow: IntTuple
  hfield_ncol: IntTuple
  collision_pairs: Tuple[Any, ...]
  sdf_grid_of_mesh: IntTuple
  geom_plugin: Tuple[str, ...]
  nxn_candidates: int
  condim_max: int
  pair_dim: IntTuple
  has_damping: bool
  fluid_active: bool
  has_tendon_armature: bool
  body_fluid_ellipsoid: Tuple[bool, ...]
  # numeric parameters (traced) ---------------------------------------------
  opt: Option
  stat: Statistic
  qpos0: jax.Array
  qpos_spring: jax.Array
  body_pos: jax.Array
  body_quat: jax.Array
  body_ipos: jax.Array
  body_iquat: jax.Array
  body_mass: jax.Array
  body_subtreemass: jax.Array
  body_inertia: jax.Array
  body_invweight0: jax.Array
  body_gravcomp: jax.Array
  jnt_solref: jax.Array
  jnt_solimp: jax.Array
  jnt_pos: jax.Array
  jnt_axis: jax.Array
  jnt_stiffness: jax.Array
  jnt_range: jax.Array
  jnt_actfrcrange: jax.Array
  jnt_margin: jax.Array
  dof_solref: jax.Array
  dof_solimp: jax.Array
  dof_frictionloss: jax.Array
  dof_armature: jax.Array
  dof_damping: jax.Array
  dof_invweight0: jax.Array
  dof_M0: jax.Array
  geom_pos: jax.Array
  geom_quat: jax.Array
  geom_size: jax.Array
  geom_fluid: jax.Array
  geom_friction: jax.Array
  geom_solref: jax.Array
  geom_solimp: jax.Array
  geom_solmix: jax.Array
  geom_margin: jax.Array
  geom_gap: jax.Array
  geom_rbound: jax.Array
  geom_aabb: jax.Array
  site_pos: jax.Array
  site_quat: jax.Array
  site_size: jax.Array
  cam_pos: jax.Array
  cam_quat: jax.Array
  cam_poscom0: jax.Array
  cam_pos0: jax.Array
  cam_mat0: jax.Array
  cam_fovy: jax.Array
  light_pos: jax.Array
  light_dir: jax.Array
  light_poscom0: jax.Array
  light_pos0: jax.Array
  light_dir0: jax.Array
  eq_solref: jax.Array
  eq_solimp: jax.Array
  eq_data: jax.Array
  eq_active0: jax.Array
  actuator_dynprm: jax.Array
  actuator_gainprm: jax.Array
  actuator_biasprm: jax.Array
  actuator_ctrlrange: jax.Array
  actuator_forcerange: jax.Array
  actuator_actrange: jax.Array
  actuator_gear: jax.Array
  actuator_cranklength: jax.Array
  actuator_acc0: jax.Array
  actuator_lengthrange: jax.Array
  actuator_length0: jax.Array
  tendon_solref_lim: jax.Array
  tendon_solimp_lim: jax.Array
  tendon_solref_fri: jax.Array
  tendon_solimp_fri: jax.Array
  tendon_length0: jax.Array
  tendon_range: jax.Array
  tendon_margin: jax.Array
  tendon_stiffness: jax.Array
  tendon_damping: jax.Array
  tendon_armature: jax.Array
  tendon_frictionloss: jax.Array
  tendon_lengthspring: jax.Array
  tendon_invweight0: jax.Array
  wrap_prm: jax.Array
  # explicit <pair> parameter tables (indexed by the static pairid baked
  # into collision_pairs)
  pair_solref: jax.Array
  pair_solreffriction: jax.Array
  pair_solimp: jax.Array
  pair_margin: jax.Array
  pair_gap: jax.Array
  pair_friction: jax.Array
  exclude_signature: jax.Array
  # collision numeric tables aligned with collision_pairs flattening
  # (per candidate pair: mixed condim/friction etc. computed on the fly)
  sensor_cutoff: jax.Array
  mocap_pos0: jax.Array
  mocap_quat0: jax.Array
  # keyframes (reference types.py key_* fields)
  key_time: jax.Array
  key_qpos: jax.Array
  key_qvel: jax.Array
  key_act: jax.Array
  key_ctrl: jax.Array
  key_mpos: jax.Array
  key_mquat: jax.Array
  # (nmesh, VMAX, 4) padded convex-hull vertices, geom frame (xyz+valid)
  mesh_hullvert: jax.Array
  mesh_hullvert_small: jax.Array
  mesh_faces: jax.Array
  # (nmesh, cmax, 2, 3) per-cluster AABBs of the Morton-clustered face
  # array (bvh.py — the mesh-BVH role)
  mesh_cluster_aabb: jax.Array
  sdf_grids: jax.Array
  sdf_grid_aabb: jax.Array
  # (ngeom, collision_sdf.NPLUGINATTR) parsed plugin config floats
  # (ref types.py:1128 plugin_attr)
  geom_plugin_attr: jax.Array
  # (nhfield, max_nrow, max_ncol) normalized heights + (nhfield, 4) size
  hfield_data: jax.Array
  hfield_size: jax.Array
  # dense ancestry mask for CRB mass-matrix assembly: (nv, nv) 0/1,
  # mask[i, j] = 1 iff dof j is an ancestor (or self) of dof i.
  dof_ancestor_mask: jax.Array
  # (nbody, nbody) 0/1, subtree_mask[b, c] = 1 iff c is in subtree(b).
  # Turns backward tree accumulations (CRB, subtree com, cfrc) into one
  # matmul — the vectorized replacement for the reference's level-order
  # scan kernels (smooth.py:463-509, 807-826).
  body_subtree_mask: jax.Array
  # (nbody, nv) 0/1, 1 iff dof j is an ancestor dof of body b (incl. own).
  # Turns forward propagation (cvel, cacc sums) into one matmul.
  body_dof_ancestor_mask: jax.Array
  # (nv, nv) strict-ancestor mask for cdof_dot partial velocities
  # (see io._dof_vpre_mask) — com_vel as one matmul.
  dof_vpre_mask: jax.Array
  # flex (deformable) static tables — see flex.py (reference
  # types.py flex_* fields). Empty (0, ...) when the model has no flex.
  flex_meta: object                 # FlexMeta, static (in _MODEL_META)
  flex_edge: jax.Array              # (nfe, 2) int32 global vert ids
  flex_edgeflap: jax.Array          # (nfe, 2) int32 global (-1 = none)
  flex_elem_edge: jax.Array         # (nel, maxe) int32 global edge ids
  flex_elem_enda: jax.Array         # (nel, maxe) int32 endpoint A verts
  flex_elem_endb: jax.Array         # (nel, maxe) int32 endpoint B verts
  flex_stiffness: jax.Array         # (nel, 21) packed elasticity metric
  flex_bending: jax.Array           # (nfe, 17) bending Hessian + coef
  flexedge_length0: jax.Array       # (nfe,)
  flexedge_invweight0: jax.Array    # (nfe,)
  flex_vertlocal: jax.Array         # (nfv, 3) body-frame vertex coords
  flex_vert_bodyid: jax.Array       # (nfv,) int32 vertex body
  flex_vert_dofadr: jax.Array       # (nfv,) int32 first slide dof (-1 pinned)
  # tactile sensor taxel tables (empty (0, ...) without TACTILE sensors;
  # reference types.py taxel_vertadr/taxel_sensorid + mesh vert/normal)
  tactile_meta: object              # static (in _MODEL_META)
  taxel_pos: jax.Array              # (ntaxel, 3) geom-frame positions
  taxel_normal: jax.Array           # (ntaxel, 3) geom-frame normals
  taxel_tang: jax.Array             # (ntaxel, 2, 3) tangent frame (or 0)
  # large-scene broadphase pair arrays (empty (0, ...) when sap_meta
  # is ()): admissible pairs concatenated per family (slices in
  # sap_meta.families), g1 in collider argument order, plus the
  # explicit <pair> id per row (-1 = none)
  sap_meta: object                  # static (in _MODEL_META)
  sap_pairs: jax.Array              # (npairs, 2) int32
  sap_pairid: jax.Array             # (npairs,) int32
  # sparse mass matrix meta (None = dense mode); when set, Data.qM and
  # Data.qLD are packed (nM,) value vectors (see sparse.py)
  qm_meta: object                   # static (in _MODEL_META)


# ---------------------------------------------------------------------------
# Contact / Data
# ---------------------------------------------------------------------------


@_pytree()
class Contact:
  """Per-world contact pool, fixed capacity nconmax with count `ncon`
  (reference uses one global atomic pool, types.py:1617-1655; per-world
  fixed slots + mask is the XLA equivalent)."""
  dist: jax.Array          # (nconmax,)
  pos: jax.Array           # (nconmax, 3)
  frame: jax.Array         # (nconmax, 3, 3) rows: normal, tangent1, tangent2
  includemargin: jax.Array  # (nconmax,)
  friction: jax.Array      # (nconmax, 5)
  solref: jax.Array        # (nconmax, 2)
  solreffriction: jax.Array  # (nconmax, 2)
  solimp: jax.Array        # (nconmax, 5)
  dim: jax.Array           # (nconmax,) int32
  geom: jax.Array          # (nconmax, 2) int32; geom[1] == -1 => flex side
  efc_address: jax.Array   # (nconmax,) int32 first efc row of this contact
  # flex contacts (reference types.py contact.flex/vert; here up to 3
  # vertices with barycentric weights so triangle contacts get the full
  # 3-vertex jacobian instead of single-vertex attribution)
  vert: jax.Array          # (nconmax, 3) int32 global flex verts, -1 unused
  vertw: jax.Array         # (nconmax, 3) barycentric weights


@_pytree()
class Data:
  """Single-world dynamic state; ``vmap`` adds the nworld axis
  (reference Data: types.py:1702-1896)."""
  # counters / scalars
  time: jax.Array
  energy: jax.Array        # (2,) potential, kinetic
  ncon: jax.Array          # int32
  ne: jax.Array            # int32 number of equality rows
  nf: jax.Array            # int32 friction rows
  nl: jax.Array            # int32 limit rows
  nefc: jax.Array          # int32 total active rows
  ncollision: jax.Array    # int32 broadphase-active pairs (diagnostic)
  solver_niter: jax.Array  # int32
  # state
  qpos: jax.Array
  qvel: jax.Array
  act: jax.Array
  ctrl: jax.Array
  qacc_warmstart: jax.Array
  mocap_pos: jax.Array
  mocap_quat: jax.Array
  # applied forces
  qfrc_applied: jax.Array
  xfrc_applied: jax.Array
  eq_active: jax.Array
  # kinematics products
  xpos: jax.Array
  xquat: jax.Array
  xmat: jax.Array
  xipos: jax.Array
  ximat: jax.Array
  xanchor: jax.Array
  xaxis: jax.Array
  geom_xpos: jax.Array
  geom_xmat: jax.Array
  site_xpos: jax.Array
  site_xmat: jax.Array
  cam_xpos: jax.Array
  cam_xmat: jax.Array
  light_xpos: jax.Array
  light_xdir: jax.Array
  # com-frame quantities
  subtree_com: jax.Array
  cinert: jax.Array
  cdof: jax.Array
  crb: jax.Array
  cvel: jax.Array
  cdof_dot: jax.Array
  cacc: jax.Array
  cfrc_int: jax.Array
  cfrc_ext: jax.Array
  subtree_linvel: jax.Array
  subtree_angmom: jax.Array
  # mass matrix (dense) and its Cholesky factor
  qM: jax.Array            # (nv, nv)
  qLD: jax.Array           # (nv, nv) lower Cholesky of qM
  # actuation
  actuator_length: jax.Array
  actuator_moment: jax.Array  # (nu, nv)
  actuator_velocity: jax.Array
  actuator_force: jax.Array
  act_dot: jax.Array
  # tendons
  ten_length: jax.Array
  ten_J: jax.Array         # (ntendon, nv)
  ten_velocity: jax.Array
  # flex (reference types.py flexvert_xpos/flexedge_length/velocity)
  flexvert_xpos: jax.Array      # (nfv, 3)
  flexedge_length: jax.Array    # (nfe,)
  flexedge_velocity: jax.Array  # (nfe,)
  # force buckets
  qfrc_spring: jax.Array
  qfrc_damper: jax.Array
  qfrc_gravcomp: jax.Array
  qfrc_fluid: jax.Array
  qfrc_passive: jax.Array
  qfrc_bias: jax.Array
  qfrc_actuator: jax.Array
  qfrc_smooth: jax.Array
  qacc_smooth: jax.Array
  qfrc_constraint: jax.Array
  qfrc_inverse: jax.Array
  qacc: jax.Array
  # contacts & constraints
  contact: Contact
  efc_type: jax.Array      # (njmax,) int32 ConstraintType
  efc_id: jax.Array        # (njmax,) int32 source object id
  efc_J: jax.Array         # (njmax, nv)
  efc_pos: jax.Array       # (njmax,)
  efc_margin: jax.Array
  efc_D: jax.Array
  efc_vel: jax.Array
  efc_aref: jax.Array
  efc_frictionloss: jax.Array
  efc_force: jax.Array
  efc_active: jax.Array    # (njmax,) bool: row exists this step
  # sensors
  sensordata: jax.Array


del Any
