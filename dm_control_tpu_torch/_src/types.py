"""Core typed containers: enums, Option, Model (host numpy), Data (tensors).

The PyTorch counterpart of `dm_control_tpu/_src/types.py`:

  * `Model` is the same host object of numpy arrays and Python ints that the
    compiler emits.  `mirror` gives the engine a device copy of any of its
    arrays (or of a constant derived from them), made once per dtype and
    device and cached on the Model, so no step copies from the host.

  * `Data` and `Contact` are plain dataclasses of batch-first tensors: every
    field carries the environments on its leading axis B (the JAX package
    `vmap`s a single-environment Data instead).

Field names follow the MuJoCo nomenclature (qpos, xpos, cdof, ...).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Enums (integer-valued, stored in numpy arrays inside Model).
# ---------------------------------------------------------------------------


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


# dofs / qpos entries contributed by each joint type
JOINT_NV = {JointType.FREE: 6, JointType.BALL: 3, JointType.SLIDE: 1,
            JointType.HINGE: 1}
JOINT_NQ = {JointType.FREE: 7, JointType.BALL: 4, JointType.SLIDE: 1,
            JointType.HINGE: 1}


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class Integrator(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class SolverType(enum.IntEnum):
  PGS = 0
  CG = 1
  NEWTON = 2


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


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class WrapType(enum.IntEnum):
  JOINT = 0      # fixed tendon: joint entry
  SITE = 1       # spatial tendon: site via-point
  SPHERE = 2     # spatial tendon: wrapping sphere geom
  CYLINDER = 3   # spatial tendon: wrapping cylinder geom
  PULLEY = 4


class SensorType(enum.IntEnum):
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  JOINTPOS = 8
  JOINTVEL = 9
  TENDONPOS = 10
  TENDONVEL = 11
  ACTUATORPOS = 12
  ACTUATORVEL = 13
  ACTUATORFRC = 14
  BALLQUAT = 15
  BALLANGVEL = 16
  FRAMEPOS = 17
  FRAMEQUAT = 18
  FRAMEXAXIS = 19
  FRAMEYAXIS = 20
  FRAMEZAXIS = 21
  FRAMELINVEL = 22
  FRAMEANGVEL = 23
  FRAMELINACC = 24
  FRAMEANGACC = 25
  SUBTREECOM = 26
  SUBTREELINVEL = 27
  SUBTREEANGMOM = 28
  CLOCK = 29


class ObjType(enum.IntEnum):
  """Object type for sensors attached via objtype/objid."""
  BODY = 0
  XBODY = 1
  JOINT = 2
  GEOM = 3
  SITE = 4
  CAMERA = 5
  TENDON = 6
  ACTUATOR = 7


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class DisableBit(enum.IntFlag):
  """Option disable bits (numbering matches the oracle's mjtDisableBit)."""
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
  EULERDAMP = 1 << 15
  PASSIVE = SPRING | DAMPER


# ---------------------------------------------------------------------------
# Option: simulation options (host-static).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Option:
  """Simulation options (reference: mjOption / MJCF <option>)."""
  timestep: float = 0.002
  gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
  wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)
  magnetic: Tuple[float, float, float] = (0.0, -0.5, 0.0)
  density: float = 0.0
  viscosity: float = 0.0
  integrator: Integrator = Integrator.EULER
  cone: ConeType = ConeType.PYRAMIDAL
  solver: SolverType = SolverType.NEWTON
  iterations: int = 100
  ls_iterations: int = 50
  tolerance: float = 1e-8
  ls_tolerance: float = 0.01
  impratio: float = 1.0
  disableflags: int = 0
  noslip_iterations: int = 0
  noslip_tolerance: float = 1e-6
  # top-K broadphase (TPU static-shape analog of the reference's dynamic
  # broadphase): candidate-pair groups larger than the threshold only
  # narrowphase their `cap` most-overlapping pairs each step.
  broadphase_threshold: int = 40
  broadphase_cap: int = 20
  # opt-in top-K for PLANE contact groups (0 = off: plane groups stay
  # static).  Body-vs-floor candidate sets dominate humanoid-class efc
  # layouts (16 plane-capsule pairs -> 128 of humanoid's 200 rows) while
  # only a few touch the floor at once; capping them is exact whenever
  # <= cap pairs are simultaneously within margin (the plane broadphase
  # score is the exact narrowphase distance)
  broadphase_plane_cap: int = 0
  # o_margin / o_solref / o_solimp defaults for pair overrides
  o_margin: float = 0.0
  o_solref: Tuple[float, float] = (0.02, 1.0)
  o_solimp: Tuple[float, float, float, float, float] = (
      0.9, 0.95, 0.001, 0.5, 2.0)


# ---------------------------------------------------------------------------
# Model: static compiled model (host object, not a pytree).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Model:
  """Compiled model: numpy arrays + python ints, host side.

  The engine reads per-step arrays through `mirror`, which keeps one device
  copy of each per (dtype, device).  `*_adr`/`*_id`/type fields stay numpy
  for Python-level control flow.
  """

  # sizes ------------------------------------------------------------------
  nq: int = 0
  nv: int = 0
  nu: int = 0
  na: int = 0
  nbody: int = 1
  njnt: int = 0
  ngeom: int = 0
  nsite: int = 0
  ncam: int = 0
  ntendon: int = 0
  nwrap: int = 0
  nsensor: int = 0
  nsensordata: int = 0
  neq: int = 0
  nkey: int = 0
  nmocap: int = 0

  opt: Option = dataclasses.field(default_factory=Option)

  # qpos defaults ----------------------------------------------------------
  qpos0: np.ndarray = None          # (nq,)
  qpos_spring: np.ndarray = None    # (nq,)

  # bodies -----------------------------------------------------------------
  body_parentid: np.ndarray = None  # (nbody,) i4
  body_rootid: np.ndarray = None    # (nbody,) i4
  body_weldid: np.ndarray = None    # (nbody,) i4
  body_jntnum: np.ndarray = None    # (nbody,) i4
  body_jntadr: np.ndarray = None    # (nbody,) i4
  body_dofnum: np.ndarray = None    # (nbody,) i4
  body_dofadr: np.ndarray = None    # (nbody,) i4
  body_geomnum: np.ndarray = None   # (nbody,) i4
  body_geomadr: np.ndarray = None   # (nbody,) i4
  body_pos: np.ndarray = None       # (nbody, 3)
  body_quat: np.ndarray = None      # (nbody, 4)
  body_ipos: np.ndarray = None      # (nbody, 3)
  body_iquat: np.ndarray = None     # (nbody, 4)
  body_mass: np.ndarray = None      # (nbody,)
  body_subtreemass: np.ndarray = None  # (nbody,)
  body_inertia: np.ndarray = None   # (nbody, 3)
  body_gravcomp: np.ndarray = None  # (nbody,)
  body_invweight0: np.ndarray = None  # (nbody, 2)
  body_mocapid: np.ndarray = None   # (nbody,) i4, -1 if not mocap

  # joints -----------------------------------------------------------------
  jnt_type: np.ndarray = None       # (njnt,) i4 JointType
  jnt_qposadr: np.ndarray = None    # (njnt,) i4
  jnt_dofadr: np.ndarray = None     # (njnt,) i4
  jnt_bodyid: np.ndarray = None     # (njnt,) i4
  jnt_limited: np.ndarray = None    # (njnt,) bool
  jnt_actfrclimited: np.ndarray = None  # (njnt,) bool
  jnt_pos: np.ndarray = None        # (njnt, 3)
  jnt_axis: np.ndarray = None       # (njnt, 3)
  jnt_stiffness: np.ndarray = None  # (njnt,)
  jnt_range: np.ndarray = None      # (njnt, 2)
  jnt_actfrcrange: np.ndarray = None  # (njnt, 2)
  jnt_margin: np.ndarray = None     # (njnt,)
  jnt_solref: np.ndarray = None     # (njnt, 2)
  jnt_solimp: np.ndarray = None     # (njnt, 5)
  jnt_springdamper: np.ndarray = None  # (njnt, 2) timeconst, dampratio

  # dofs -------------------------------------------------------------------
  dof_bodyid: np.ndarray = None     # (nv,) i4
  dof_jntid: np.ndarray = None      # (nv,) i4
  dof_parentid: np.ndarray = None   # (nv,) i4 (-1 at root)
  dof_armature: np.ndarray = None   # (nv,)
  dof_damping: np.ndarray = None    # (nv,)
  dof_frictionloss: np.ndarray = None  # (nv,)
  dof_solref: np.ndarray = None     # (nv, 2) friction loss solref
  dof_solimp: np.ndarray = None     # (nv, 5)
  dof_invweight0: np.ndarray = None  # (nv,)

  # geoms ------------------------------------------------------------------
  geom_type: np.ndarray = None      # (ngeom,) i4 GeomType
  geom_bodyid: np.ndarray = None    # (ngeom,) i4
  geom_contype: np.ndarray = None   # (ngeom,) i4
  geom_conaffinity: np.ndarray = None  # (ngeom,) i4
  geom_condim: np.ndarray = None    # (ngeom,) i4
  geom_priority: np.ndarray = None  # (ngeom,) i4
  geom_pos: np.ndarray = None       # (ngeom, 3)
  geom_quat: np.ndarray = None      # (ngeom, 4)
  geom_size: np.ndarray = None      # (ngeom, 3)
  geom_rbound: np.ndarray = None    # (ngeom,)
  geom_friction: np.ndarray = None  # (ngeom, 3)
  geom_margin: np.ndarray = None    # (ngeom,)
  geom_gap: np.ndarray = None       # (ngeom,)
  geom_solmix: np.ndarray = None    # (ngeom,)
  geom_solref: np.ndarray = None    # (ngeom, 2)
  geom_solimp: np.ndarray = None    # (ngeom, 5)
  geom_rgba: np.ndarray = None      # (ngeom, 4) for the built-in renderer
  geom_dataid: np.ndarray = None    # (ngeom,) i4 mesh asset id, -1 if none

  # mesh assets (host lists of numpy arrays; ragged across meshes) ----------
  mesh_vert: Any = None             # [nmesh] (nvert_i, 3)
  mesh_face: Any = None             # [nmesh] (nface_i, 3) i4
  mesh_hull: Any = None             # [nmesh] (nhull_i, 3) collision hull

  # heightfield assets -------------------------------------------------------
  nhfield: int = 0
  hfield_size: np.ndarray = None    # (nhfield, 4) x, y, z_top, z_bottom
  hfield_nrow: np.ndarray = None    # (nhfield,) i4
  hfield_ncol: np.ndarray = None    # (nhfield,) i4
  hfield_adr: np.ndarray = None     # (nhfield,) i4
  hfield_data: np.ndarray = None    # (sum nrow*ncol,) in [0, 1]

  # sites ------------------------------------------------------------------
  site_bodyid: np.ndarray = None    # (nsite,) i4
  site_pos: np.ndarray = None       # (nsite, 3)
  site_quat: np.ndarray = None      # (nsite, 4)
  site_size: np.ndarray = None      # (nsite, 3)
  site_type: np.ndarray = None      # (nsite,) i4

  # cameras (pose only; rendering is host-side) ----------------------------
  cam_bodyid: np.ndarray = None     # (ncam,) i4
  cam_pos: np.ndarray = None        # (ncam, 3)
  cam_quat: np.ndarray = None       # (ncam, 4)
  cam_mode: np.ndarray = None       # (ncam,) i4
  cam_fovy: np.ndarray = None       # (ncam,)

  # tendons ----------------------------------------------------------------
  tendon_adr: np.ndarray = None     # (ntendon,) i4 -> wrap_*
  tendon_num: np.ndarray = None     # (ntendon,) i4
  tendon_limited: np.ndarray = None  # (ntendon,) bool
  tendon_range: np.ndarray = None   # (ntendon, 2)
  tendon_margin: np.ndarray = None  # (ntendon,)
  tendon_stiffness: np.ndarray = None  # (ntendon,)
  tendon_damping: np.ndarray = None    # (ntendon,)
  tendon_frictionloss: np.ndarray = None  # (ntendon,)
  tendon_lengthspring: np.ndarray = None  # (ntendon, 2)
  tendon_length0: np.ndarray = None  # (ntendon,)
  tendon_solref_lim: np.ndarray = None  # (ntendon, 2)
  tendon_solimp_lim: np.ndarray = None  # (ntendon, 5)
  tendon_solref_fri: np.ndarray = None  # (ntendon, 2) friction-loss solref
  tendon_solimp_fri: np.ndarray = None  # (ntendon, 5)
  tendon_invweight0: np.ndarray = None  # (ntendon,)
  wrap_type: np.ndarray = None      # (nwrap,) i4 WrapType
  wrap_objid: np.ndarray = None     # (nwrap,) i4
  wrap_prm: np.ndarray = None       # (nwrap,)

  # actuators --------------------------------------------------------------
  actuator_trntype: np.ndarray = None  # (nu,) i4 TrnType
  actuator_dyntype: np.ndarray = None  # (nu,) i4 DynType
  actuator_gaintype: np.ndarray = None  # (nu,) i4 GainType
  actuator_biastype: np.ndarray = None  # (nu,) i4 BiasType
  actuator_trnid: np.ndarray = None  # (nu, 2) i4
  actuator_actadr: np.ndarray = None  # (nu,) i4 (-1 if stateless)
  actuator_actnum: np.ndarray = None  # (nu,) i4
  actuator_ctrllimited: np.ndarray = None  # (nu,) bool
  actuator_forcelimited: np.ndarray = None  # (nu,) bool
  actuator_actlimited: np.ndarray = None   # (nu,) bool
  actuator_dynprm: np.ndarray = None   # (nu, 10)
  actuator_gainprm: np.ndarray = None  # (nu, 10)
  actuator_biasprm: np.ndarray = None  # (nu, 10)
  actuator_ctrlrange: np.ndarray = None  # (nu, 2)
  actuator_forcerange: np.ndarray = None  # (nu, 2)
  actuator_actrange: np.ndarray = None   # (nu, 2)
  actuator_gear: np.ndarray = None     # (nu, 6)
  actuator_length0: np.ndarray = None  # (nu,)
  actuator_lengthrange: np.ndarray = None  # (nu, 2)
  actuator_acc0: np.ndarray = None     # (nu,)

  # equality constraints ---------------------------------------------------
  eq_type: np.ndarray = None        # (neq,) i4 EqType
  eq_obj1id: np.ndarray = None      # (neq,) i4
  eq_obj2id: np.ndarray = None      # (neq,) i4
  eq_active0: np.ndarray = None     # (neq,) bool
  eq_solref: np.ndarray = None      # (neq, 2)
  eq_solimp: np.ndarray = None      # (neq, 5)
  eq_data: np.ndarray = None        # (neq, 11)

  # sensors ----------------------------------------------------------------
  sensor_type: np.ndarray = None    # (nsensor,) i4 SensorType
  sensor_objtype: np.ndarray = None  # (nsensor,) i4 ObjType
  sensor_objid: np.ndarray = None   # (nsensor,) i4
  sensor_reftype: np.ndarray = None  # (nsensor,) i4
  sensor_refid: np.ndarray = None   # (nsensor,) i4
  sensor_adr: np.ndarray = None     # (nsensor,) i4
  sensor_dim: np.ndarray = None     # (nsensor,) i4
  sensor_cutoff: np.ndarray = None  # (nsensor,)

  # keyframes --------------------------------------------------------------
  key_time: np.ndarray = None       # (nkey,)
  key_qpos: np.ndarray = None       # (nkey, nq)
  key_qvel: np.ndarray = None       # (nkey, nv)
  key_act: np.ndarray = None        # (nkey, na)
  key_ctrl: np.ndarray = None       # (nkey, nu)

  # collision candidate pairs (precomputed at build time) ------------------
  # list of (geom1 ids, geom2 ids) grouped by (GeomType, GeomType) pair key.
  collision_pairs: Any = None

  # name -> id maps, per object kind ---------------------------------------
  names: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

  # ancestry mask: body_dof_mask[b, i] = 1.0 if dof i is on path root->b.
  body_dof_mask: np.ndarray = None  # (nbody, nv) f8

  # model statistics (reference mjStatistic; filled by setconst)
  stat_meaninertia: float = 1.0

  def name2id(self, kind: str, name: str) -> int:
    return self.names[kind][name]

  def id2name(self, kind: str, idx: int) -> Optional[str]:
    for n, i in self.names.get(kind, {}).items():
      if i == idx:
        return n
    return None


# ---------------------------------------------------------------------------
# Device mirror of the Model.
# ---------------------------------------------------------------------------


def mirror(m: Model, ref: torch.Tensor, value) -> torch.Tensor:
  """Device tensor of a Model array or of a constant derived from one.

  `value` is a numpy array (or anything np.asarray takes); floats take
  `ref`'s dtype, integers become int64 (index tensors), booleans stay bool.
  The copy is made once per (content, dtype, device) and cached on `m`:
  a host-to-device copy inside a step would synchronise the stream.
  """
  arr = np.asarray(value)
  if arr.dtype.kind == 'f':
    dtype = ref.dtype
  elif arr.dtype.kind == 'b':
    dtype = torch.bool
  else:
    dtype = torch.int64
  key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, ref.device)
  cache = m.__dict__.setdefault('_mirror', {})
  t = cache.get(key)
  if t is None:
    t = torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                        device=ref.device)
    cache[key] = t
  return t


def resolve_device(device=None) -> torch.device:
  """The device an entry point runs on: CUDA unless the caller asks.

  With no CUDA device and no explicit device this raises: the port's
  entry points never fall back to the CPU on their own."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'no CUDA device is available; pass device="cpu" to run on the CPU')
    return torch.device('cuda')
  return torch.device(device)


# ---------------------------------------------------------------------------
# Contact + Data (batch-first tensors).
# ---------------------------------------------------------------------------


class _Replace:

  def replace(self, **kwargs):
    return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class Contact(_Replace):
  """Fixed-size contact buffer, (B, ncon, ...); row i is active iff its
  efc rows are active (`dist < includemargin`)."""
  dist: torch.Tensor       # (B, ncon)
  pos: torch.Tensor        # (B, ncon, 3)
  frame: torch.Tensor      # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
  includemargin: torch.Tensor  # (B, ncon)
  friction: torch.Tensor   # (B, ncon, 5)
  solref: torch.Tensor     # (B, ncon, 2)
  solimp: torch.Tensor     # (B, ncon, 5)
  geom1: torch.Tensor      # (B, ncon) i4
  geom2: torch.Tensor      # (B, ncon) i4
  body1: torch.Tensor      # (B, ncon) i4
  body2: torch.Tensor      # (B, ncon) i4
  dim: torch.Tensor        # (B, ncon) i4 condim


@dataclasses.dataclass(frozen=True)
class Data(_Replace):
  """Dynamic state + derived quantities of B environments."""

  # integration state ------------------------------------------------------
  time: torch.Tensor       # (B,)
  qpos: torch.Tensor       # (B, nq)
  qvel: torch.Tensor       # (B, nv)
  act: torch.Tensor        # (B, na)
  ctrl: torch.Tensor       # (B, nu)
  qfrc_applied: torch.Tensor  # (B, nv)
  xfrc_applied: torch.Tensor  # (B, nbody, 6)

  # kinematics -------------------------------------------------------------
  xpos: torch.Tensor       # (B, nbody, 3)
  xquat: torch.Tensor      # (B, nbody, 4)
  xmat: torch.Tensor       # (B, nbody, 3, 3)
  xipos: torch.Tensor      # (B, nbody, 3)
  ximat: torch.Tensor      # (B, nbody, 3, 3)
  geom_xpos: torch.Tensor  # (B, ngeom, 3)
  geom_xmat: torch.Tensor  # (B, ngeom, 3, 3)
  site_xpos: torch.Tensor  # (B, nsite, 3)
  site_xmat: torch.Tensor  # (B, nsite, 3, 3)
  xanchor: torch.Tensor    # (B, njnt, 3)
  xaxis: torch.Tensor      # (B, njnt, 3)

  # com-based quantities ---------------------------------------------------
  subtree_com: torch.Tensor  # (B, nbody, 3)
  cinert: torch.Tensor     # (B, nbody, 10)
  cdof: torch.Tensor       # (B, nv, 6)
  cdof_dot: torch.Tensor   # (B, nv, 6)
  cvel: torch.Tensor       # (B, nbody, 6)

  # mass matrix ------------------------------------------------------------
  qM: torch.Tensor         # (B, nv, nv) dense
  qLD: torch.Tensor        # (B, nv, nv) cholesky factor (lower)

  # tendons ----------------------------------------------------------------
  ten_length: torch.Tensor    # (B, ntendon)
  ten_velocity: torch.Tensor  # (B, ntendon)
  ten_J: torch.Tensor         # (B, ntendon, nv)

  # actuation --------------------------------------------------------------
  actuator_length: torch.Tensor    # (B, nu)
  actuator_velocity: torch.Tensor  # (B, nu)
  actuator_moment: torch.Tensor    # (B, nu, nv)
  actuator_force: torch.Tensor     # (B, nu)
  act_dot: torch.Tensor            # (B, na)

  # forces -----------------------------------------------------------------
  qfrc_bias: torch.Tensor      # (B, nv)
  qfrc_spring: torch.Tensor    # (B, nv)
  qfrc_damper: torch.Tensor    # (B, nv)
  qfrc_gravcomp: torch.Tensor  # (B, nv)
  qfrc_fluid: torch.Tensor     # (B, nv)
  qfrc_passive: torch.Tensor   # (B, nv)
  qfrc_actuator: torch.Tensor  # (B, nv)
  qfrc_smooth: torch.Tensor    # (B, nv)
  qacc_smooth: torch.Tensor    # (B, nv)
  qfrc_constraint: torch.Tensor  # (B, nv)
  qacc: torch.Tensor           # (B, nv)
  qacc_warmstart: torch.Tensor  # (B, nv) previous solution (solver warmstart)

  # constraints (fixed-size padded rows) -----------------------------------
  contact: Contact
  efc_J: torch.Tensor          # (B, nefc, nv)
  efc_pos: torch.Tensor        # (B, nefc)
  efc_margin: torch.Tensor     # (B, nefc)
  efc_D: torch.Tensor          # (B, nefc)
  efc_aref: torch.Tensor       # (B, nefc)
  efc_frictionloss: torch.Tensor  # (B, nefc)
  efc_force: torch.Tensor      # (B, nefc)
  efc_active: torch.Tensor     # (B, nefc) bool

  # sensors ----------------------------------------------------------------
  sensordata: torch.Tensor     # (B, nsensordata)

  # diagnostics ------------------------------------------------------------
  energy: torch.Tensor         # (B, 2) potential, kinetic
  diverged: torch.Tensor       # (B,) bool - state became non-finite

  # per-episode model-parameter overrides: {field_name: (B, ...) tensor}
  # taking precedence over the static Model arrays inside the engine
  model_var: Any = dataclasses.field(default_factory=dict)
