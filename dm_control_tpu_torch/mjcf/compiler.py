"""MJCF-subset XML -> `Model` compiler (host-side, numpy, build-time only).

The port's own copy of `dm_control_tpu/mjcf/compiler.py`, emitting the
port's `Model`, mesh assets included (`meshes.py`).

Covers the MJCF feature surface exercised by the reference Control Suite
models (SURVEY.md section 2.6): bodies/joints/geoms/sites, nested defaults
with childclass, all orientation specifiers, fromto geoms, auto inertia from
geoms, motors/position/velocity/general actuators, fixed + site-spatial
tendons, sensors, equality constraints, contact pair/exclude filtering,
keyframes, and option flags.

Semantics follow the MuJoCo modeling language spec (the format the reference
consumes via mj_loadXML, dm_control/mujoco/wrapper/core.py:300-364); every
computed quantity (masses, inertias, qpos0, collision pair list) is validated
against the `mujoco` CPU oracle in tests/test_compiler.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple
import xml.etree.ElementTree as ET

import numpy as np

from dm_control_tpu_torch._src import types as T

_EPS = 1e-14


# ---------------------------------------------------------------------------
# numpy quaternion helpers (host-side; build-time only).
# ---------------------------------------------------------------------------


def _nquat_mul(q, p):
  w1, x1, y1, z1 = q
  w2, x2, y2, z2 = p
  return np.array([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ])


def _nquat_normalize(q):
  return q / max(np.linalg.norm(q), _EPS)


def _nquat_from_axis_angle(axis, angle):
  axis = np.asarray(axis, np.float64)
  n = np.linalg.norm(axis)
  if n < _EPS:
    return np.array([1.0, 0, 0, 0])
  axis = axis / n
  return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _nquat_to_mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def _nmat_to_quat(m):
  tr = np.trace(m)
  if tr > 0:
    s = np.sqrt(tr + 1.0) * 2
    q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                  (m[1, 0] - m[0, 1]) / s])
  elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
    s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
    q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                  (m[0, 2] + m[2, 0]) / s])
  elif m[1, 1] > m[2, 2]:
    s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
    q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                  (m[1, 2] + m[2, 1]) / s])
  else:
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                  (m[1, 2] + m[2, 1]) / s, 0.25 * s])
  q = _nquat_normalize(q)
  return q if q[0] >= 0 else -q


def _nquat_z_to(vec):
  """Minimal rotation taking local +z to `vec`."""
  vec = np.asarray(vec, np.float64)
  n = np.linalg.norm(vec)
  if n < _EPS:
    return np.array([1.0, 0, 0, 0])
  z = vec / n
  axis = np.cross([0.0, 0.0, 1.0], z)
  s = np.linalg.norm(axis)
  c = z[2]
  if s < _EPS:
    if c > 0:
      return np.array([1.0, 0, 0, 0])
    return np.array([0.0, 1.0, 0, 0])  # 180 deg about x
  angle = np.arctan2(s, c)
  return _nquat_from_axis_angle(axis / s, angle)


# ---------------------------------------------------------------------------
# Attribute parsing.
# ---------------------------------------------------------------------------

_SOLREF_DEF = np.array([0.02, 1.0])
_SOLIMP_DEF = np.array([0.9, 0.95, 0.001, 0.5, 2.0])


def _padded(a, key, default):
  """Parse a possibly partially-specified array attr, padding with defaults."""
  out = default.copy()
  if key in a:
    v = _floats(a[key])
    out[:len(v)] = v
  return out



def _floats(s: str) -> np.ndarray:
  return np.array([float(x) for x in s.replace(',', ' ').split()], np.float64)


def _parse_orientation(attrib: Dict[str, str], degrees: bool,
                       eulerseq: str) -> np.ndarray:
  """Resolve quat/euler/axisangle/xyaxes/zaxis -> quaternion (w,x,y,z)."""
  if 'quat' in attrib:
    return _nquat_normalize(_floats(attrib['quat']))
  if 'euler' in attrib:
    ang = _floats(attrib['euler'])
    if degrees:
      ang = np.deg2rad(ang)
    q = np.array([1.0, 0, 0, 0])
    axes = {'x': [1.0, 0, 0], 'y': [0, 1.0, 0], 'z': [0, 0, 1.0]}
    for i, ax in enumerate(eulerseq):
      rot = _nquat_from_axis_angle(axes[ax.lower()], ang[i])
      if ax.islower():  # intrinsic: post-multiply
        q = _nquat_mul(q, rot)
      else:  # extrinsic: pre-multiply
        q = _nquat_mul(rot, q)
    return _nquat_normalize(q)
  if 'axisangle' in attrib:
    aa = _floats(attrib['axisangle'])
    angle = np.deg2rad(aa[3]) if degrees else aa[3]
    return _nquat_from_axis_angle(aa[:3], angle)
  if 'xyaxes' in attrib:
    v = _floats(attrib['xyaxes'])
    x, y = v[:3], v[3:]
    x = x / max(np.linalg.norm(x), _EPS)
    y = y - x * np.dot(x, y)
    y = y / max(np.linalg.norm(y), _EPS)
    z = np.cross(x, y)
    return _nmat_to_quat(np.stack([x, y, z], axis=1))
  if 'zaxis' in attrib:
    return _nquat_z_to(_floats(attrib['zaxis']))
  return np.array([1.0, 0, 0, 0])


# ---------------------------------------------------------------------------
# XML loading with <include> expansion.
# ---------------------------------------------------------------------------


def _sanitize_xml(text: str) -> str:
  """Fix malformations the reference's native XML parser tolerates but
  Python's does not: pseudo-comments `<! ... -->` (suite jaco_*.xml
  line 2) and missing whitespace between attributes
  (`..."type="mesh"` in jaco_j2s6s300)."""
  import re
  text = re.sub(r'<!(?!--|\[)(.*?)-->', '', text, flags=re.S)
  return re.sub(r'"([A-Za-z_][\w:-]*=")', r'" \1', text)


def _parse_xml_file(path: str) -> ET.Element:
  with open(path) as f:
    return ET.fromstring(_sanitize_xml(f.read()))


def _load_xml(path: str) -> ET.Element:
  root = _parse_xml_file(path)
  _expand_includes(root, os.path.dirname(path))
  return root


def _expand_includes(elem: ET.Element, base_dir: str):
  i = 0
  while i < len(elem):
    child = elem[i]
    if child.tag == 'include':
      inc_path = os.path.join(base_dir, child.attrib['file'])
      inc_root = _parse_xml_file(inc_path)
      _expand_includes(inc_root, os.path.dirname(inc_path))
      elem.remove(child)
      # Splice the included <mujoco> file's children in place.
      for j, sub in enumerate(list(inc_root)):
        elem.insert(i + j, sub)
    else:
      _expand_includes(child, base_dir)
      i += 1


# ---------------------------------------------------------------------------
# Defaults resolution.
# ---------------------------------------------------------------------------


class _Defaults:
  """Nested default classes; resolve per-(class, tag) merged attributes."""

  def __init__(self, root: ET.Element):
    self._tree: Dict[str, Dict[str, Dict[str, str]]] = {}
    self._parent: Dict[str, Optional[str]] = {}
    for d in root.findall('default'):
      self._walk(d, None)
    if 'main' not in self._tree:
      self._tree['main'] = {}
      self._parent['main'] = None
    self._cache: Dict[Tuple[str, str], Dict[str, str]] = {}

  def _walk(self, delem: ET.Element, parent: Optional[str]):
    name = delem.attrib.get('class', 'main' if parent is None else None)
    if name is None:
      raise ValueError('nested <default> must have a class name')
    self._parent[name] = parent
    table = self._tree.setdefault(name, {})
    for child in delem:
      if child.tag == 'default':
        self._walk(child, name)
      else:
        table.setdefault(child.tag, {}).update(child.attrib)

  def resolve(self, cls: str, tag: str) -> Dict[str, str]:
    key = (cls, tag)
    if key in self._cache:
      return self._cache[key]
    chain = []
    c = cls
    while c is not None:
      chain.append(c)
      c = self._parent.get(c)
    attrs: Dict[str, str] = {}
    for c in reversed(chain):
      attrs.update(self._tree.get(c, {}).get(tag, {}))
    self._cache[key] = attrs
    return attrs


# ---------------------------------------------------------------------------
# Geom mass properties.
# ---------------------------------------------------------------------------


def _geom_volume(gtype: T.GeomType, size: np.ndarray) -> float:
  r = size[0]
  if gtype == T.GeomType.SPHERE:
    return 4.0 / 3.0 * np.pi * r ** 3
  if gtype == T.GeomType.CAPSULE:
    return np.pi * r * r * (2 * size[1]) + 4.0 / 3.0 * np.pi * r ** 3
  if gtype == T.GeomType.CYLINDER:
    return np.pi * r * r * (2 * size[1])
  if gtype == T.GeomType.BOX:
    return 8.0 * size[0] * size[1] * size[2]
  if gtype == T.GeomType.ELLIPSOID:
    return 4.0 / 3.0 * np.pi * size[0] * size[1] * size[2]
  if gtype in (T.GeomType.PLANE, T.GeomType.HFIELD):
    return 0.0
  raise NotImplementedError(f'volume for geom type {gtype}')


def _geom_inertia(gtype: T.GeomType, size: np.ndarray,
                  mass: float) -> np.ndarray:
  """Principal rotational inertia (3,) about the geom com, geom frame."""
  r = size[0]
  if gtype == T.GeomType.SPHERE:
    i = 0.4 * mass * r * r
    return np.array([i, i, i])
  if gtype == T.GeomType.CAPSULE:
    h = size[1]
    vc = np.pi * r * r * (2 * h)
    vs = 4.0 / 3.0 * np.pi * r ** 3
    ms = mass * vs / (vc + vs)
    mc = mass - ms
    iz = mc * 0.5 * r * r + ms * 0.4 * r * r
    ix = (mc * (h * h / 3.0 + r * r / 4.0)
          + ms * (0.4 * r * r + 0.75 * r * h + h * h))
    return np.array([ix, ix, iz])
  if gtype == T.GeomType.CYLINDER:
    h = size[1]
    iz = mass * r * r / 2.0
    ix = mass * (r * r / 4.0 + h * h / 3.0)
    return np.array([ix, ix, iz])
  if gtype == T.GeomType.BOX:
    sx, sy, sz = size[:3]
    return mass / 3.0 * np.array(
        [sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])
  if gtype == T.GeomType.ELLIPSOID:
    a, b, c = size[:3]
    return mass / 5.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
  if gtype in (T.GeomType.PLANE, T.GeomType.HFIELD):
    return np.zeros(3)
  raise NotImplementedError(f'inertia for geom type {gtype}')


def _geom_rbound(gtype: T.GeomType, size: np.ndarray) -> float:
  if gtype == T.GeomType.SPHERE:
    return size[0]
  if gtype == T.GeomType.CAPSULE:
    return size[0] + size[1]
  if gtype == T.GeomType.CYLINDER:
    return float(np.sqrt(size[0] ** 2 + size[1] ** 2))
  if gtype == T.GeomType.BOX:
    return float(np.linalg.norm(size[:3]))
  if gtype == T.GeomType.ELLIPSOID:
    return float(np.max(size[:3]))
  return 0.0  # plane / hfield: infinite, handled specially in collision


_GEOM_TYPES = {
    'plane': T.GeomType.PLANE, 'hfield': T.GeomType.HFIELD,
    'sphere': T.GeomType.SPHERE, 'capsule': T.GeomType.CAPSULE,
    'ellipsoid': T.GeomType.ELLIPSOID, 'cylinder': T.GeomType.CYLINDER,
    'box': T.GeomType.BOX, 'mesh': T.GeomType.MESH,
}

_JOINT_TYPES = {
    'free': T.JointType.FREE, 'ball': T.JointType.BALL,
    'slide': T.JointType.SLIDE, 'hinge': T.JointType.HINGE,
}

_SENSOR_INFO = {
    # tag -> (SensorType, dim, default objtype-attr)
    'touch': (T.SensorType.TOUCH, 1, 'site'),
    'accelerometer': (T.SensorType.ACCELEROMETER, 3, 'site'),
    'velocimeter': (T.SensorType.VELOCIMETER, 3, 'site'),
    'gyro': (T.SensorType.GYRO, 3, 'site'),
    'force': (T.SensorType.FORCE, 3, 'site'),
    'torque': (T.SensorType.TORQUE, 3, 'site'),
    'magnetometer': (T.SensorType.MAGNETOMETER, 3, 'site'),
    'rangefinder': (T.SensorType.RANGEFINDER, 1, 'site'),
    'jointpos': (T.SensorType.JOINTPOS, 1, 'joint'),
    'jointvel': (T.SensorType.JOINTVEL, 1, 'joint'),
    'tendonpos': (T.SensorType.TENDONPOS, 1, 'tendon'),
    'tendonvel': (T.SensorType.TENDONVEL, 1, 'tendon'),
    'actuatorpos': (T.SensorType.ACTUATORPOS, 1, 'actuator'),
    'actuatorvel': (T.SensorType.ACTUATORVEL, 1, 'actuator'),
    'actuatorfrc': (T.SensorType.ACTUATORFRC, 1, 'actuator'),
    'ballquat': (T.SensorType.BALLQUAT, 4, 'joint'),
    'ballangvel': (T.SensorType.BALLANGVEL, 3, 'joint'),
    'framepos': (T.SensorType.FRAMEPOS, 3, None),
    'framequat': (T.SensorType.FRAMEQUAT, 4, None),
    'framexaxis': (T.SensorType.FRAMEXAXIS, 3, None),
    'frameyaxis': (T.SensorType.FRAMEYAXIS, 3, None),
    'framezaxis': (T.SensorType.FRAMEZAXIS, 3, None),
    'framelinvel': (T.SensorType.FRAMELINVEL, 3, None),
    'frameangvel': (T.SensorType.FRAMEANGVEL, 3, None),
    'framelinacc': (T.SensorType.FRAMELINACC, 3, None),
    'frameangacc': (T.SensorType.FRAMEANGACC, 3, None),
    'subtreecom': (T.SensorType.SUBTREECOM, 3, 'body'),
    'subtreelinvel': (T.SensorType.SUBTREELINVEL, 3, 'body'),
    'subtreeangmom': (T.SensorType.SUBTREEANGMOM, 3, 'body'),
    'clock': (T.SensorType.CLOCK, 1, None),
}

_OBJTYPE_BY_ATTR = {
    'body': T.ObjType.BODY, 'xbody': T.ObjType.XBODY,
    'joint': T.ObjType.JOINT, 'geom': T.ObjType.GEOM,
    'site': T.ObjType.SITE, 'camera': T.ObjType.CAMERA,
    'tendon': T.ObjType.TENDON, 'actuator': T.ObjType.ACTUATOR,
}


# ---------------------------------------------------------------------------
# Intermediate mutable records.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Body:
  name: str
  parentid: int
  pos: np.ndarray
  quat: np.ndarray
  # explicit inertial spec (None -> from geoms)
  imass: Optional[float] = None
  ipos: Optional[np.ndarray] = None
  iquat: Optional[np.ndarray] = None
  idiag: Optional[np.ndarray] = None
  ifull: Optional[np.ndarray] = None
  gravcomp: float = 0.0
  mocap: bool = False
  joints: List[int] = dataclasses.field(default_factory=list)
  geoms: List[int] = dataclasses.field(default_factory=list)


class _Builder:
  """Accumulates model records while walking the XML tree."""

  def __init__(self):
    self.bodies: List[_Body] = []
    self.joints: List[dict] = []
    self.geoms: List[dict] = []
    self.sites: List[dict] = []
    self.cams: List[dict] = []
    self.tendons: List[dict] = []
    self.wraps: List[dict] = []
    self.actuators: List[dict] = []
    self.sensors: List[dict] = []
    self.equalities: List[dict] = []
    self.keyframes: List[dict] = []
    self.pairs: List[dict] = []
    self.excludes: List[Tuple[str, str]] = []


# ---------------------------------------------------------------------------
# Main compiler.
# ---------------------------------------------------------------------------


class MJCFCompiler:

  def __init__(self, root: ET.Element, base_dir: str = '.'):
    self.root = root
    self.base_dir = base_dir
    self.defaults = _Defaults(root)
    comp = root.find('compiler')
    cattr = comp.attrib if comp is not None else {}
    self.degrees = cattr.get('angle', 'degree') == 'degree'
    self.eulerseq = cattr.get('eulerseq', 'xyz')
    self.inertiafromgeom = cattr.get('inertiafromgeom', 'auto')
    self.balanceinertia = cattr.get('balanceinertia', 'false') == 'true'
    self.settotalmass = float(cattr.get('settotalmass', '-1'))
    self.autolimits = cattr.get('autolimits', 'true') == 'true'
    self.boundmass = float(cattr.get('boundmass', '0'))
    self.boundinertia = float(cattr.get('boundinertia', '0'))
    self.meshdir = cattr.get('meshdir', '')
    self.b = _Builder()
    self._mesh_assets = {}   # name -> meshes.MeshAsset
    self._mesh_order = []    # names in declaration order
    self._parse_mesh_assets()

  def _parse_mesh_assets(self):
    from dm_control_tpu_torch.mjcf import meshes
    self._hfields = {}      # name -> dict(size, nrow, ncol)
    self._hfield_order = []
    for asset in self.root.findall('asset'):
      for me in asset.findall('mesh'):
        a = self._attrs(me, me.attrib.get('class', 'main'))
        fname = a['file']
        name = a.get('name', os.path.splitext(os.path.basename(fname))[0])
        path = os.path.join(self.base_dir, self.meshdir, fname)
        scale = _floats(a['scale']) if 'scale' in a else None
        self._mesh_assets[name] = meshes.MeshAsset(name, path, scale)
        self._mesh_order.append(name)
      for hf in asset.findall('hfield'):
        a = dict(hf.attrib)
        name = a['name']
        self._hfields[name] = dict(
            size=_floats(a['size']),
            nrow=int(a['nrow']), ncol=int(a['ncol']))
        self._hfield_order.append(name)

  # -- attribute resolution -------------------------------------------------

  def _attrs(self, elem: ET.Element, cls: str) -> Dict[str, str]:
    merged = dict(self.defaults.resolve(cls, elem.tag))
    merged.update(elem.attrib)
    return merged

  def _angle(self, x: float) -> float:
    return np.deg2rad(x) if self.degrees else x

  def _limited(self, a: Dict[str, str], key: str, range_key: str) -> bool:
    if key in a:
      v = a[key]
      if v in ('true', 'false'):
        return v == 'true'
      if v == 'auto':
        pass
      else:
        raise ValueError(f'bad {key}: {v}')
    # auto
    return self.autolimits and range_key in a

  # -- worldbody walk -------------------------------------------------------

  def _parse_materials(self):
    mats = {}
    for asset in self.root.findall('asset'):
      for mat in asset.findall('material'):
        if 'rgba' in mat.attrib:
          mats[mat.attrib.get('name', '')] = _floats(mat.attrib['rgba'])
    return mats

  def build(self) -> T.Model:
    self._materials = self._parse_materials()
    world = self.root.find('worldbody')
    if world is None:
      raise ValueError('missing <worldbody>')
    self.b.bodies.append(_Body('world', 0, np.zeros(3),
                               np.array([1.0, 0, 0, 0])))
    self._walk_body(world, 0, 'main')
    self._parse_tendons()
    self._parse_actuators()
    self._parse_sensors()
    self._parse_equality()
    self._parse_contact()
    self._parse_keyframes()
    return self._assemble()

  def _walk_body(self, elem: ET.Element, body_id: int, childclass: str):
    if 'childclass' in elem.attrib:
      childclass = elem.attrib['childclass']
    # Two phases: a body's own elements first, THEN child bodies — the
    # oracle numbers a body's joints/geoms with the body even when the
    # XML places them after nested <body> elements (e.g. dog.xml's
    # lumbar chain declares each body's joints last).
    for child in elem:
      tag = child.tag
      if tag == 'body':
        continue
      elif tag == 'joint':
        self._add_joint(child, body_id, childclass)
      elif tag == 'freejoint':
        self._add_joint(child, body_id, childclass, force_free=True)
      elif tag == 'geom':
        self._add_geom(child, body_id, childclass)
      elif tag == 'site':
        self._add_site(child, body_id, childclass)
      elif tag == 'camera':
        self._add_camera(child, body_id, childclass)
      elif tag == 'inertial':
        self._set_inertial(child, body_id)
      elif tag in ('light', 'plugin'):
        pass  # no physics effect
      elif tag in ('composite', 'flexcomp', 'attach', 'frame'):
        # physics-bearing elements this engine does not simulate:
        # fail fast instead of silently dropping bodies/flexes
        raise NotImplementedError(
            f'<{tag}> inside <body>/<worldbody> is not supported by the '
            f'TPU compiler (it would create physics state)')
      else:
        pass
    for child in elem:
      if child.tag == 'body':
        self._add_body(child, body_id, childclass)

  def _add_body(self, elem: ET.Element, parent_id: int, childclass: str):
    a = dict(elem.attrib)
    pos = _floats(a['pos']) if 'pos' in a else np.zeros(3)
    quat = _parse_orientation(a, self.degrees, self.eulerseq)
    body = _Body(
        name=a.get('name', f'body{len(self.b.bodies)}'),
        parentid=parent_id, pos=pos, quat=quat,
        gravcomp=float(a.get('gravcomp', '0')),
        mocap=a.get('mocap', 'false') == 'true')
    self.b.bodies.append(body)
    self._walk_body(elem, len(self.b.bodies) - 1, childclass)

  def _set_inertial(self, elem: ET.Element, body_id: int):
    a = dict(elem.attrib)
    body = self.b.bodies[body_id]
    body.imass = float(a['mass'])
    body.ipos = _floats(a['pos'])
    body.iquat = _parse_orientation(a, self.degrees, self.eulerseq)
    if 'diaginertia' in a:
      body.idiag = _floats(a['diaginertia'])
    elif 'fullinertia' in a:
      body.ifull = _floats(a['fullinertia'])

  def _add_joint(self, elem: ET.Element, body_id: int, childclass: str,
                 force_free: bool = False):
    cls = elem.attrib.get('class', childclass)
    a = self._attrs(elem, cls)
    jtype = T.JointType.FREE if force_free else _JOINT_TYPES[
        a.get('type', 'hinge')]
    limited = self._limited(a, 'limited', 'range')
    rng = _floats(a['range']) if 'range' in a else np.zeros(2)
    # Angle->radian conversion applies only when the limit is active.
    if (jtype in (T.JointType.HINGE, T.JointType.BALL) and self.degrees
        and limited):
      rng = np.deg2rad(rng)
    ref = float(a.get('ref', '0'))
    springref = float(a.get('springref', '0'))
    if jtype == T.JointType.HINGE and self.degrees:
      ref = np.deg2rad(ref)
      springref = np.deg2rad(springref)
    self.b.joints.append(dict(
        name=a.get('name', f'joint{len(self.b.joints)}'),
        type=jtype, bodyid=body_id,
        pos=_floats(a['pos']) if 'pos' in a else np.zeros(3),
        axis=(_floats(a['axis']) if 'axis' in a
              else np.array([0.0, 0.0, 1.0])),
        limited=limited,
        actfrclimited=self._limited(a, 'actuatorfrclimited',
                                    'actuatorfrcrange'),
        range=rng,
        actfrcrange=(_floats(a['actuatorfrcrange'])
                     if 'actuatorfrcrange' in a else np.zeros(2)),
        stiffness=float(a.get('stiffness', '0')),
        damping=float(a.get('damping', '0')),
        springdamper=(_floats(a['springdamper'])
                      if 'springdamper' in a else None),
        armature=float(a.get('armature', '0')),
        frictionloss=float(a.get('frictionloss', '0')),
        ref=ref, springref=springref,
        margin=self._angle(float(a.get('margin', '0')))
        if jtype in (T.JointType.HINGE, T.JointType.BALL)
        else float(a.get('margin', '0')),
        solref=_padded(a, 'solreflimit', _SOLREF_DEF),
        solimp=_padded(a, 'solimplimit', _SOLIMP_DEF),
        solref_fric=_padded(a, 'solreffriction', _SOLREF_DEF),
        solimp_fric=_padded(a, 'solimpfriction', _SOLIMP_DEF),
    ))
    self.b.bodies[body_id].joints.append(len(self.b.joints) - 1)

  def _add_geom(self, elem: ET.Element, body_id: int, childclass: str):
    cls = elem.attrib.get('class', childclass)
    a = self._attrs(elem, cls)
    gtype = _GEOM_TYPES[a.get('type', 'sphere')]
    mesh_name = None
    hfield_name = None
    if gtype == T.GeomType.MESH or 'mesh' in a:
      gtype = T.GeomType.MESH
      mesh_name = a['mesh']
      if mesh_name not in self._mesh_assets:
        raise ValueError(f'unknown mesh asset {mesh_name!r}')
    if gtype == T.GeomType.HFIELD:
      hfield_name = a['hfield']
      if hfield_name not in self._hfields:
        raise ValueError(f'unknown hfield asset {hfield_name!r}')
    size = np.zeros(3)
    sz = _floats(a['size']) if 'size' in a else np.zeros(0)
    size[:len(sz)] = sz[:3]
    if 'fromto' in a:
      ft = _floats(a['fromto'])
      p1, p2 = ft[:3], ft[3:]
      pos = (p1 + p2) / 2
      # fromto orients local z along (from - to) -- opposite of the zaxis=
      # convention; verified against the oracle incl. the parallel case.
      quat = _nquat_z_to(p1 - p2)
      size[1] = np.linalg.norm(p2 - p1) / 2
    else:
      pos = _floats(a['pos']) if 'pos' in a else np.zeros(3)
      quat = _parse_orientation(a, self.degrees, self.eulerseq)
    friction = np.array([1.0, 0.005, 0.0001])
    if 'friction' in a:
      f = _floats(a['friction'])
      friction[:len(f)] = f
    if 'rgba' in a:
      rgba = _floats(a['rgba'])
    elif a.get('material') in getattr(self, '_materials', {}):
      rgba = self._materials[a['material']]
    else:
      rgba = np.array([0.5, 0.5, 0.5, 1.0])
    mass = float(a['mass']) if 'mass' in a else None
    density = float(a.get('density', '1000'))
    self.b.geoms.append(dict(
        name=a.get('name', f'geom{len(self.b.geoms)}'),
        type=gtype, bodyid=body_id, pos=pos, quat=quat, size=size,
        contype=int(a.get('contype', '1')),
        conaffinity=int(a.get('conaffinity', '1')),
        condim=int(a.get('condim', '3')),
        priority=int(a.get('priority', '0')),
        material=a.get('material', ''),
        friction=friction, mass=mass, density=density,
        margin=float(a.get('margin', '0')),
        gap=float(a.get('gap', '0')),
        solmix=float(a.get('solmix', '1')),
        solref=_padded(a, 'solref', _SOLREF_DEF),
        solimp=_padded(a, 'solimp', _SOLIMP_DEF),
        rgba=rgba,
        mesh=mesh_name,
        hfield=hfield_name,
    ))
    self.b.bodies[body_id].geoms.append(len(self.b.geoms) - 1)

  def _add_site(self, elem: ET.Element, body_id: int, childclass: str):
    cls = elem.attrib.get('class', childclass)
    a = self._attrs(elem, cls)
    size = np.full(3, 0.005)
    if 'size' in a:
      sz = _floats(a['size'])
      size[:len(sz)] = sz[:3]
    if 'fromto' in a:
      ft = _floats(a['fromto'])
      p1, p2 = ft[:3], ft[3:]
      pos = (p1 + p2) / 2
      # fromto orients local z along (from - to) -- opposite of the zaxis=
      # convention; verified against the oracle incl. the parallel case.
      quat = _nquat_z_to(p1 - p2)
      size[1] = np.linalg.norm(p2 - p1) / 2
    else:
      pos = _floats(a['pos']) if 'pos' in a else np.zeros(3)
      quat = _parse_orientation(a, self.degrees, self.eulerseq)
    self.b.sites.append(dict(
        name=a.get('name', f'site{len(self.b.sites)}'),
        bodyid=body_id, pos=pos, quat=quat, size=size,
        type=_GEOM_TYPES[a.get('type', 'sphere')],
    ))

  def _add_camera(self, elem: ET.Element, body_id: int, childclass: str):
    cls = elem.attrib.get('class', childclass)
    a = self._attrs(elem, cls)
    self.b.cams.append(dict(
        name=a.get('name', f'cam{len(self.b.cams)}'),
        bodyid=body_id,
        pos=_floats(a['pos']) if 'pos' in a else np.zeros(3),
        quat=_parse_orientation(a, self.degrees, self.eulerseq),
        mode=a.get('mode', 'fixed'),
        fovy=float(a.get('fovy', '45')),
    ))

  # -- non-worldbody sections ----------------------------------------------

  def _parse_tendons(self):
    sec = [el for s in self.root.findall('tendon') for el in s]
    sec = sec or None
    if sec is None:
      return
    for t in sec:
      cls = t.attrib.get('class', 'main')
      a = dict(self.defaults.resolve(cls, t.tag))
      a.update(t.attrib)
      rng = _floats(a['range']) if 'range' in a else np.zeros(2)
      springlength = (_floats(a['springlength'])
                      if 'springlength' in a else np.array([-1.0, -1.0]))
      if springlength.size == 1:
        springlength = np.array([springlength[0], springlength[0]])
      rec = dict(
          name=a.get('name', f'tendon{len(self.b.tendons)}'),
          kind=t.tag,
          limited=self._limited(a, 'limited', 'range'),
          range=rng,
          margin=float(a.get('margin', '0')),
          stiffness=float(a.get('stiffness', '0')),
          damping=float(a.get('damping', '0')),
          frictionloss=float(a.get('frictionloss', '0')),
          lengthspring=springlength,
          solref=_padded(a, 'solreflimit', _SOLREF_DEF),
          solimp=_padded(a, 'solimplimit', _SOLIMP_DEF),
          adr=len(self.b.wraps), num=0)
      if t.tag == 'fixed':
        for w in t.findall('joint'):
          self.b.wraps.append(dict(
              type=T.WrapType.JOINT, obj=w.attrib['joint'],
              prm=float(w.attrib['coef'])))
          rec['num'] += 1
      elif t.tag == 'spatial':
        for w in t:
          if w.tag == 'site':
            self.b.wraps.append(dict(
                type=T.WrapType.SITE, obj=w.attrib['site'], prm=0.0))
            rec['num'] += 1
          elif w.tag == 'geom':
            raise NotImplementedError('tendon geom wrapping not supported')
      else:
        raise NotImplementedError(f'tendon kind {t.tag}')
      self.b.tendons.append(rec)

  def _parse_actuators(self):
    sec = [el for s in self.root.findall('actuator') for el in s]
    sec = sec or None
    if sec is None:
      return
    for el in sec:
      cls = el.attrib.get('class', 'main')
      a = dict(self.defaults.resolve(cls, el.tag))
      # shorthand defaults also inherit from <general> defaults
      base = dict(self.defaults.resolve(cls, 'general'))
      base.update(a)
      a = base
      a.update(el.attrib)
      gear = np.zeros(6)
      g = _floats(a.get('gear', '1'))
      gear[:len(g)] = g
      dynprm = np.zeros(10)
      gainprm = np.zeros(10)
      biasprm = np.zeros(10)
      dynprm[0] = 1.0
      gainprm[0] = 1.0
      tag = el.tag
      if tag == 'motor':
        dyntype, gaintype, biastype = (
            T.DynType.NONE, T.GainType.FIXED, T.BiasType.NONE)
      elif tag == 'position':
        kp = float(a.get('kp', '1'))
        kv = float(a.get('kv', '0'))
        gainprm[0] = kp
        biasprm[1] = -kp
        biasprm[2] = -kv
        dyntype, gaintype, biastype = (
            T.DynType.NONE, T.GainType.FIXED, T.BiasType.AFFINE)
      elif tag == 'velocity':
        kv = float(a.get('kv', '1'))
        gainprm[0] = kv
        biasprm[2] = -kv
        dyntype, gaintype, biastype = (
            T.DynType.NONE, T.GainType.FIXED, T.BiasType.AFFINE)
      elif tag == 'general':
        dyntype = dict(
            none=T.DynType.NONE, integrator=T.DynType.INTEGRATOR,
            filter=T.DynType.FILTER, filterexact=T.DynType.FILTEREXACT,
            muscle=T.DynType.MUSCLE)[a.get('dyntype', 'none')]
        gaintype = dict(fixed=T.GainType.FIXED, affine=T.GainType.AFFINE,
                        muscle=T.GainType.MUSCLE)[a.get('gaintype', 'fixed')]
        biastype = dict(none=T.BiasType.NONE, affine=T.BiasType.AFFINE,
                        muscle=T.BiasType.MUSCLE)[a.get('biastype', 'none')]
        for key, arr in (('dynprm', dynprm), ('gainprm', gainprm),
                         ('biasprm', biasprm)):
          if key in a:
            v = _floats(a[key])
            arr[:len(v)] = v
      else:
        raise NotImplementedError(f'actuator <{tag}>')
      if 'joint' in a:
        trntype, trn = T.TrnType.JOINT, ('joint', a['joint'])
      elif 'tendon' in a:
        trntype, trn = T.TrnType.TENDON, ('tendon', a['tendon'])
      elif 'site' in a:
        trntype, trn = T.TrnType.SITE, ('site', a['site'])
      else:
        raise ValueError('actuator needs joint/tendon/site transmission')
      self.b.actuators.append(dict(
          name=a.get('name', f'actuator{len(self.b.actuators)}'),
          trntype=trntype, trn=trn,
          dyntype=dyntype, gaintype=gaintype, biastype=biastype,
          dynprm=dynprm, gainprm=gainprm, biasprm=biasprm, gear=gear,
          ctrllimited=self._limited(a, 'ctrllimited', 'ctrlrange'),
          forcelimited=self._limited(a, 'forcelimited', 'forcerange'),
          actlimited=self._limited(a, 'actlimited', 'actrange'),
          ctrlrange=(_floats(a['ctrlrange']) if 'ctrlrange' in a
                     else np.zeros(2)),
          forcerange=(_floats(a['forcerange']) if 'forcerange' in a
                      else np.zeros(2)),
          actrange=(_floats(a['actrange']) if 'actrange' in a
                    else np.zeros(2)),
      ))

  def _parse_sensors(self):
    sec = [el for s in self.root.findall('sensor') for el in s]
    sec = sec or None
    if sec is None:
      return
    for el in sec:
      if el.tag not in _SENSOR_INFO:
        raise NotImplementedError(f'sensor <{el.tag}>')
      stype, dim, obj_attr = _SENSOR_INFO[el.tag]
      a = dict(el.attrib)
      if obj_attr is not None:
        objtype = _OBJTYPE_BY_ATTR[obj_attr]
        objname = a[obj_attr]
      elif el.tag == 'clock':
        objtype, objname = T.ObjType.BODY, None
      else:
        # frame sensors: objtype= & objname=
        objtype = _OBJTYPE_BY_ATTR[a['objtype']]
        objname = a['objname']
      reftype, refname = -1, None
      if 'reftype' in a:
        reftype = int(_OBJTYPE_BY_ATTR[a['reftype']])
        refname = a['refname']
      self.b.sensors.append(dict(
          name=a.get('name', f'sensor{len(self.b.sensors)}'),
          type=stype, dim=dim, objtype=objtype, objname=objname,
          reftype=reftype, refname=refname,
          cutoff=float(a.get('cutoff', '0')),
      ))

  def _parse_equality(self):
    sec = [el for s in self.root.findall('equality') for el in s]
    sec = sec or None
    if sec is None:
      return
    for el in sec:
      cls = el.attrib.get('class', 'main')
      # defaults for all equality kinds live under the <equality> tag
      a = dict(self.defaults.resolve(cls, 'equality'))
      a.update(el.attrib)
      data = np.zeros(11)
      if el.tag == 'connect':
        etype = T.EqType.CONNECT
        obj1, obj2 = a['body1'], a.get('body2', 'world')
        data[:3] = _floats(a['anchor'])
      elif el.tag == 'weld':
        etype = T.EqType.WELD
        obj1, obj2 = a['body1'], a.get('body2', 'world')
        if 'relpose' in a:
          data[3:10] = _floats(a['relpose'])
        else:
          data[6] = 1.0  # identity quat w in slot
        if 'anchor' in a:
          data[:3] = _floats(a['anchor'])
      elif el.tag == 'joint':
        etype = T.EqType.JOINT
        obj1, obj2 = a['joint1'], a.get('joint2', None)
        poly = _floats(a.get('polycoef', '0 1 0 0 0'))
        data[:len(poly)] = poly
      elif el.tag == 'tendon':
        etype = T.EqType.TENDON
        obj1, obj2 = a['tendon1'], a.get('tendon2', None)
        poly = _floats(a.get('polycoef', '0 1 0 0 0'))
        data[:len(poly)] = poly
      else:
        raise NotImplementedError(f'equality <{el.tag}>')
      self.b.equalities.append(dict(
          type=etype, obj1=obj1, obj2=obj2, data=data,
          active=a.get('active', 'true') == 'true',
          solref=_padded(a, 'solref', _SOLREF_DEF),
          solimp=_padded(a, 'solimp', _SOLIMP_DEF),
      ))

  def _parse_contact(self):
    sec = [el for s in self.root.findall('contact') for el in s]
    sec = sec or None
    if sec is None:
      return
    for el in sec:
      if el.tag == 'exclude':
        self.b.excludes.append((el.attrib['body1'], el.attrib['body2']))
      elif el.tag == 'pair':
        cls = el.attrib.get('class', 'main')
        a = dict(self.defaults.resolve(cls, 'pair'))
        a.update(el.attrib)
        friction = np.array([1.0, 1.0, 0.005, 0.0001, 0.0001])
        if 'friction' in a:
          f = _floats(a['friction'])
          friction[:len(f)] = f
        self.b.pairs.append(dict(
            geom1=a['geom1'], geom2=a['geom2'],
            condim=int(a.get('condim', '3')),
            friction=friction,
            margin=float(a.get('margin', '0')),
            gap=float(a.get('gap', '0')),
            solref=_padded(a, 'solref', _SOLREF_DEF),
            solimp=_padded(a, 'solimp', _SOLIMP_DEF),
        ))

  def _parse_keyframes(self):
    sec = [el for s in self.root.findall('keyframe') for el in s]
    sec = sec or None
    if sec is None:
      return
    for el in sec.findall('key'):
      a = dict(el.attrib)
      self.b.keyframes.append(dict(
          name=a.get('name', f'key{len(self.b.keyframes)}'),
          time=float(a.get('time', '0')),
          qpos=_floats(a['qpos']) if 'qpos' in a else None,
          qvel=_floats(a['qvel']) if 'qvel' in a else None,
          act=_floats(a['act']) if 'act' in a else None,
          ctrl=_floats(a['ctrl']) if 'ctrl' in a else None,
      ))

  # -- options --------------------------------------------------------------

  def _parse_option(self) -> T.Option:
    # MJCF allows multiple <option> elements; merge attributes and flags
    els = self.root.findall('option')
    a = {}
    for el in els:
      a.update(el.attrib)
    disable = 0
    flag_map = dict(
        constraint=T.DisableBit.CONSTRAINT, equality=T.DisableBit.EQUALITY,
        frictionloss=T.DisableBit.FRICTIONLOSS, limit=T.DisableBit.LIMIT,
        contact=T.DisableBit.CONTACT, passive=T.DisableBit.PASSIVE,
        spring=T.DisableBit.SPRING, damper=T.DisableBit.DAMPER,
        gravity=T.DisableBit.GRAVITY, clampctrl=T.DisableBit.CLAMPCTRL,
        actuation=T.DisableBit.ACTUATION, refsafe=T.DisableBit.REFSAFE,
        sensor=T.DisableBit.SENSOR, eulerdamp=T.DisableBit.EULERDAMP,
        filterparent=T.DisableBit.FILTERPARENT,
    )
    for el in els:
      fl = el.find('flag')
      if fl is not None:
        for k, v in fl.attrib.items():
          if k in flag_map and v == 'disable':
            disable |= int(flag_map[k])
    integ = dict(Euler=T.Integrator.EULER, RK4=T.Integrator.RK4,
                 implicit=T.Integrator.IMPLICIT,
                 implicitfast=T.Integrator.IMPLICIT)[
                     a.get('integrator', 'Euler')]
    solver = dict(PGS=T.SolverType.PGS, CG=T.SolverType.CG,
                  Newton=T.SolverType.NEWTON)[a.get('solver', 'Newton')]
    cone = dict(pyramidal=T.ConeType.PYRAMIDAL,
                elliptic=T.ConeType.ELLIPTIC)[a.get('cone', 'pyramidal')]
    grav = _floats(a.get('gravity', '0 0 -9.81'))
    wind = _floats(a.get('wind', '0 0 0'))
    mag = _floats(a.get('magnetic', '0 -0.5 0'))
    return T.Option(
        timestep=float(a.get('timestep', '0.002')),
        gravity=tuple(grav), wind=tuple(wind), magnetic=tuple(mag),
        density=float(a.get('density', '0')),
        viscosity=float(a.get('viscosity', '0')),
        integrator=integ, solver=solver, cone=cone,
        iterations=int(a.get('iterations', '100')),
        ls_iterations=int(a.get('ls_iterations', '50')),
        tolerance=float(a.get('tolerance', '1e-8')),
        ls_tolerance=float(a.get('ls_tolerance', '0.01')),
        impratio=float(a.get('impratio', '1')),
        noslip_iterations=int(a.get('noslip_iterations', '0')),
        noslip_tolerance=float(a.get('noslip_tolerance', '1e-6')),
        disableflags=disable,
    )

  # -- assembly -------------------------------------------------------------

  def _reorder_by_body(self):
    """Stable-sort geoms/sites/cams by body id (matching oracle ordering)."""
    b = self.b
    for attr in ('geoms', 'sites', 'cams'):
      lst = getattr(b, attr)
      order = sorted(range(len(lst)), key=lambda i: lst[i]['bodyid'])
      setattr(b, attr, [lst[i] for i in order])
    for bd in b.bodies:
      bd.geoms = []
    for gid, g in enumerate(b.geoms):
      b.bodies[g['bodyid']].geoms.append(gid)

  def _assemble(self) -> T.Model:
    self._reorder_by_body()
    b = self.b
    m = T.Model()
    m.opt = self._parse_option()

    nbody = len(b.bodies)
    njnt = len(b.joints)
    ngeom = len(b.geoms)
    nsite = len(b.sites)

    # --- joint/dof addressing
    jnt_qposadr = np.zeros(njnt, np.int32)
    jnt_dofadr = np.zeros(njnt, np.int32)
    nq = nv = 0
    for j, jd in enumerate(b.joints):
      jnt_qposadr[j] = nq
      jnt_dofadr[j] = nv
      nq += T.JOINT_NQ[jd['type']]
      nv += T.JOINT_NV[jd['type']]

    # --- body tables
    m.nbody, m.njnt, m.ngeom, m.nsite = nbody, njnt, ngeom, nsite
    m.nq, m.nv = nq, nv
    m.body_parentid = np.array([bd.parentid for bd in b.bodies], np.int32)
    m.body_pos = np.stack([bd.pos for bd in b.bodies]).astype(np.float64)
    m.body_quat = np.stack([bd.quat for bd in b.bodies]).astype(np.float64)
    m.body_jntnum = np.array([len(bd.joints) for bd in b.bodies], np.int32)
    m.body_jntadr = np.array(
        [bd.joints[0] if bd.joints else -1 for bd in b.bodies], np.int32)
    m.body_geomnum = np.array([len(bd.geoms) for bd in b.bodies], np.int32)
    m.body_geomadr = np.array(
        [bd.geoms[0] if bd.geoms else -1 for bd in b.bodies], np.int32)
    m.body_gravcomp = np.array([bd.gravcomp for bd in b.bodies], np.float64)
    m.body_mocapid = np.full(nbody, -1, np.int32)
    nmocap = 0
    for i, bd in enumerate(b.bodies):
      if bd.mocap:
        m.body_mocapid[i] = nmocap
        nmocap += 1
    m.nmocap = nmocap

    body_dofnum = np.zeros(nbody, np.int32)
    body_dofadr = np.full(nbody, -1, np.int32)
    for j, jd in enumerate(b.joints):
      bid = jd['bodyid']
      if body_dofadr[bid] < 0:
        body_dofadr[bid] = jnt_dofadr[j]
      body_dofnum[bid] += T.JOINT_NV[jd['type']]
    m.body_dofnum, m.body_dofadr = body_dofnum, body_dofadr

    # rootid / weldid
    rootid = np.zeros(nbody, np.int32)
    weldid = np.zeros(nbody, np.int32)
    for i in range(1, nbody):
      p = m.body_parentid[i]
      # root: highest ancestor below world
      rootid[i] = i if p == 0 else rootid[p]
      weldid[i] = i if body_dofnum[i] > 0 else weldid[p]
    m.body_rootid, m.body_weldid = rootid, weldid

    # --- joints
    m.jnt_type = np.array([int(j['type']) for j in b.joints], np.int32)
    m.jnt_qposadr, m.jnt_dofadr = jnt_qposadr, jnt_dofadr
    m.jnt_bodyid = np.array([j['bodyid'] for j in b.joints], np.int32)
    m.jnt_pos = (np.stack([j['pos'] for j in b.joints])
                 if njnt else np.zeros((0, 3)))
    m.jnt_axis = (np.stack(
        [j['axis'] / max(np.linalg.norm(j['axis']), _EPS) for j in b.joints])
                  if njnt else np.zeros((0, 3)))
    m.jnt_limited = np.array([j['limited'] for j in b.joints], bool)
    m.jnt_actfrclimited = np.array(
        [j['actfrclimited'] for j in b.joints], bool)
    m.jnt_range = (np.stack([j['range'] for j in b.joints])
                   if njnt else np.zeros((0, 2)))
    m.jnt_actfrcrange = (np.stack([j['actfrcrange'] for j in b.joints])
                         if njnt else np.zeros((0, 2)))
    m.jnt_stiffness = np.array([j['stiffness'] for j in b.joints], np.float64)
    m.jnt_springdamper = np.stack(
        [j.get('springdamper') if j.get('springdamper') is not None
         else np.zeros(2) for j in b.joints]) if b.joints else np.zeros(
             (0, 2))
    m.jnt_margin = np.array([j['margin'] for j in b.joints], np.float64)
    m.jnt_solref = (np.stack([j['solref'] for j in b.joints])
                    if njnt else np.zeros((0, 2)))
    m.jnt_solimp = (np.stack([j['solimp'] for j in b.joints])
                    if njnt else np.zeros((0, 5)))

    # --- dofs
    dof_bodyid = np.zeros(nv, np.int32)
    dof_jntid = np.zeros(nv, np.int32)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    dof_solref = np.tile(np.array([0.02, 1.0]), (nv, 1))
    dof_solimp = np.tile(np.array([0.9, 0.95, 0.001, 0.5, 2.0]), (nv, 1))
    for j, jd in enumerate(b.joints):
      adr, n = jnt_dofadr[j], T.JOINT_NV[jd['type']]
      dof_bodyid[adr:adr + n] = jd['bodyid']
      dof_jntid[adr:adr + n] = j
      dof_armature[adr:adr + n] = jd['armature']
      dof_damping[adr:adr + n] = jd['damping']
      dof_frictionloss[adr:adr + n] = jd['frictionloss']
      dof_solref[adr:adr + n] = jd['solref_fric']
      dof_solimp[adr:adr + n] = jd['solimp_fric']
    m.dof_bodyid, m.dof_jntid = dof_bodyid, dof_jntid
    m.dof_armature, m.dof_damping = dof_armature, dof_damping
    m.dof_frictionloss = dof_frictionloss
    m.dof_solref, m.dof_solimp = dof_solref, dof_solimp

    # dof_parentid: previous dof in the kinematic chain
    dof_parentid = np.full(nv, -1, np.int32)
    # last dof of each body's chain
    last_dof = np.full(nbody, -1, np.int32)
    for i in range(1, nbody):
      last_dof[i] = last_dof[m.body_parentid[i]]
      adr, n = body_dofadr[i], body_dofnum[i]
      if n > 0:
        for d in range(adr, adr + n):
          dof_parentid[d] = last_dof[i] if d == adr else d - 1
        last_dof[i] = adr + n - 1
    m.dof_parentid = dof_parentid

    # ancestry mask
    mask = np.zeros((nbody, nv))
    for i in range(1, nbody):
      mask[i] = mask[m.body_parentid[i]]
      adr, n = body_dofadr[i], body_dofnum[i]
      if n > 0:
        mask[i, adr:adr + n] = 1.0
    m.body_dof_mask = mask

    # --- qpos0 / qpos_spring
    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    for j, jd in enumerate(b.joints):
      adr = jnt_qposadr[j]
      if jd['type'] == T.JointType.FREE:
        body = b.bodies[jd['bodyid']]
        qpos0[adr:adr + 3] = body.pos
        qpos0[adr + 3:adr + 7] = body.quat
        qpos_spring[adr:adr + 7] = qpos0[adr:adr + 7]
      elif jd['type'] == T.JointType.BALL:
        qpos0[adr:adr + 4] = [1, 0, 0, 0]
        qpos_spring[adr:adr + 4] = [1, 0, 0, 0]
      else:
        qpos0[adr] = jd['ref']
        qpos_spring[adr] = jd['springref']
    m.qpos0, m.qpos_spring = qpos0, qpos_spring

    # --- geoms
    m.geom_type = np.array([int(g['type']) for g in b.geoms], np.int32)
    m.geom_bodyid = np.array([g['bodyid'] for g in b.geoms], np.int32)
    m.geom_contype = np.array([g['contype'] for g in b.geoms], np.int32)
    m.geom_conaffinity = np.array(
        [g['conaffinity'] for g in b.geoms], np.int32)
    m.geom_condim = np.array([g['condim'] for g in b.geoms], np.int32)
    m.geom_priority = np.array([g['priority'] for g in b.geoms], np.int32)
    m.geom_pos = (np.stack([g['pos'] for g in b.geoms])
                  if ngeom else np.zeros((0, 3)))
    m.geom_quat = (np.stack([g['quat'] for g in b.geoms])
                   if ngeom else np.zeros((0, 4)))
    m.geom_size = (np.stack([g['size'] for g in b.geoms])
                   if ngeom else np.zeros((0, 3)))
    m.geom_friction = (np.stack([g['friction'] for g in b.geoms])
                       if ngeom else np.zeros((0, 3)))
    m.geom_margin = np.array([g['margin'] for g in b.geoms], np.float64)
    m.geom_gap = np.array([g['gap'] for g in b.geoms], np.float64)
    m.geom_solmix = np.array([g['solmix'] for g in b.geoms], np.float64)
    m.geom_solref = (np.stack([g['solref'] for g in b.geoms])
                     if ngeom else np.zeros((0, 2)))
    m.geom_solimp = (np.stack([g['solimp'] for g in b.geoms])
                     if ngeom else np.zeros((0, 5)))
    mesh_id = {n: i for i, n in enumerate(self._mesh_order)}
    hf_id = {n: i for i, n in enumerate(self._hfield_order)}
    m.geom_dataid = np.array(
        [mesh_id.get(g.get('mesh'),
                     hf_id.get(g.get('hfield'), -1)) for g in b.geoms],
        np.int32)
    m.mesh_vert = [self._mesh_assets[n].verts for n in self._mesh_order]
    m.mesh_face = [self._mesh_assets[n].faces for n in self._mesh_order]
    m.mesh_hull = [self._mesh_assets[n].hull for n in self._mesh_order]
    m.nhfield = len(self._hfield_order)
    m.hfield_size = (np.stack(
        [self._hfields[n]['size'] for n in self._hfield_order])
        if m.nhfield else np.zeros((0, 4)))
    m.hfield_nrow = np.array(
        [self._hfields[n]['nrow'] for n in self._hfield_order], np.int32)
    m.hfield_ncol = np.array(
        [self._hfields[n]['ncol'] for n in self._hfield_order], np.int32)
    m.hfield_adr = (np.concatenate(
        [[0], np.cumsum(m.hfield_nrow * m.hfield_ncol)[:-1]]).astype(
            np.int32) if m.nhfield else np.zeros(0, np.int32))
    m.hfield_data = np.zeros(int((m.hfield_nrow * m.hfield_ncol).sum()))
    m.geom_rbound = np.array(
        [self._mesh_assets[g['mesh']].rbound if g.get('mesh')
         else _geom_rbound(T.GeomType(g['type']), g['size'])
         for g in b.geoms])
    m.geom_rgba = (np.stack([g['rgba'] for g in b.geoms])
                   if ngeom else np.zeros((0, 4)))
    # material metadata for reward visualization (reference
    # suite/base.py:100-112 blends self/effector/target materials)
    m.geom_material = [g.get('material', '') for g in b.geoms]
    m.mat_rgba_by_name = dict(getattr(self, '_materials', {}))

    # --- body mass properties
    self._compute_inertia(m)

    # --- sites
    m.site_bodyid = np.array([s['bodyid'] for s in b.sites], np.int32)
    m.site_pos = (np.stack([s['pos'] for s in b.sites])
                  if nsite else np.zeros((0, 3)))
    m.site_quat = (np.stack([s['quat'] for s in b.sites])
                   if nsite else np.zeros((0, 4)))
    m.site_size = (np.stack([s['size'] for s in b.sites])
                   if nsite else np.zeros((0, 3)))
    m.site_type = np.array([int(s['type']) for s in b.sites], np.int32)

    # --- cameras
    m.ncam = len(b.cams)
    m.cam_bodyid = np.array([c['bodyid'] for c in b.cams], np.int32)
    m.cam_pos = (np.stack([c['pos'] for c in b.cams])
                 if b.cams else np.zeros((0, 3)))
    m.cam_quat = (np.stack([c['quat'] for c in b.cams])
                  if b.cams else np.zeros((0, 4)))
    m.cam_mode = np.zeros(m.ncam, np.int32)
    m.cam_fovy = np.array([c['fovy'] for c in b.cams], np.float64)

    # --- names
    m.names = dict(
        body={bd.name: i for i, bd in enumerate(b.bodies)},
        joint={j['name']: i for i, j in enumerate(b.joints)},
        geom={g['name']: i for i, g in enumerate(b.geoms)},
        site={s['name']: i for i, s in enumerate(b.sites)},
        camera={c['name']: i for i, c in enumerate(b.cams)},
        tendon={t['name']: i for i, t in enumerate(b.tendons)},
        actuator={a['name']: i for i, a in enumerate(b.actuators)},
        sensor={s['name']: i for i, s in enumerate(b.sensors)},
        keyframe={k['name']: i for i, k in enumerate(b.keyframes)},
    )

    # --- tendons
    ntendon = len(b.tendons)
    m.ntendon, m.nwrap = ntendon, len(b.wraps)
    m.tendon_adr = np.array([t['adr'] for t in b.tendons], np.int32)
    m.tendon_num = np.array([t['num'] for t in b.tendons], np.int32)
    m.tendon_limited = np.array([t['limited'] for t in b.tendons], bool)
    m.tendon_range = (np.stack([t['range'] for t in b.tendons])
                      if ntendon else np.zeros((0, 2)))
    m.tendon_margin = np.array([t['margin'] for t in b.tendons], np.float64)
    m.tendon_stiffness = np.array(
        [t['stiffness'] for t in b.tendons], np.float64)
    m.tendon_damping = np.array(
        [t['damping'] for t in b.tendons], np.float64)
    m.tendon_frictionloss = np.array(
        [t['frictionloss'] for t in b.tendons], np.float64)
    m.tendon_lengthspring = (np.stack([t['lengthspring'] for t in b.tendons])
                             if ntendon else np.zeros((0, 2)))
    m.tendon_solref_lim = (np.stack([t['solref'] for t in b.tendons])
                           if ntendon else np.zeros((0, 2)))
    m.tendon_solimp_lim = (np.stack([t['solimp'] for t in b.tendons])
                           if ntendon else np.zeros((0, 5)))
    wrap_objid = np.zeros(m.nwrap, np.int32)
    for i, w in enumerate(b.wraps):
      if w['type'] == T.WrapType.JOINT:
        wrap_objid[i] = m.names['joint'][w['obj']]
      elif w['type'] == T.WrapType.SITE:
        wrap_objid[i] = m.names['site'][w['obj']]
    m.wrap_type = np.array([int(w['type']) for w in b.wraps], np.int32)
    m.wrap_objid = wrap_objid
    m.wrap_prm = np.array([w['prm'] for w in b.wraps], np.float64)

    # --- actuators
    nu = len(b.actuators)
    m.nu = nu
    m.actuator_trntype = np.array(
        [int(a['trntype']) for a in b.actuators], np.int32)
    m.actuator_dyntype = np.array(
        [int(a['dyntype']) for a in b.actuators], np.int32)
    m.actuator_gaintype = np.array(
        [int(a['gaintype']) for a in b.actuators], np.int32)
    m.actuator_biastype = np.array(
        [int(a['biastype']) for a in b.actuators], np.int32)
    trnid = np.zeros((nu, 2), np.int32)
    for i, a in enumerate(b.actuators):
      kind, name = a['trn']
      trnid[i, 0] = m.names[kind][name]
    m.actuator_trnid = trnid
    actadr = np.full(nu, -1, np.int32)
    actnum = np.zeros(nu, np.int32)
    na = 0
    for i, a in enumerate(b.actuators):
      if a['dyntype'] != T.DynType.NONE:
        actadr[i] = na
        actnum[i] = 1
        na += 1
    m.na = na
    m.actuator_actadr, m.actuator_actnum = actadr, actnum
    m.actuator_ctrllimited = np.array(
        [a['ctrllimited'] for a in b.actuators], bool)
    m.actuator_forcelimited = np.array(
        [a['forcelimited'] for a in b.actuators], bool)
    m.actuator_actlimited = np.array(
        [a['actlimited'] for a in b.actuators], bool)
    for key in ('dynprm', 'gainprm', 'biasprm', 'gear', 'ctrlrange',
                'forcerange', 'actrange'):
      arr = (np.stack([a[key] for a in b.actuators]) if nu
             else np.zeros((0, dict(dynprm=10, gainprm=10, biasprm=10,
                                    gear=6, ctrlrange=2, forcerange=2,
                                    actrange=2)[key])))
      setattr(m, f'actuator_{key}', arr)

    # --- equality
    neq = len(b.equalities)
    m.neq = neq
    m.eq_type = np.array([int(e['type']) for e in b.equalities], np.int32)
    eq_obj1id = np.zeros(neq, np.int32)
    eq_obj2id = np.zeros(neq, np.int32)
    for i, e in enumerate(b.equalities):
      kind = ('body' if e['type'] in (T.EqType.CONNECT, T.EqType.WELD)
              else 'joint' if e['type'] == T.EqType.JOINT else 'tendon')
      eq_obj1id[i] = m.names[kind][e['obj1']]
      eq_obj2id[i] = m.names[kind][e['obj2']] if e['obj2'] else -1
    m.eq_obj1id, m.eq_obj2id = eq_obj1id, eq_obj2id
    m.eq_active0 = np.array([e['active'] for e in b.equalities], bool)
    m.eq_solref = (np.stack([e['solref'] for e in b.equalities])
                   if neq else np.zeros((0, 2)))
    m.eq_solimp = (np.stack([e['solimp'] for e in b.equalities])
                   if neq else np.zeros((0, 5)))
    m.eq_data = (np.stack([e['data'] for e in b.equalities])
                 if neq else np.zeros((0, 11)))

    # --- sensors
    nsensor = len(b.sensors)
    m.nsensor = nsensor
    m.sensor_type = np.array([int(s['type']) for s in b.sensors], np.int32)
    m.sensor_objtype = np.array(
        [int(s['objtype']) for s in b.sensors], np.int32)
    objid = np.zeros(nsensor, np.int32)
    refid = np.full(nsensor, -1, np.int32)
    kind_by_objtype = {
        T.ObjType.BODY: 'body', T.ObjType.XBODY: 'body',
        T.ObjType.JOINT: 'joint', T.ObjType.GEOM: 'geom',
        T.ObjType.SITE: 'site', T.ObjType.CAMERA: 'camera',
        T.ObjType.TENDON: 'tendon', T.ObjType.ACTUATOR: 'actuator'}
    for i, s in enumerate(b.sensors):
      if s['objname'] is not None:
        objid[i] = m.names[kind_by_objtype[T.ObjType(s['objtype'])]][
            s['objname']]
      if s['refname'] is not None:
        refid[i] = m.names[kind_by_objtype[T.ObjType(s['reftype'])]][
            s['refname']]
    m.sensor_objid = objid
    m.sensor_reftype = np.array(
        [int(s['reftype']) for s in b.sensors], np.int32)
    m.sensor_refid = refid
    m.sensor_cutoff = np.array([s['cutoff'] for s in b.sensors], np.float64)
    sensor_adr = np.zeros(nsensor, np.int32)
    nsensordata = 0
    for i, s in enumerate(b.sensors):
      sensor_adr[i] = nsensordata
      nsensordata += s['dim']
    m.sensor_adr = sensor_adr
    m.sensor_dim = np.array([s['dim'] for s in b.sensors], np.int32)
    m.nsensordata = nsensordata

    # --- keyframes
    nkey = len(b.keyframes)
    m.nkey = nkey
    m.key_time = np.array([k['time'] for k in b.keyframes], np.float64)
    m.key_qpos = np.stack(
        [k['qpos'] if k['qpos'] is not None else qpos0
         for k in b.keyframes]) if nkey else np.zeros((0, nq))
    m.key_qvel = np.stack(
        [k['qvel'] if k['qvel'] is not None else np.zeros(nv)
         for k in b.keyframes]) if nkey else np.zeros((0, nv))
    m.key_act = np.stack(
        [k['act'] if k['act'] is not None else np.zeros(na)
         for k in b.keyframes]) if nkey else np.zeros((0, na))
    m.key_ctrl = np.stack(
        [k['ctrl'] if k['ctrl'] is not None else np.zeros(nu)
         for k in b.keyframes]) if nkey else np.zeros((0, nu))

    # --- collision candidate pairs
    self._build_collision_pairs(m)

    # placeholder invweights (refined by engine's set_const pass)
    m.dof_invweight0 = np.ones(nv)
    m.body_invweight0 = np.ones((nbody, 2))
    m.tendon_invweight0 = np.ones(ntendon)
    m.actuator_acc0 = np.ones(nu)
    m.actuator_length0 = np.zeros(nu)
    m.actuator_lengthrange = np.zeros((nu, 2))

    return m

  # -- inertia --------------------------------------------------------------

  def _compute_inertia(self, m: T.Model):
    b = self.b
    nbody = len(b.bodies)
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))

    for i, bd in enumerate(b.bodies):
      if i == 0:
        continue
      use_geoms = (self.inertiafromgeom == 'true'
                   or (self.inertiafromgeom == 'auto' and bd.imass is None))
      if use_geoms and bd.geoms:
        if len(bd.geoms) == 1 and b.geoms[bd.geoms[0]].get('mesh') is None:
          # single primitive geom: keep its frame verbatim (no
          # eigendecomposition), matching the oracle's behavior -- the
          # principal values stay in the geom's own axis order, possibly
          # unsorted.  (Mesh geoms always eigendecompose, below.)
          g = b.geoms[bd.geoms[0]]
          gt = T.GeomType(g['type'])
          vol = _geom_volume(gt, g['size'])
          mass = g['mass'] if g['mass'] is not None else g['density'] * vol
          body_mass[i] = mass
          body_ipos[i] = g['pos']
          body_iquat[i] = g['quat']
          body_inertia[i] = (_geom_inertia(gt, g['size'], mass)
                             if mass > 0 else np.zeros(3))
        else:
          # aggregate geom masses/inertias (full matrices; meshes carry
          # an offset com and a dense inertia in the geom frame)
          masses, coms, inertias = [], [], []
          for gid in bd.geoms:
            g = b.geoms[gid]
            gt = T.GeomType(g['type'])
            rot = _nquat_to_mat(g['quat'])
            if g.get('mesh') is not None:
              asset = self._mesh_assets[g['mesh']]
              vol = asset.volume
              mass = (g['mass'] if g['mass'] is not None
                      else g['density'] * vol)
              unit = asset.inertia / max(asset.volume, _EPS)
              inert = rot @ (mass * unit) @ rot.T
              com_g = g['pos'] + rot @ asset.com
            else:
              vol = _geom_volume(gt, g['size'])
              mass = (g['mass'] if g['mass'] is not None
                      else g['density'] * vol)
              diag = (_geom_inertia(gt, g['size'], mass) if mass > 0
                      else np.zeros(3))
              inert = rot @ np.diag(diag) @ rot.T
              com_g = g['pos']
            masses.append(mass)
            coms.append(com_g)
            inertias.append(inert)
          mass = sum(masses)
          if mass > _EPS:
            com = sum(mm * cc for mm, cc in zip(masses, coms)) / mass
          else:
            com = np.zeros(3)
          total_inert = np.zeros((3, 3))
          for mm, cc, ii in zip(masses, coms, inertias):
            d = cc - com
            total_inert += ii + mm * (np.dot(d, d) * np.eye(3) -
                                      np.outer(d, d))
          body_mass[i] = mass
          body_ipos[i] = com
          diag = np.diag(total_inert)
          offdiag = total_inert - np.diag(diag)
          if np.abs(offdiag).max() <= 1e-12 * max(np.abs(diag).max(), 1e-12):
            # already diagonal: keep axis order verbatim (oracle behavior)
            body_inertia[i] = np.maximum(diag, 0.0)
            body_iquat[i] = np.array([1.0, 0, 0, 0])
          else:
            evals, evecs = np.linalg.eigh(total_inert)
            # descending eigenvalues, right-handed frame
            order = np.argsort(-evals)
            evals, evecs = evals[order], evecs[:, order]
            if np.linalg.det(evecs) < 0:
              evecs[:, 2] *= -1
            body_inertia[i] = np.maximum(evals, 0.0)
            body_iquat[i] = _nmat_to_quat(evecs)
      elif bd.imass is not None:
        body_mass[i] = bd.imass
        body_ipos[i] = bd.ipos if bd.ipos is not None else np.zeros(3)
        if bd.idiag is not None:
          body_inertia[i] = bd.idiag
          body_iquat[i] = bd.iquat
        elif bd.ifull is not None:
          f = bd.ifull
          full = np.array([[f[0], f[3], f[4]],
                           [f[3], f[1], f[5]],
                           [f[4], f[5], f[2]]])
          evals, evecs = np.linalg.eigh(full)
          order = np.argsort(-evals)
          evals, evecs = evals[order], evecs[:, order]
          if np.linalg.det(evecs) < 0:
            evecs[:, 2] *= -1
          body_inertia[i] = np.maximum(evals, 0.0)
          base = bd.iquat if bd.iquat is not None else np.array([1.0, 0, 0, 0])
          body_iquat[i] = _nquat_mul(base, _nmat_to_quat(evecs))
        else:
          body_iquat[i] = (bd.iquat if bd.iquat is not None
                           else np.array([1.0, 0, 0, 0]))

      if self.balanceinertia:
        ii = body_inertia[i]
        if (ii[0] + ii[1] < ii[2] or ii[0] + ii[2] < ii[1]
            or ii[1] + ii[2] < ii[0]):
          body_inertia[i] = np.full(3, ii.mean())

      body_mass[i] = max(body_mass[i], self.boundmass)
      if body_mass[i] > 0:
        body_inertia[i] = np.maximum(body_inertia[i], self.boundinertia)

    if self.settotalmass > 0:
      total = body_mass[1:].sum()
      if total > _EPS:
        scale = self.settotalmass / total
        body_mass *= scale
        body_inertia *= scale

    m.body_mass = body_mass
    m.body_ipos = body_ipos
    m.body_iquat = body_iquat
    m.body_inertia = body_inertia

    subtreemass = body_mass.copy()
    for i in range(nbody - 1, 0, -1):
      subtreemass[m.body_parentid[i]] += subtreemass[i]
    m.body_subtreemass = subtreemass

  # -- collision pair enumeration -------------------------------------------

  def _build_collision_pairs(self, m: T.Model):
    """Static candidate pair list, grouped by (GeomType, GeomType)."""
    ngeom = m.ngeom
    exclude_body_pairs = set()
    for b1, b2 in self.b.excludes:
      i1 = m.names['body'][b1]
      i2 = m.names['body'][b2]
      exclude_body_pairs.add((min(i1, i2), max(i1, i2)))

    explicit = {}
    for p in self.b.pairs:
      g1 = m.names['geom'][p['geom1']]
      g2 = m.names['geom'][p['geom2']]
      explicit[(min(g1, g2), max(g1, g2))] = p

    pairs = []  # (g1, g2, pairinfo or None)
    for g1 in range(ngeom):
      for g2 in range(g1 + 1, ngeom):
        key = (g1, g2)
        if key in explicit:
          continue
        b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
        if b1 == b2:
          continue
        w1, w2 = m.body_weldid[b1], m.body_weldid[b2]
        if w1 == w2:
          continue
        # parent filter (world exempt)
        pw1 = m.body_weldid[m.body_parentid[w1]]
        pw2 = m.body_weldid[m.body_parentid[w2]]
        if (w1 == pw2 and w1 != 0) or (w2 == pw1 and w2 != 0):
          continue
        if (min(b1, b2), max(b1, b2)) in exclude_body_pairs:
          continue
        ct = ((m.geom_contype[g1] & m.geom_conaffinity[g2])
              or (m.geom_contype[g2] & m.geom_conaffinity[g1]))
        if not ct:
          continue
        pairs.append((g1, g2, None))
    for (g1, g2), p in explicit.items():
      pairs.append((g1, g2, p))

    # group by type pair with canonical ordering (type1 <= type2)
    grouped: Dict[Tuple[int, int], List] = {}
    for g1, g2, p in pairs:
      t1, t2 = m.geom_type[g1], m.geom_type[g2]
      if t1 > t2:
        g1, g2 = g2, g1
        t1, t2 = t2, t1
      grouped.setdefault((int(t1), int(t2)), []).append((g1, g2, p))
    m.collision_pairs = grouped


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def compile_path(path: str) -> T.Model:
  return MJCFCompiler(_load_xml(path),
                      base_dir=os.path.dirname(path)).build()


def compile_string(xml: str, base_dir: str = '.') -> T.Model:
  root = ET.fromstring(_sanitize_xml(xml))
  _expand_includes(root, base_dir)
  return MJCFCompiler(root, base_dir=base_dir).build()
