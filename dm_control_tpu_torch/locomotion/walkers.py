"""Walker entities with egocentric observables
(reference: locomotion/walkers/base.py:83-131, ant.py,
cmu_humanoid.py).

The port of `dm_control_tpu/locomotion/walkers.py`.  The walkers' MJCF is
the JAX package's (the ant generated by the same code, the rodent, the
jumping ball and the CMU humanoid from the port's copies of the suite
assets); their observables read batched Data, (B, ...) per observable,
with device index tensors from the Model's mirror.

The ant walker's model is generated procedurally (own design, not the
reference asset): a spherical torso with four 2-segment capsule legs,
torque actuators, and the standard proprioceptive sensor suite.  The
CMU humanoid wraps the vendored 56-DoF suite asset."""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src import math as _math
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.composer.entity import Entity
from dm_control_tpu_torch.composer.observation import ObservableSpec
from dm_control_tpu_torch.mjcf.compiler import _load_xml
from dm_control_tpu_torch.suite import common


def transform_vec_to_egocentric_frame(root_quat: torch.Tensor,
                                      vec: torch.Tensor) -> torch.Tensor:
  """World vector(s) -> the walker's root frame (reference
  walkers/base.py:83-131 transform_vec_to_egocentric_frame): root_quat
  (B, 4), vec (B, 3) or (B, k, 3)."""
  q = torch.cat([root_quat[..., :1], -root_quat[..., 1:]], dim=-1)
  if vec.dim() > root_quat.dim():
    q = q[..., None, :]
  return _math.quat_rotate(q, vec)


def _index(m, d, ids):
  """Device index tensor of `ids` for the batched Data d."""
  return mirror(m, d.qpos, np.asarray(ids, np.int64))


def _add_root_frame(root: ET.Element, joints: str = 'free'):
  """Wrap the fragment's root bodies in an attachment-frame body holding
  the root joints (the job of the reference's Walker.create_root_joints
  on the PyMJCF attachment frame, legacy_base.py / jumping_ball.py:89).
  joints='free' adds a freejoint named 'root'; 'slides' adds the
  jumping-ball planar root_x/y/z slide triplet."""
  wb = root.find('worldbody')
  if wb is None:
    raise ValueError('fragment has no worldbody')
  frame = ET.Element('body', dict(name='rootframe'))
  if joints == 'free':
    frame.append(ET.Element('freejoint', dict(name='root')))
  else:
    for nm, ax in (('root_x', '1 0 0'), ('root_y', '0 1 0'),
                   ('root_z', '0 0 1')):
      frame.append(ET.Element('joint', dict(
          name=nm, type='slide', axis=ax, damping='0', armature='0',
          limited='false', stiffness='0')))
  for el in list(wb):
    if el.tag == 'body':
      wb.remove(el)
      frame.append(el)
  wb.append(frame)


def _ant_xml(torso_radius=0.25, leg_length=0.35, foot_length=0.45):
  root = ET.Element('mujoco')
  default = ET.SubElement(root, 'default')
  ET.SubElement(default, 'joint', dict(
      damping='1', armature='0.1', limited='true'))
  ET.SubElement(default, 'geom', dict(
      friction='1 0.5 0.5', density='400'))
  ET.SubElement(default, 'motor', dict(
      ctrllimited='true', ctrlrange='-1 1', gear='60'))
  wb = ET.SubElement(root, 'worldbody')
  torso = ET.SubElement(wb, 'body', dict(name='torso', pos='0 0 0.55'))
  ET.SubElement(torso, 'freejoint', dict(name='root'))
  ET.SubElement(torso, 'geom', dict(
      name='torso_geom', type='sphere', size=str(torso_radius)))
  ET.SubElement(torso, 'site', dict(name='imu', pos='0 0 0'))
  act = ET.SubElement(root, 'actuator')
  sens = ET.SubElement(root, 'sensor')
  ET.SubElement(sens, 'velocimeter', dict(name='torso_vel', site='imu'))
  ET.SubElement(sens, 'gyro', dict(name='torso_gyro', site='imu'))
  ET.SubElement(sens, 'accelerometer', dict(name='torso_acc', site='imu'))
  for i, (dx, dy) in enumerate([(1, 1), (-1, 1), (-1, -1), (1, -1)]):
    nx, ny = dx / np.sqrt(2), dy / np.sqrt(2)
    hip = ET.SubElement(torso, 'body', dict(
        name=f'hip_{i}',
        pos=f'{nx * torso_radius} {ny * torso_radius} 0'))
    ET.SubElement(hip, 'joint', dict(
        name=f'hip_{i}', type='hinge', axis='0 0 1', range='-40 40'))
    ET.SubElement(hip, 'geom', dict(
        name=f'upper_leg_{i}', type='capsule', size='0.06',
        fromto=f'0 0 0 {nx * leg_length} {ny * leg_length} 0'))
    knee = ET.SubElement(hip, 'body', dict(
        name=f'knee_{i}',
        pos=f'{nx * leg_length} {ny * leg_length} 0'))
    ET.SubElement(knee, 'joint', dict(
        name=f'knee_{i}', type='hinge',
        axis=f'{-ny} {nx} 0', range='30 100'))
    ET.SubElement(knee, 'geom', dict(
        name=f'lower_leg_{i}', type='capsule', size='0.05',
        fromto=f'0 0 0 {nx * foot_length} {ny * foot_length} '
               f'{-foot_length}'))
    ET.SubElement(act, 'motor', dict(name=f'hip_{i}', joint=f'hip_{i}'))
    ET.SubElement(act, 'motor', dict(name=f'knee_{i}', joint=f'knee_{i}'))
  return root


def _sensor_slice(m, name):
  s = m.names['sensor'][name]
  return int(m.sensor_adr[s]), int(m.sensor_dim[s])


def _joints(m, pref, types):
  """(qpos addresses, dof addresses) of the joints under `pref` whose
  type is in `types`, in joint order."""
  js = [j for j in range(m.njnt)
        if (m.id2name('joint', j) or '').startswith(pref)
        and int(m.jnt_type[j]) in types]
  return ([int(m.jnt_qposadr[j]) for j in js],
          [int(m.jnt_dofadr[j]) for j in js])


def _sensor_obs(m, out, pref, pairs):
  """out[oname] = the sensordata slice of sensor pref + sname."""
  for sname, oname in pairs:
    adr, dim = _sensor_slice(m, f'{pref}{sname}')
    out[oname] = ObservableSpec(
        fn=lambda _m, d, a=adr, n=dim: d.sensordata[:, a:a + n])


def _ego_rows(m, bodies, torso):
  """Rows of (rel @ xmat[torso]) of each body's offset from the torso, in
  the reference rodent's convention (rodent.py:288-291), flattened."""
  def fn(_m, d):
    b, t = _index(m, d, bodies), int(torso)
    rel = d.xpos[:, b] - d.xpos[:, t, None]
    return (rel @ d.xmat[:, t]).flatten(1)
  return fn


class Ant(Entity):
  """Quadruped walker with the reference's egocentric observable groups
  (proprioception: joints_pos/joints_vel; kinematics: world_zaxis,
  body_height; dynamics: sensors_velocimeter/gyro/accelerometer —
  reference walkers/base.py:159-203)."""

  def __init__(self, name='walker'):
    super().__init__(mjcf_root=_ant_xml(), name=name)

  def observables_for(self, m, prefix):
    """name -> ObservableSpec, resolved against the compiled model."""
    torso = m.name2id('body', f'{prefix}/torso')
    hinge_q, hinge_d = _joints(m, prefix + '/', (3,))
    out = {}
    out['joints_pos'] = ObservableSpec(
        fn=lambda _m, d: d.qpos[:, _index(m, d, hinge_q)])
    out['joints_vel'] = ObservableSpec(
        fn=lambda _m, d: d.qvel[:, _index(m, d, hinge_d)])
    out['world_zaxis'] = ObservableSpec(
        fn=lambda _m, d: d.xmat[:, torso, 2])
    out['body_height'] = ObservableSpec(
        fn=lambda _m, d: d.xpos[:, torso, 2])
    _sensor_obs(m, out, f'{prefix}/', [(s, f'sensors_{s}') for s in (
        'torso_vel', 'torso_gyro', 'torso_acc')])
    return out, torso


class Rat(Entity):
  """Position-controlled rodent walker (reference
  locomotion/walkers/rodent.py:65-330): 67-DoF rat skeleton with
  fixed-tendon lumbar/cervical/caudal groups, filter actuators, and the
  reference's observable set — proprioception (joints, tendons,
  actuator activation), head height, appendage/end-effector positions
  in the egocentric frame, and head-mounted inertial + touch sensors.
  The model XML is vendored (skin stripped: render-only decoration; the
  reference's sensors_torque observable is empty because rodent.xml
  declares no torque sensors)."""

  _END_EFFECTORS = ('lower_arm_R', 'lower_arm_L', 'foot_R', 'foot_L')
  # bodies the TwoTouch task uses as touch triggers (ref reach.py:73-74)
  hand_bodies = ('hand_L', 'hand_R')
  TORQUE_THRESHOLD = 60.0  # reference rodent.py:62

  def __init__(self, name='walker', freejoint=True):
    root = _load_xml(common.model_path('rodent.xml'))
    if freejoint:
      _add_root_frame(root, 'free')
    super().__init__(mjcf_root=root, name=name)

  def observables_for(self, m, prefix):
    pref = f'{prefix}/' if prefix else ''
    torso = m.name2id('body', f'{pref}torso')
    head = m.name2id('body', f'{pref}skull')
    hinges_q, hinges_d = _joints(m, pref, (3,))
    tendons = [t for t in range(m.ntendon)
               if (m.id2name('tendon', t) or '').startswith(pref)]
    ee_bodies = [m.name2id('body', f'{pref}{b}')
                 for b in self._END_EFFECTORS]
    app_bodies = ee_bodies + [head]

    out = {}
    out['joints_pos'] = ObservableSpec(
        fn=lambda _m, d: d.qpos[:, _index(m, d, hinges_q)])
    out['joints_vel'] = ObservableSpec(
        fn=lambda _m, d: d.qvel[:, _index(m, d, hinges_d)])
    out['tendons_pos'] = ObservableSpec(
        fn=lambda _m, d: d.ten_length[:, _index(m, d, tendons)])
    out['tendons_vel'] = ObservableSpec(
        fn=lambda _m, d: d.ten_velocity[:, _index(m, d, tendons)])
    out['actuator_activation'] = ObservableSpec(fn=lambda _m, d: d.act)
    out['head_height'] = ObservableSpec(
        fn=lambda _m, d: d.xpos[:, head, 2, None])
    out['body_height'] = ObservableSpec(
        fn=lambda _m, d: d.xpos[:, torso, 2, None])
    out['world_zaxis'] = ObservableSpec(
        fn=lambda _m, d: d.xmat[:, torso, 2])
    out['end_effectors_pos'] = ObservableSpec(
        fn=_ego_rows(m, ee_bodies, torso))
    out['appendages_pos'] = ObservableSpec(fn=_ego_rows(m, app_bodies, torso))
    _sensor_obs(m, out, pref, (('velocimeter', 'sensors_velocimeter'),
                               ('gyro', 'sensors_gyro'),
                               ('accelerometer', 'sensors_accelerometer')))
    touch = [_sensor_slice(m, f'{pref}{s}')[0]
             for s in ('palm_L', 'palm_R', 'sole_L', 'sole_R')]
    out['sensors_touch'] = ObservableSpec(
        fn=lambda _m, d: torch.log1p(d.sensordata[:, _index(m, d, touch)]))
    return out, torso


class JumpingBallWithHead(Entity):
  """Rollable/jumpable ball walker (reference
  locomotion/walkers/jumping_ball.py:35-162): roll/steer/kick actuators,
  torso-mounted inertial sensors.  marker_rgba distinguishes players in
  multi-agent settings (texture decoration stripped in vendoring)."""

  def __init__(self, name='walker', marker_rgba=None, freejoint=True):
    root = _load_xml(common.model_path('jumping_ball_with_head.xml'))
    if freejoint:
      # planar slide triplet, as the reference's create_root_joints
      _add_root_frame(root, 'slides')
    if marker_rgba is not None:
      rgba = ' '.join(str(v) for v in marker_rgba)
      for geom in root.iter('geom'):
        if geom.get('name') == 'head':  # reference marker_geoms
          geom.set('rgba', rgba)
    super().__init__(mjcf_root=root, name=name)

  def observables_for(self, m, prefix):
    pref = f'{prefix}/' if prefix else ''
    # the head body is the root (carries the inertial sensor site)
    torso = m.name2id('body', f'{pref}head_body')
    hq, hd = _joints(m, pref, (2, 3))  # slide + hinge
    out = {}
    out['joints_pos'] = ObservableSpec(
        fn=lambda _m, d: d.qpos[:, _index(m, d, hq)])
    out['joints_vel'] = ObservableSpec(
        fn=lambda _m, d: d.qvel[:, _index(m, d, hd)])
    out['body_height'] = ObservableSpec(
        fn=lambda _m, d: d.xpos[:, torso, 2, None])
    out['world_zaxis'] = ObservableSpec(
        fn=lambda _m, d: d.xmat[:, torso, 2])
    _sensor_obs(m, out, pref, (('sensor_torso_vel', 'sensors_velocimeter'),
                               ('sensor_torso_gyro', 'sensors_gyro'),
                               ('sensor_torso_accel',
                                'sensors_accelerometer')))
    return out, torso


class CMUHumanoid(Entity):
  """The 56-DoF CMU humanoid as a walker entity (reference
  cmu_humanoid.py:52-360): proprioception (joint angles/velocities),
  kinematic sensors (root velocimeter/gyro/accelerometer), foot touch,
  end-effector and appendage positions in the egocentric frame."""

  _END_EFFECTORS = ('rradius', 'lradius', 'rfoot', 'lfoot')
  # touch triggers for TwoTouch (ref reach.py:70-71 resolves lhand/rhand)
  hand_bodies = ('lhand', 'rhand')

  def __init__(self, name='walker'):
    root = _load_xml(common.model_path('humanoid_CMU.xml'))
    super().__init__(mjcf_root=root, name=name)

  def observables_for(self, m, prefix):
    """name -> ObservableSpec for a compiled model; returns
    (observables, root_body_id)."""
    pref = f'{prefix}/' if prefix else ''
    root_b = m.name2id('body', f'{pref}root' if f'{pref}root' in
                       m.names['body'] else f'{pref}thorax')
    # the free root is the first joint of the fragment
    free_j = next(j for j in range(m.njnt)
                  if (m.id2name('joint', j) or '').startswith(pref)
                  and int(m.jnt_type[j]) == 0)
    root_q = int(m.jnt_qposadr[free_j])
    hinges_q, hinges_d = _joints(m, pref, (3,))
    ee_bodies = [m.name2id('body', f'{pref}{b}')
                 for b in self._END_EFFECTORS]
    head = m.name2id('body', f'{pref}head')
    app_bodies = ee_bodies + [head]

    def ego_positions(bodies):
      def fn(_m, d):
        rel = (d.xpos[:, _index(m, d, bodies)]
               - d.qpos[:, None, root_q:root_q + 3])
        return transform_vec_to_egocentric_frame(
            d.qpos[:, root_q + 3:root_q + 7], rel).flatten(1)
      return fn

    out = {}
    out['joints_pos'] = ObservableSpec(
        fn=lambda _m, d: d.qpos[:, _index(m, d, hinges_q)])
    out['joints_vel'] = ObservableSpec(
        fn=lambda _m, d: d.qvel[:, _index(m, d, hinges_d)])
    out['body_height'] = ObservableSpec(
        fn=lambda _m, d: d.qpos[:, root_q + 2, None])
    out['world_zaxis'] = ObservableSpec(
        fn=lambda _m, d: d.xmat[:, root_b, 2])
    out['end_effectors_pos'] = ObservableSpec(fn=ego_positions(ee_bodies))
    out['appendages_pos'] = ObservableSpec(fn=ego_positions(app_bodies))
    _sensor_obs(m, out, pref, (('sensor_root_veloc', 'sensors_velocimeter'),
                               ('sensor_root_gyro', 'sensors_gyro'),
                               ('sensor_root_accel',
                                'sensors_accelerometer')))
    touch = [_sensor_slice(m, f'{pref}sensor_touch_{s}')[0]
             for s in ('ltoes', 'rtoes', 'lfoot', 'rfoot')]
    out['sensors_touch'] = ObservableSpec(
        fn=lambda _m, d: torch.log1p(d.sensordata[:, _index(m, d, touch)]))
    return out, root_b
