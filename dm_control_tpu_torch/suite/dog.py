"""Dog domain (reference: dm_control/suite/dog.py): stand, walk, trot, run
and fetch.

An 85-dof quadruped (79 without fetch's ball): 162 visual bone meshes
that carry density (their mass properties through the compiler's legacy
inertia), noslip friction refinement (`opt.noslip_iterations` 4), 38
filter actuators, and more dofs than the Newton kernel takes, so its
solve goes through the core with K1b (`solver.solve`).  Rewards and
observations follow the JAX package's `suite/dog.py`."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src.types import JointType, mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 15
_CONTROL_TIMESTEP = .015
_MAX_UPRIGHT_ANGLE = 30
_MIN_UPRIGHT_COSINE = float(np.cos(np.deg2rad(_MAX_UPRIGHT_ANGLE)))
_STAND_HEIGHT_FRACTION = 0.9
_WALK_SPEED = 1
_TROT_SPEED = 3
_RUN_SPEED = 9

TASKS = {'stand': 0.0, 'walk': float(_WALK_SPEED),
         'trot': float(_TROT_SPEED), 'run': float(_RUN_SPEED)}


def arena(floor_size: float, remove_ball: bool):
  """dog.xml's tree with a floor of `floor_size` and, where remove_ball,
  without the ball, its target, the walls and the ball's and head's
  cameras, and without the sensors of what was removed (reference
  dog.py:66-90)."""
  root = common.load_xml_root('dog.xml')

  def remove(tag, name):
    for parent in root.iter():
      for child in list(parent):
        if child.tag == tag and child.attrib.get('name') == name:
          parent.remove(child)
          return

  for el in root.iter('geom'):
    if el.attrib.get('name') == 'floor':
      el.set('size', f'{floor_size} {floor_size} .1')
  if remove_ball:
    remove('body', 'ball')
    remove('geom', 'target')
    remove('camera', 'ball')
    remove('camera', 'head')
    for wall in ['px', 'nx', 'py', 'ny']:
      remove('geom', 'wall_' + wall)
  kept = {el.attrib['name'] for el in root.iter() if 'name' in el.attrib}
  for sec in root.findall('sensor'):
    for el in list(sec):
      ref = (el.attrib.get('site') or el.attrib.get('joint')
             or el.attrib.get('body') or el.attrib.get('objname'))
      if ref and ref not in kept:
        sec.remove(el)
  return root


@functools.lru_cache(maxsize=None)
def _model(floor_size: float, remove_ball: bool, device: str):
  return engine.model_from_root(arena(floor_size, remove_ball), device,
                                base_dir=common.ASSETS_DIR)


def _sensor_cols(m, names) -> np.ndarray:
  """sensordata columns of the named sensors, in the given order."""
  cols = []
  for name in names:
    s = m.name2id('sensor', name)
    adr = int(m.sensor_adr[s])
    cols.extend(range(adr, adr + int(m.sensor_dim[s])))
  return np.asarray(cols, np.int64)


def _world_velocity(m, d, body: int, pos: torch.Tensor) -> torch.Tensor:
  """(B, 3) world linear velocity of point `pos` (B, 3) fixed to `body`
  (the JAX package's sensor._object_velocity, its linear part)."""
  com = d.subtree_com[:, int(m.body_rootid[body])]
  return math.transform_motion(d.cvel[:, body], pos - com)[:, 3:]


class _Parts:
  """Shared dog task machinery over a compiled model."""

  def __init__(self, m):
    self.m = m
    self.torso = m.name2id('body', 'torso')
    self.pelvis = m.name2id('body', 'pelvis')
    self.skull = m.name2id('body', 'skull')
    self.root_q = int(m.jnt_qposadr[m.name2id('joint', 'root')])
    hinge = [j for j in range(m.njnt) if m.jnt_type[j] == JointType.HINGE]
    self.hinge_q = np.asarray(m.jnt_qposadr[hinge], np.int64)
    self.hinge_d = np.asarray(m.jnt_dofadr[hinge], np.int64)
    # standing height at the default pose (reference :269-277), from the
    # kinematics of qpos0 at float64 on the host
    d0 = smooth.kinematics(m, forward.make_data(m, 1, torch.float64, 'cpu'))
    self.stand_height = _STAND_HEIGHT_FRACTION * np.array(
        [float(d0.xpos[0, self.torso, 2]), float(d0.xpos[0, self.pelvis, 2])])
    self.body_weight = float(-m.opt.gravity[2]
                             * m.body_subtreemass[self.torso])
    self.ctrl_lo = np.where(m.actuator_ctrllimited,
                            m.actuator_ctrlrange[:, 0], -1.0)
    self.ctrl_hi = np.where(m.actuator_ctrllimited,
                            m.actuator_ctrlrange[:, 1], 1.0)
    self.linvel_cols = _sensor_cols(m, ['torso_linvel'])
    self.inertial_cols = _sensor_cols(m, ['accelerometer', 'velocimeter',
                                          'gyro'])
    self.force_cols = _sensor_cols(m, ['foot_L', 'foot_R', 'hand_L',
                                       'hand_R'])
    self.touch_cols = _sensor_cols(m, ['palm_L', 'palm_R', 'sole_L',
                                       'sole_R'])

  def cols(self, d, cols):
    return d.sensordata[:, mirror(self.m, d.qpos, cols)]

  def torso_pelvis_height(self, d):
    return torch.stack([d.xpos[:, self.torso, 2], d.xpos[:, self.pelvis, 2]],
                       -1)

  def upright(self, d):
    return torch.stack([d.xmat[:, self.skull, 2, 2],
                        d.xmat[:, self.torso, 2, 2],
                        d.xmat[:, self.pelvis, 2, 2]], -1)

  def torso_com_velocity(self, d):
    return torch.einsum('Bi,Bij->Bj', self.cols(d, self.linvel_cols),
                        d.xmat[:, self.torso])

  def init_episode(self, m_, d, generator):
    """Per lane a random azimuth, horizontal root velocities and actuator
    states (reference dog.py:269-299)."""
    ref = d.qpos
    B = ref.shape[0]
    kw = dict(generator=generator, dtype=ref.dtype, device=ref.device)
    azimuth = 2 * np.pi * torch.rand(B, **kw)
    zero = torch.zeros_like(azimuth)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    rq = self.root_q
    qpos[:, rq + 3:rq + 7] = torch.stack(
        [torch.cos(azimuth / 2), zero, zero, torch.sin(azimuth / 2)], -1)
    v = 2.0 * torch.randn((B, 3), **kw)
    qvel[:, 0], qvel[:, 1], qvel[:, 5] = v[:, 0], v[:, 1], v[:, 2]
    lo, hi = (mirror(m_, ref, x) for x in (self.ctrl_lo, self.ctrl_hi))
    act = lo + (hi - lo) * torch.rand((B, m_.na), **kw)
    return d.replace(qpos=qpos, qvel=qvel, act=act)

  def common_obs(self, m_, d):
    ref = d.qpos
    return {
        'joint_angles': d.qpos[:, mirror(m_, ref, self.hinge_q)],
        'joint_velocites': d.qvel[:, mirror(m_, ref, self.hinge_d)],
        'torso_pelvis_height': self.torso_pelvis_height(d),
        'z_projection': torch.cat([d.xmat[:, self.skull, 2],
                                   d.xmat[:, self.torso, 2],
                                   d.xmat[:, self.pelvis, 2]], -1),
        'torso_com_velocity': self.torso_com_velocity(d),
        'inertial_sensors': self.cols(d, self.inertial_cols),
        'foot_forces': self.cols(d, self.force_cols),
        'touch_sensors': self.cols(d, self.touch_cols),
        'actuator_state': d.act}

  def stand_factors(self, d):
    height = self.torso_pelvis_height(d)
    torso = rewards.tolerance(
        height[:, 0], bounds=(float(self.stand_height[0]), float('inf')),
        margin=float(self.stand_height[0]))
    pelvis = rewards.tolerance(
        height[:, 1], bounds=(float(self.stand_height[1]), float('inf')),
        margin=float(self.stand_height[1]))
    upright = rewards.tolerance(
        self.upright(d), bounds=(_MIN_UPRIGHT_COSINE, float('inf')),
        sigmoid='linear', margin=_MIN_UPRIGHT_COSINE + 1,
        value_at_margin=0)
    touch = rewards.tolerance(
        self.cols(d, self.touch_cols).sum(-1),
        bounds=(self.body_weight, float('inf')), margin=self.body_weight,
        sigmoid='linear', value_at_margin=0.9)
    return [torso, pelvis, upright[:, 0], upright[:, 1], upright[:, 2],
            touch]


@functools.lru_cache(maxsize=None)
def _make_move_task(move_speed: float, device: str) -> control.TaskDef:
  floor_size = max(move_speed, _WALK_SPEED) * _DEFAULT_TIME_LIMIT
  m = _model(float(floor_size), True, device)
  p = _Parts(m)

  def get_reward(m_, d):
    factors = p.stand_factors(d)
    if move_speed > 0:
      forward_ = rewards.tolerance(
          p.torso_com_velocity(d)[:, 0],
          bounds=(move_speed, 2 * move_speed),
          margin=max(1.0, move_speed), value_at_margin=0, sigmoid='linear')
      factors.append((4 * forward_ + 1) / 5)
    out = factors[0]
    for f in factors[1:]:
      out = out * f
    return out

  return control.TaskDef(
      name='dog', model=m, init_episode=p.init_episode,
      get_observation=p.common_obs, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


@functools.lru_cache(maxsize=None)
def _make_fetch_task(device: str) -> control.TaskDef:
  m = _model(float(_WALK_SPEED * _DEFAULT_TIME_LIMIT), False, device)
  p = _Parts(m)
  ball_g = m.name2id('geom', 'ball')
  target_g = m.name2id('geom', 'target')
  head_s = m.name2id('site', 'head')
  upper_bite = m.name2id('site', 'upper_bite')
  lower_bite = m.name2id('site', 'lower_bite')
  ball_q = int(m.jnt_qposadr[m.name2id('joint', 'ball_root')])
  ball_d = int(m.jnt_dofadr[m.name2id('joint', 'ball_root')])
  floor_size = float(m.geom_size[m.name2id('geom', 'floor'), 0])
  bite_radius = float(m.site_size[upper_bite, 0])
  target_radius = float(m.geom_size[target_g, 0])
  gravity = float(-m.opt.gravity[2])

  def init_episode(m_, d, generator):
    """The dog's draws, then the ball thrown from 0.75 of the floor's half
    size at a random azimuth towards the middle (reference
    dog.py:417-433)."""
    d = p.init_episode(m_, d, generator)
    ref = d.qpos
    B = ref.shape[0]
    kw = dict(generator=generator, dtype=ref.dtype, device=ref.device)
    radius = 0.75 * floor_size
    azimuth = 2 * np.pi * torch.rand(B, **kw)
    vert_v = torch.sqrt(2 * gravity * 3.0 * torch.rand(B, **kw))
    horiz_speed = 5.0 * torch.rand(B, **kw)
    noise = 0.05 * torch.randn((B, 2), **kw)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    qpos[:, ball_q:ball_q + 3] = torch.stack(
        [radius * torch.sin(azimuth), radius * torch.cos(azimuth),
         torch.full_like(azimuth, 0.05)], -1)
    direction = torch.stack([-torch.sin(azimuth) + noise[:, 0],
                             -torch.cos(azimuth) + noise[:, 1]], -1)
    qvel[:, ball_d:ball_d + 3] = torch.cat(
        [horiz_speed[:, None] * direction, vert_v[:, None]], -1)
    return d.replace(qpos=qpos, qvel=qvel)

  def get_observation(m_, d):
    obs = p.common_obs(m_, d)
    head_frame = d.site_xmat[:, head_s]
    head_pos = d.site_xpos[:, head_s]
    ball_pos = d.geom_xpos[:, ball_g]
    head_vel = _world_velocity(m_, d, int(m_.site_bodyid[head_s]), head_pos)
    ball_vel = _world_velocity(m_, d, int(m_.geom_bodyid[ball_g]), ball_pos)
    in_head = lambda v: torch.einsum('Bi,Bij->Bj', v, head_frame)
    obs['ball_state'] = torch.cat([in_head(ball_pos - head_pos),
                                   in_head(ball_vel - head_vel)], -1)
    obs['target_position'] = in_head(d.geom_xpos[:, target_g] - head_pos)
    return obs

  def get_reward(m_, d):
    factors = p.stand_factors(d)
    ball = d.geom_xpos[:, ball_g]
    b2m = 0.5 * (torch.linalg.norm(ball - d.site_xpos[:, upper_bite], dim=-1)
                 + torch.linalg.norm(ball - d.site_xpos[:, lower_bite],
                                     dim=-1))
    reach_ball = rewards.tolerance(b2m, bounds=(0, bite_radius),
                                   sigmoid='reciprocal', margin=2)
    reach_ball = (6 * reach_ball + 1) / 7
    b2t = torch.linalg.norm(ball - d.geom_xpos[:, target_g], dim=-1)
    ball_near_target = rewards.tolerance(
        b2t, bounds=(0, target_radius), sigmoid='reciprocal',
        margin=floor_size)
    fetch_ball = (ball_near_target + 1) / 2
    reach_ball = torch.where(b2t < 2 * target_radius, 1.0, reach_ball)
    out = factors[0]
    for f in factors[1:] + [reach_ball, fetch_ball]:
      out = out * f
    return out

  return control.TaskDef(
      name='dog', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name == 'fetch':
    return _make_fetch_task(device)
  if task_name not in TASKS:
    raise ValueError(f'unknown dog task {task_name!r}')
  return _make_move_task(TASKS[task_name], device)
