"""Quadruped domain (reference: dm_control/suite/quadruped.py): walk and
run.  escape (a heightfield terrain) and fetch (a condim-6 ball and the
arena's walls) are not ported yet and raise."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src.types import JointType, SensorType, mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
_RUN_SPEED = 5
_WALK_SPEED = 0.5
_WALLS = ('wall_px', 'wall_py', 'wall_nx', 'wall_ny')
# settle's candidate heights of the torso, 0.01 apart from the floor up,
# tried SETTLE_CHUNK at a time for every lane
SETTLE_HEIGHTS = 200
SETTLE_CHUNK = 20

TASKS = {'walk': _WALK_SPEED, 'run': _RUN_SPEED}
# the 40 sphere-capsule and 58 capsule-capsule self-collision pairs and
# the 12 plane-capsule leg pairs go through the top-K broadphase (12, 12
# and 8 per lane), as the JAX package's model
BROADPHASE = dict(broadphase_threshold=30, broadphase_cap=12,
                  broadphase_plane_cap=8)


def arena(floor_size: float):
  """The MJCF tree of walk's and run's arena (reference
  suite/quadruped.py:60-98): a floor of `floor_size`, no terrain, walls,
  ball or rangefinders."""
  root = common.load_xml_root('quadruped.xml')

  def remove(tag, name):
    for parent in root.iter():
      for child in list(parent):
        if child.tag == tag and child.attrib.get('name') == name:
          parent.remove(child)
          return

  for el in root.iter('geom'):
    if el.attrib.get('name') == 'floor':
      el.set('size', f'{floor_size} {floor_size} .5')
  for wall in _WALLS:
    remove('geom', wall)
  remove('body', 'ball')
  remove('site', 'target')
  remove('geom', 'terrain')
  for sec in root.findall('sensor'):
    for el in list(sec):
      if el.tag == 'rangefinder':
        sec.remove(el)
  # drop the sensors of removed elements
  kept = {el.attrib['name'] for el in root.iter() if 'name' in el.attrib}
  for sec in root.findall('sensor'):
    for el in list(sec):
      ref = (el.attrib.get('site') or el.attrib.get('joint')
             or el.attrib.get('body') or el.attrib.get('objname'))
      if ref and ref not in kept:
        sec.remove(el)
  return root


@functools.lru_cache(maxsize=None)
def _model(floor_size: float, device: str):
  return engine.model_from_root(arena(floor_size), device, **BROADPHASE)


def _sensor_cols(m, stypes) -> np.ndarray:
  """sensordata columns of the sensors of types `stypes`, in model
  order."""
  cols = [np.arange(int(m.sensor_adr[s]), int(m.sensor_adr[s])
                    + int(m.sensor_dim[s]))
          for s in range(m.nsensor)
          if SensorType(int(m.sensor_type[s])) in stypes]
  return np.concatenate(cols) if cols else np.zeros(0, np.int64)


class _Parts:
  """Shared quadruped task machinery over a compiled model."""

  def __init__(self, m):
    self.m = m
    self.torso = m.name2id('body', 'torso')
    self.root_q = int(m.jnt_qposadr[m.name2id('joint', 'root')])
    hinges = [j for j in range(m.njnt) if m.jnt_type[j] == JointType.HINGE]
    self.hinge_q = m.jnt_qposadr[hinges]
    self.hinge_d = m.jnt_dofadr[hinges]
    self.vel_cols = _sensor_cols(m, {SensorType.VELOCIMETER})
    self.imu_cols = _sensor_cols(m, {SensorType.GYRO,
                                     SensorType.ACCELEROMETER})
    self.ft_cols = _sensor_cols(m, {SensorType.FORCE, SensorType.TORQUE})

  def settle(self, m_, d, quat):
    """Each lane's torso at (0, 0) with orientation quat (B, 4), at the
    lowest of SETTLE_HEIGHTS heights where the body touches nothing (0
    where none is free): the reference's _find_non_contacting_height
    (suite/quadruped.py:253-283).  The heights go SETTLE_CHUNK at a time
    through `base.has_contacts`, each chunk one batch of B x SETTLE_CHUNK
    lanes, until every lane has found one."""
    ref = d.qpos
    B, rq = ref.shape[0], self.root_q
    heights = torch.arange(SETTLE_HEIGHTS, dtype=ref.dtype,
                           device=ref.device) * 0.01
    qpos = ref.clone()
    qpos[:, rq:rq + 2] = 0.0
    qpos[:, rq + 3:rq + 7] = quat
    z = ref.new_zeros(B)
    found = torch.zeros(B, dtype=torch.bool, device=ref.device)
    for lo in range(0, SETTLE_HEIGHTS, SETTLE_CHUNK):
      hs = heights[lo:lo + SETTLE_CHUNK]
      n = hs.shape[0]
      q = qpos.repeat(n, 1)
      q[:, rq + 2] = hs.repeat_interleave(B)
      trial = forward.make_data(m_, n * B, ref.dtype, ref.device).replace(
          qpos=q, model_var={k: v.repeat((n,) + (1,) * (v.dim() - 1))
                             for k, v in (d.model_var or {}).items()})
      free = ~base.has_contacts(m_, trial).reshape(n, B)
      first = torch.argmax(free.to(torch.int32), dim=0)
      new = free.any(0) & ~found
      z = torch.where(new, hs[first], z)
      found = found | new
      if bool(found.all()):
        break
    qpos[:, rq + 2] = z
    return d.replace(qpos=qpos)

  def common_obs(self, d):
    ref = d.qpos
    col = lambda cols: d.sensordata[:, mirror(self.m, ref, cols)]
    return {'egocentric_state': torch.cat(
                [d.qpos[:, mirror(self.m, ref, self.hinge_q)],
                 d.qvel[:, mirror(self.m, ref, self.hinge_d)], d.act], -1),
            'torso_velocity': col(self.vel_cols),
            'torso_upright': d.xmat[:, self.torso, 2, 2],
            'imu': col(self.imu_cols),
            'force_torque': torch.asinh(col(self.ft_cols))}

  def upright_reward(self, d):
    return rewards.tolerance(
        d.xmat[:, self.torso, 2, 2], bounds=(1.0, float('inf')),
        sigmoid='linear', margin=2.0, value_at_margin=0)


@functools.lru_cache(maxsize=None)
def _make_task(desired_speed: float, device: str) -> control.TaskDef:
  # the reference sizes the floor by the distance an episode covers
  m = _model(_DEFAULT_TIME_LIMIT * desired_speed, device)
  p = _Parts(m)

  def init_episode(m_, d, generator):
    ref = d.qpos
    quat = torch.randn((ref.shape[0], 4), generator=generator,
                       dtype=ref.dtype, device=ref.device)
    return p.settle(m_, d, quat / torch.linalg.norm(quat, dim=-1,
                                                    keepdim=True))

  def get_reward(m_, d):
    move = rewards.tolerance(
        d.sensordata[:, int(p.vel_cols[0])],
        bounds=(desired_speed, float('inf')), margin=desired_speed,
        value_at_margin=0.5, sigmoid='linear')
    return p.upright_reward(d) * move

  return control.TaskDef(
      name='quadruped', model=m, init_episode=init_episode,
      get_observation=lambda m_, d: p.common_obs(d), get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name == 'escape':
    raise NotImplementedError(
        'quadruped escape is not ported yet: it waits on the heightfield '
        'collider and a per-lane hfield_data')
  if task_name == 'fetch':
    raise NotImplementedError(
        'quadruped fetch is not ported yet: it waits on the condim-6 '
        'ball\'s contacts and the arena\'s walls')
  if task_name not in TASKS:
    raise ValueError(f'unknown quadruped task {task_name!r}')
  return _make_task(float(TASKS[task_name]), device)
