"""Quadruped domain (reference: dm_control/suite/quadruped.py): walk, run,
escape and fetch.

escape draws a bowl-shaped heightfield per episode: its heights are a
per-lane `model_var['hfield_data']` (B, 201 * 201), as in the JAX
package, and its 20 rangefinders read them.  fetch keeps the arena's four
tilted walls and a free ball with condim-6 contacts."""

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
_TERRAIN_SMOOTHNESS = 0.15
_TERRAIN_BUMP_SCALE = 2.0
_WALLS = ('wall_px', 'wall_py', 'wall_nx', 'wall_ny')
# settle's candidate heights of the torso, 0.01 apart from the floor up,
# tried SETTLE_CHUNK at a time for every lane (fewer where the lanes'
# model_var would take more than SETTLE_BYTES once repeated per height)
SETTLE_HEIGHTS = 200
SETTLE_CHUNK = 20
SETTLE_BYTES = 2 ** 31

TASKS = {'walk': _WALK_SPEED, 'run': _RUN_SPEED}
# the 40 sphere-capsule and 58 capsule-capsule self-collision pairs and
# the 12 plane-capsule leg pairs go through the top-K broadphase (12, 12
# and 8 per lane), as the JAX package's model
BROADPHASE = dict(broadphase_threshold=30, broadphase_cap=12,
                  broadphase_plane_cap=8)


def arena(floor_size=None, terrain=False, rangefinders=False,
          walls_and_ball=False):
  """The MJCF tree of a quadruped arena (reference
  suite/quadruped.py:60-98): a floor of `floor_size` (the XML's own where
  None), with or without the heightfield terrain, the rangefinders, and
  the walls and ball."""
  root = common.load_xml_root('quadruped.xml')

  def remove(tag, name):
    for parent in root.iter():
      for child in list(parent):
        if child.tag == tag and child.attrib.get('name') == name:
          parent.remove(child)
          return

  if floor_size is not None:
    for el in root.iter('geom'):
      if el.attrib.get('name') == 'floor':
        el.set('size', f'{floor_size} {floor_size} .5')
  if not walls_and_ball:
    for wall in _WALLS:
      remove('geom', wall)
    remove('body', 'ball')
    remove('site', 'target')
  if not terrain:
    remove('geom', 'terrain')
  if not rangefinders:
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
def _model(device: str, **arena_kw):
  return engine.model_from_root(arena(**arena_kw), device, **BROADPHASE)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
  """(n_in, n_out) weights of jax.image.resize's 'bicubic' upsampling
  along one axis, in float64: the Keys cubic (a = -0.5) at half-pixel
  sample positions, each column normalised to sum 1, columns whose sample
  lies outside the input zero (jax/_src/image/scale.py)."""
  inv_scale = 1.0 / (n_out / n_in)
  sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
  x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
  w = ((1.5 * x - 2.5) * x) * x + 1.0
  w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
  w = np.where(x >= 2.0, 0.0, w)
  total = w.sum(0, keepdims=True)
  w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
               w / np.where(total != 0, total, 1), 0.0)
  return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None], w, 0.0)


def bicubic_resize(m, x: torch.Tensor, size: int) -> torch.Tensor:
  """(B, n, n) -> (B, size, size) as jax.image.resize(..., 'bicubic')
  resizes each lane (torch's bicubic interpolate is another kernel: a =
  -0.75 and other edges)."""
  w = mirror(m, x, _cubic_weights(x.shape[-1], size))
  return torch.einsum('Bij,ik,jl->Bkl', x, w, w)


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

  def settle(self, m_, d, quat, xy=None):
    """Each lane's torso at xy (B, 2) ((0, 0) where None) with orientation
    quat (B, 4), at the lowest of SETTLE_HEIGHTS heights where the body
    touches nothing (0 where none is free): the reference's
    _find_non_contacting_height (suite/quadruped.py:253-283).  The heights
    go SETTLE_CHUNK at a time through `base.has_contacts`, each chunk one
    batch of B x SETTLE_CHUNK lanes, until every lane has found one."""
    ref = d.qpos
    B, rq = ref.shape[0], self.root_q
    heights = torch.arange(SETTLE_HEIGHTS, dtype=ref.dtype,
                           device=ref.device) * 0.01
    qpos = ref.clone()
    qpos[:, rq:rq + 2] = 0.0 if xy is None else xy
    qpos[:, rq + 3:rq + 7] = quat
    z = ref.new_zeros(B)
    found = torch.zeros(B, dtype=torch.bool, device=ref.device)
    mv_bytes = sum(v.numel() * v.element_size()
                   for v in (d.model_var or {}).values())
    chunk = max(1, min(SETTLE_CHUNK, SETTLE_BYTES // max(mv_bytes, 1)))
    for lo in range(0, SETTLE_HEIGHTS, chunk):
      hs = heights[lo:lo + chunk]
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

  def upright_reward(self, d, deviation_angle=0):
    deviation = float(np.cos(np.deg2rad(deviation_angle)))
    return rewards.tolerance(
        d.xmat[:, self.torso, 2, 2], bounds=(deviation, float('inf')),
        sigmoid='linear', margin=1 + deviation, value_at_margin=0)


@functools.lru_cache(maxsize=None)
def _make_task(desired_speed: float, device: str) -> control.TaskDef:
  # the reference sizes the floor by the distance an episode covers
  m = _model(device, floor_size=_DEFAULT_TIME_LIMIT * desired_speed)
  p = _Parts(m)

  def init_episode(m_, d, generator):
    return p.settle(m_, d, _unit_quat(d.qpos, generator))

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


def _unit_quat(ref, generator):
  quat = torch.randn((ref.shape[0], 4), generator=generator, dtype=ref.dtype,
                     device=ref.device)
  return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def terrain(m, generator, ref) -> torch.Tensor:
  """(B, nrow * ncol) escape terrains, B = ref.shape[0], ref's dtype and
  device: the static sinusoidal bowl (reference :375-378) times random
  smooth bumps, each lane its own (reference :380-384; the JAX package's
  bicubic resize stands in for ndimage.zoom's spline)."""
  res = int(m.hfield_nrow[0])
  row_grid, col_grid = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
  radius = np.clip(np.sqrt(col_grid ** 2 + row_grid ** 2), .04, 1)
  bowl_shape = .5 - np.cos(2 * np.pi * radius) / 2
  bump_res = int(2 * float(m.hfield_size[0, 0]) / _TERRAIN_BUMP_SCALE)
  B = ref.shape[0]
  bumps = _TERRAIN_SMOOTHNESS + (1.0 - _TERRAIN_SMOOTHNESS) * torch.rand(
      (B, bump_res, bump_res), generator=generator, dtype=ref.dtype,
      device=ref.device)
  return (mirror(m, ref, bowl_shape)
          * bicubic_resize(m, bumps, res)).reshape(B, -1)


@functools.lru_cache(maxsize=None)
def _make_escape_task(device: str) -> control.TaskDef:
  m = _model(device, terrain=True, rangefinders=True)
  p = _Parts(m)
  sx = float(m.hfield_size[0, 0])
  rf_cols = _sensor_cols(m, {SensorType.RANGEFINDER})
  workspace = m.name2id('site', 'workspace')

  def init_episode(m_, d, generator):
    ref = d.qpos
    d = d.replace(model_var={**(d.model_var or {}),
                             'hfield_data': terrain(m_, generator, ref)})
    return p.settle(m_, d, _unit_quat(ref, generator))

  def get_observation(m_, d):
    obs = p.common_obs(d)
    obs['origin'] = -torch.einsum('Bij,Bi->Bj', d.xmat[:, p.torso],
                                  d.xpos[:, p.torso])
    rf = d.sensordata[:, mirror(m_, d.qpos, rf_cols)]
    obs['rangefinder'] = torch.where(rf == -1.0, 1.0, torch.tanh(rf))
    return obs

  def get_reward(m_, d):
    origin_dist = torch.linalg.norm(d.site_xpos[:, workspace], dim=-1)
    escape_reward = rewards.tolerance(
        origin_dist, bounds=(sx, float('inf')), margin=sx,
        value_at_margin=0, sigmoid='linear')
    return p.upright_reward(d, deviation_angle=20) * escape_reward

  return control.TaskDef(
      name='quadruped', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


@functools.lru_cache(maxsize=None)
def _make_fetch_task(device: str) -> control.TaskDef:
  # the XML's own 15 m floor (reference quadruped.py:139-141)
  m = _model(device, walls_and_ball=True)
  p = _Parts(m)
  ball = m.name2id('body', 'ball')
  ball_q = int(m.jnt_qposadr[m.name2id('joint', 'ball_root')])
  ball_d = int(m.jnt_dofadr[m.name2id('joint', 'ball_root')])
  target = m.name2id('site', 'target')
  workspace = m.name2id('site', 'workspace')
  floor_size = float(m.geom_size[m.name2id('geom', 'floor'), 0])
  ball_radius = float(m.geom_size[m.name2id('geom', 'ball'), 0])
  workspace_radius = float(m.site_size[workspace, 0])
  target_radius = float(m.site_size[target, 0])
  arena_radius = floor_size * np.sqrt(2)

  def init_episode(m_, d, generator):
    ref = d.qpos
    B = ref.shape[0]
    kw = dict(generator=generator, dtype=ref.dtype, device=ref.device)
    azimuth = 2 * np.pi * torch.rand(B, **kw)
    zero = torch.zeros_like(azimuth)
    quat = torch.stack([torch.cos(azimuth / 2), zero, zero,
                        torch.sin(azimuth / 2)], -1)
    spawn = 0.9 * floor_size
    xy = -spawn + 2 * spawn * torch.rand((B, 2), **kw)
    d = p.settle(m_, d, quat, xy)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    qpos[:, ball_q:ball_q + 2] = -spawn + 2 * spawn * torch.rand((B, 2), **kw)
    qpos[:, ball_q + 2] = 2.0
    qvel[:, ball_d:ball_d + 2] = 5.0 * torch.randn((B, 2), **kw)
    return d.replace(qpos=qpos, qvel=qvel)

  def get_observation(m_, d):
    obs = p.common_obs(d)
    frame = d.xmat[:, p.torso]
    rel_pos = d.xpos[:, ball] - d.xpos[:, p.torso]
    rel_vel = d.qvel[:, ball_d:ball_d + 3] - d.qvel[:, :3]
    rot_vel = d.qvel[:, ball_d + 3:ball_d + 6]
    state = torch.stack([rel_pos, rel_vel, rot_vel], 1)
    obs['ball_state'] = (state @ frame).reshape(state.shape[0], -1)
    obs['target_position'] = torch.einsum(
        'Bij,Bi->Bj', frame, d.site_xpos[:, target] - d.xpos[:, p.torso])
    return obs

  def get_reward(m_, d):
    self_to_ball = torch.linalg.norm(
        (d.site_xpos[:, workspace] - d.xpos[:, ball])[:, :2], dim=-1)
    reach_reward = rewards.tolerance(
        self_to_ball, bounds=(0, workspace_radius + ball_radius),
        sigmoid='linear', margin=arena_radius, value_at_margin=0)
    ball_to_target = torch.linalg.norm(
        (d.site_xpos[:, target] - d.xpos[:, ball])[:, :2], dim=-1)
    fetch_reward = rewards.tolerance(
        ball_to_target, bounds=(0, target_radius), sigmoid='linear',
        margin=arena_radius, value_at_margin=0)
    return p.upright_reward(d) * (reach_reward * (0.5 + 0.5 * fetch_reward))

  return control.TaskDef(
      name='quadruped', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name == 'escape':
    return _make_escape_task(device)
  if task_name == 'fetch':
    return _make_fetch_task(device)
  if task_name not in TASKS:
    raise ValueError(f'unknown quadruped task {task_name!r}')
  return _make_task(float(TASKS[task_name]), device)
