"""Finger domain (reference: dm_control/suite/finger.py): spin, turn_easy
and turn_hard.

The turn tasks place a target site at a random angle around the hinge at
each episode: a per-lane `site_pos` in `Data.model_var`, read by the
`framepos` sensor.  Every finger task is an expensive init (collision-free
rejection sampling), so BatchedEnv's auto-reset takes its states, the
target's `site_pos` included, from the reset pool.
"""

from __future__ import annotations

import functools
import math

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common

_CONTROL_TIMESTEP = .02
_EASY_TARGET_SIZE = 0.07
_HARD_TARGET_SIZE = 0.03
_SPIN_VELOCITY = 15.0

TURN_TASKS = {'turn_easy': _EASY_TARGET_SIZE, 'turn_hard': _HARD_TARGET_SIZE}


@functools.lru_cache(maxsize=None)
def _model(device: str, spin: bool, target_size: float = 0.0):
  m = engine.load_model(common.model_path('finger.xml'), device)
  if spin:
    # the spin task fixes the hinge's damping at 0.03 (suite/finger.py:146)
    m.dof_damping = m.dof_damping.copy()
    m.dof_damping[int(m.jnt_dofadr[m.name2id('joint', 'hinge')])] = .03
  else:
    # the turn tasks size the target site (suite/finger.py:172)
    m.site_size = m.site_size.copy()
    m.site_size[m.name2id('site', 'target'), 0] = target_size
  return m


def _sensor_slice(m, name):
  s = m.name2id('sensor', name)
  adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
  return slice(adr, adr + dim)


def _init_joints(m, d, generator):
  """Random joint angles, collision-free where 20 draws allow."""
  def sample(d_, gen):
    return d_.replace(qpos=base.randomize_limited_and_rotational_joints(
        m, d_.qpos, gen))
  return base.collision_free_init(sample, m, d, generator)


def _common_fns(m):
  sl = {name: _sensor_slice(m, name) for name in
        ['touchtop', 'touchbottom', 'proximal', 'distal',
         'proximal_velocity', 'distal_velocity', 'hinge_velocity',
         'tip', 'spinner', 'target']}

  def xz(d, name):
    """A frame sensor's x and z, relative to the spinner's."""
    s = d.sensordata
    return s[:, sl[name]][:, ::2] - s[:, sl['spinner']][:, ::2]

  def observation(d):
    s = d.sensordata
    return {
        'position': torch.cat([s[:, sl['proximal']], s[:, sl['distal']],
                               xz(d, 'tip')], -1),
        'velocity': torch.cat([s[:, sl['proximal_velocity']],
                               s[:, sl['distal_velocity']],
                               s[:, sl['hinge_velocity']]], -1),
        'touch': torch.log1p(torch.cat([s[:, sl['touchtop']],
                                        s[:, sl['touchbottom']]], -1)),
    }

  return sl, xz, observation


@functools.lru_cache(maxsize=None)
def _make_spin_task(device: str) -> control.TaskDef:
  m = _model(device, spin=True)
  sl, _, observation = _common_fns(m)

  def get_reward(m_, d):
    hinge_vel = d.sensordata[:, sl['hinge_velocity']][:, 0]
    return (hinge_vel <= -_SPIN_VELOCITY).to(d.qpos.dtype)

  return control.TaskDef(
      name='finger_spin', model=m, init_episode=_init_joints,
      get_observation=lambda m_, d: observation(d), get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


@functools.lru_cache(maxsize=None)
def _make_turn_task(target_size: float, device: str) -> control.TaskDef:
  m = _model(device, spin=False, target_size=target_size)
  _, xz, observation = _common_fns(m)
  hinge = m.name2id('joint', 'hinge')
  s_target = m.name2id('site', 'target')
  radius = float(m.geom_size[m.name2id('geom', 'cap1')].sum())
  target_radius = float(m.site_size[s_target, 0])

  def init_episode(m_, d, generator):
    d = _init_joints(m_, d, generator)
    # the target at a random angle around the hinge (suite/finger.py:
    # 180-186); the hinge's anchor follows from the joint angles just
    # drawn, so kinematics places it
    ref = d.qpos
    anchor = smooth.kinematics(m_, d).xanchor[:, hinge]
    angle = -math.pi + 2 * math.pi * torch.rand(
        ref.shape[0], generator=generator, dtype=ref.dtype,
        device=ref.device)
    site_pos = mirror(m_, ref, m_.site_pos).expand(
        ref.shape[0], m_.nsite, 3).clone()
    site_pos[:, s_target, 0] = anchor[:, 0] + radius * torch.sin(angle)
    site_pos[:, s_target, 2] = anchor[:, 2] + radius * torch.cos(angle)
    return d.replace(model_var=dict(d.model_var or {}, site_pos=site_pos))

  def dist_to_target(d):
    return (xz(d, 'target') - xz(d, 'tip')).norm(dim=-1) - target_radius

  def get_observation(m_, d):
    obs = observation(d)
    obs['target_position'] = xz(d, 'target')
    obs['dist_to_target'] = dist_to_target(d)
    return obs

  def get_reward(m_, d):
    return (dist_to_target(d) <= 0).to(d.qpos.dtype)

  return control.TaskDef(
      name='finger_turn', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name == 'spin':
    return _make_spin_task(device)
  if task_name in TURN_TASKS:
    return _make_turn_task(TURN_TASKS[task_name], device)
  raise ValueError(f'unknown finger task {task_name!r}')
