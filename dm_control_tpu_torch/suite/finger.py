"""Finger domain (reference: dm_control/suite/finger.py), spin task.

turn_easy / turn_hard place a per-episode target site, which needs a
per-lane `site_pos` read by the framepos sensor; they are not ported yet
and raise.
"""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common

_CONTROL_TIMESTEP = .02
_SPIN_VELOCITY = 15.0


@functools.lru_cache(maxsize=None)
def _spin_model(device: str):
  m = engine.load_model(common.model_path('finger.xml'), device)
  # the spin task fixes the hinge's damping at 0.03 (suite/finger.py:146)
  m.dof_damping = m.dof_damping.copy()
  m.dof_damping[int(m.jnt_dofadr[m.name2id('joint', 'hinge')])] = .03
  return m


def _sensor_slice(m, name):
  s = m.name2id('sensor', name)
  adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
  return slice(adr, adr + dim)


def _init_episode(m, d, generator):
  """Random joint angles, collision-free where 20 draws allow."""
  def sample(d_, gen):
    return d_.replace(qpos=base.randomize_limited_and_rotational_joints(
        m, d_.qpos, gen))
  return base.collision_free_init(sample, m, d, generator)


@functools.lru_cache(maxsize=None)
def _make_spin_task(device: str) -> control.TaskDef:
  m = _spin_model(device)
  sl = {name: _sensor_slice(m, name) for name in
        ['touchtop', 'touchbottom', 'proximal', 'distal',
         'proximal_velocity', 'distal_velocity', 'hinge_velocity',
         'tip', 'spinner']}

  def get_observation(m_, d):
    s = d.sensordata
    tip = s[:, sl['tip']][:, ::2] - s[:, sl['spinner']][:, ::2]   # x, z
    return {
        'position': torch.cat([s[:, sl['proximal']], s[:, sl['distal']],
                               tip], -1),
        'velocity': torch.cat([s[:, sl['proximal_velocity']],
                               s[:, sl['distal_velocity']],
                               s[:, sl['hinge_velocity']]], -1),
        'touch': torch.log1p(torch.cat([s[:, sl['touchtop']],
                                        s[:, sl['touchbottom']]], -1)),
    }

  def get_reward(m_, d):
    hinge_vel = d.sensordata[:, sl['hinge_velocity']][:, 0]
    return (hinge_vel <= -_SPIN_VELOCITY).to(d.qpos.dtype)

  return control.TaskDef(
      name='finger_spin', model=m, init_episode=_init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name == 'spin':
    return _make_spin_task(device)
  if task_name in ('turn_easy', 'turn_hard'):
    raise NotImplementedError(
        f'finger {task_name}: the per-episode target site (a per-lane '
        f'site_pos read by the framepos sensor) is not ported yet')
  raise ValueError(f'unknown finger task {task_name!r}')
