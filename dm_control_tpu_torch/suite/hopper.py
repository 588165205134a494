"""Hopper domain (reference: dm_control/suite/hopper.py), stand and hop."""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .02
_STAND_HEIGHT = 0.6
_HOP_SPEED = 2

TASKS = {'stand': False, 'hop': True}


def _sensor_slice(m, name):
  s = m.name2id('sensor', name)
  adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
  return slice(adr, adr + dim)


@functools.lru_cache(maxsize=None)
def _model(device: str):
  return engine.load_model(common.model_path('hopper.xml'), device)


@functools.lru_cache(maxsize=None)
def _make_task(hopping: bool, device: str) -> control.TaskDef:
  m = _model(device)
  torso = m.name2id('body', 'torso')
  foot = m.name2id('body', 'foot')
  sl_subtree = _sensor_slice(m, 'torso_subtreelinvel')
  sl_toe = _sensor_slice(m, 'touch_toe')
  sl_heel = _sensor_slice(m, 'touch_heel')

  def init_episode(m_, d, generator):
    return d.replace(qpos=base.randomize_limited_and_rotational_joints(
        m_, d.qpos, generator))

  def get_observation(m_, d):
    s = d.sensordata
    return {'position': d.qpos[:, 1:], 'velocity': d.qvel,
            'touch': torch.log1p(torch.cat([s[:, sl_toe], s[:, sl_heel]],
                                           -1))}

  def get_reward(m_, d):
    height = d.xipos[:, torso, 2] - d.xipos[:, foot, 2]
    standing = rewards.tolerance(height, (_STAND_HEIGHT, 2))
    if hopping:
      hop = rewards.tolerance(d.sensordata[:, sl_subtree][:, 0],
                              bounds=(_HOP_SPEED, float('inf')),
                              margin=_HOP_SPEED / 2, value_at_margin=0.5,
                              sigmoid='linear')
      return standing * hop
    small_control = rewards.tolerance(d.ctrl, margin=1, value_at_margin=0,
                                      sigmoid='quadratic').mean(-1)
    return standing * (small_control + 4) / 5

  return control.TaskDef(
      name='hopper', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown hopper task {task_name!r}')
  return _make_task(TASKS[task_name], device)
