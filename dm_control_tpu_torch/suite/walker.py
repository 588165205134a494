"""Planar walker domain (reference: dm_control/suite/walker.py)."""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.2
_WALK_SPEED = 1
_RUN_SPEED = 8

TASKS = {'stand': 0.0, 'walk': float(_WALK_SPEED), 'run': float(_RUN_SPEED)}


@functools.lru_cache(maxsize=None)
def _model(device: str):
  return engine.load_model(common.model_path('walker.xml'), device)


@functools.lru_cache(maxsize=None)
def _make_task(move_speed: float, device: str) -> control.TaskDef:
  m = _model(device)
  torso = m.name2id('body', 'torso')
  s = m.name2id('sensor', 'torso_subtreelinvel')
  subtree_adr = int(m.sensor_adr[s])

  def init_episode(m_, d, generator):
    qpos = base.randomize_limited_and_rotational_joints(m_, d.qpos,
                                                        generator)
    return d.replace(qpos=qpos)

  def get_observation(m_, d):
    # planar orientations: xmat [xx, xz] per non-world body
    orient = d.xmat[:, 1:, 0, ::2]
    return {'orientations': orient.reshape(orient.shape[0], -1),
            'height': d.xpos[:, torso, 2],
            'velocity': d.qvel}

  def get_reward(m_, d):
    standing = rewards.tolerance(
        d.xpos[:, torso, 2], bounds=(_STAND_HEIGHT, float('inf')),
        margin=_STAND_HEIGHT / 2)
    upright = (1 + d.xmat[:, torso, 2, 2]) / 2
    stand_reward = (3 * standing + upright) / 4
    if move_speed == 0:
      return stand_reward
    move_reward = rewards.tolerance(
        d.sensordata[:, subtree_adr], bounds=(move_speed, float('inf')),
        margin=move_speed / 2, value_at_margin=0.5, sigmoid='linear')
    return stand_reward * (5 * move_reward + 1) / 6

  return control.TaskDef(
      name='walker', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown walker task {task_name!r}')
  return _make_task(TASKS[task_name], device)
