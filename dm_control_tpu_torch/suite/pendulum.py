"""Pendulum domain (reference: dm_control/suite/pendulum.py), swingup."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_ANGLE_BOUND = 8
_COSINE_BOUND = float(np.cos(np.deg2rad(_ANGLE_BOUND)))


@functools.lru_cache(maxsize=None)
def _make_task(device: str) -> control.TaskDef:
  m = engine.load_model(common.model_path('pendulum.xml'), device)
  pole = m.name2id('body', 'pole')
  hinge_q = int(m.jnt_qposadr[m.name2id('joint', 'hinge')])
  hinge_v = int(m.jnt_dofadr[m.name2id('joint', 'hinge')])

  def init_episode(m_, d, generator):
    # pole at a uniform random angle (suite/pendulum.py:88-94)
    qpos = d.qpos.clone()
    qpos[:, hinge_q] = -math.pi + 2 * math.pi * torch.rand(
        qpos.shape[0], generator=generator, dtype=qpos.dtype,
        device=qpos.device)
    return d.replace(qpos=qpos)

  def get_observation(m_, d):
    return {'orientation': torch.stack([d.xmat[:, pole, 2, 2],
                                        d.xmat[:, pole, 0, 2]], -1),
            'velocity': d.qvel[:, hinge_v:hinge_v + 1]}

  def get_reward(m_, d):
    return rewards.tolerance(d.xmat[:, pole, 2, 2], (_COSINE_BOUND, 1))

  return control.TaskDef(
      name='pendulum', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name != 'swingup':
    raise ValueError(f'unknown pendulum task {task_name!r}')
  return _make_task(device)
