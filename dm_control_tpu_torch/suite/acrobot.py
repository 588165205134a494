"""Acrobot domain (reference: dm_control/suite/acrobot.py), swingup and
swingup_sparse.  The model integrates with RK4."""

from __future__ import annotations

import functools
import math

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

TASKS = {'swingup': False, 'swingup_sparse': True}


@functools.lru_cache(maxsize=None)
def _model(device: str):
  return engine.load_model(common.model_path('acrobot.xml'), device)


@functools.lru_cache(maxsize=None)
def _make_task(sparse: bool, device: str) -> control.TaskDef:
  m = _model(device)
  upper = m.name2id('body', 'upper_arm')
  lower = m.name2id('body', 'lower_arm')
  s_target = m.name2id('site', 'target')
  s_tip = m.name2id('site', 'tip')
  q_shoulder = int(m.jnt_qposadr[m.name2id('joint', 'shoulder')])
  q_elbow = int(m.jnt_qposadr[m.name2id('joint', 'elbow')])
  target_radius = float(m.site_size[s_target, 0])

  def init_episode(m_, d, generator):
    qpos = d.qpos.clone()
    kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
    for q in (q_shoulder, q_elbow):
      qpos[:, q] = -math.pi + 2 * math.pi * torch.rand(qpos.shape[0], **kw)
    return d.replace(qpos=qpos)

  def get_observation(m_, d):
    x = d.xmat[:, [upper, lower]]
    return {'orientations': torch.cat([x[:, :, 0, 2], x[:, :, 2, 2]], -1),
            'velocity': d.qvel}

  def get_reward(m_, d):
    to_target = (d.site_xpos[:, s_target] - d.site_xpos[:, s_tip]).norm(
        dim=-1)
    return rewards.tolerance(to_target, bounds=(0, target_radius),
                             margin=0 if sparse else 1)

  return control.TaskDef(
      name='acrobot', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown acrobot task {task_name!r}')
  return _make_task(TASKS[task_name], device)
