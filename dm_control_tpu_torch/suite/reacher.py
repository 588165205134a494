"""Reacher domain (reference: dm_control/suite/reacher.py), easy and hard.

Each episode places the target on an annulus: a per-lane `geom_pos` in
`Data.model_var`, which the kinematics reads through `smooth.mparam`.
"""

from __future__ import annotations

import functools
import math

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_BIG_TARGET = .05
_SMALL_TARGET = .015

TASKS = {'easy': _BIG_TARGET, 'hard': _SMALL_TARGET}


@functools.lru_cache(maxsize=None)
def _model(target_size: float, device: str):
  m = engine.load_model(common.model_path('reacher.xml'), device)
  # the target size is fixed per task variant: baked into the model (the
  # reference sets it at episode init, suite/reacher.py:93)
  m.geom_size = m.geom_size.copy()
  m.geom_size[m.name2id('geom', 'target'), 0] = target_size
  return m


@functools.lru_cache(maxsize=None)
def _make_task(target_size: float, device: str) -> control.TaskDef:
  m = _model(target_size, device)
  g_target = m.name2id('geom', 'target')
  g_finger = m.name2id('geom', 'finger')
  radii = float(m.geom_size[g_target, 0] + m.geom_size[g_finger, 0])

  def init_episode(m_, d, generator):
    qpos = base.randomize_limited_and_rotational_joints(m_, d.qpos,
                                                        generator)
    # the target on an annulus (suite/reacher.py:96-99)
    B = qpos.shape[0]
    kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
    angle = 2 * math.pi * torch.rand(B, **kw)
    radius = .05 + .15 * torch.rand(B, **kw)
    geom_pos = mirror(m_, qpos, m_.geom_pos).expand(B, m_.ngeom, 3).clone()
    geom_pos[:, g_target, 0] = radius * torch.sin(angle)
    geom_pos[:, g_target, 1] = radius * torch.cos(angle)
    return d.replace(qpos=qpos,
                     model_var=dict(d.model_var or {}, geom_pos=geom_pos))

  def _finger_to_target(d):
    return d.geom_xpos[:, g_target, :2] - d.geom_xpos[:, g_finger, :2]

  def get_observation(m_, d):
    return {'position': d.qpos, 'to_target': _finger_to_target(d),
            'velocity': d.qvel}

  def get_reward(m_, d):
    return rewards.tolerance(_finger_to_target(d).norm(dim=-1), (0, radii))

  return control.TaskDef(
      name='reacher', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown reacher task {task_name!r}')
  return _make_task(TASKS[task_name], device)
