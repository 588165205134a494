"""Cheetah domain (reference: dm_control/suite/cheetah.py), run task."""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_RUN_SPEED = 10
# zero-control physics steps after the random draw (suite/cheetah.py:76-80)
SETTLE_STEPS = 200


@functools.lru_cache(maxsize=None)
def _make_task(device: str) -> control.TaskDef:
  m = engine.load_model(common.model_path('cheetah.xml'), device)
  s = m.name2id('sensor', 'torso_subtreelinvel')
  subtree_adr = int(m.sensor_adr[s])
  limited = m.jnt_limited.astype(bool)
  lims = m.jnt_range[limited]
  lim_qadr = m.jnt_qposadr[limited]

  def init_episode(m_, d, generator):
    # uniform within limits for limited joints, then settle with zero
    # control and reset time (suite/cheetah.py:68-81)
    ref = d.qpos
    lo, hi = mirror(m_, ref, lims[:, 0]), mirror(m_, ref, lims[:, 1])
    u = torch.rand((ref.shape[0], len(lim_qadr)), generator=generator,
                   dtype=ref.dtype, device=ref.device)
    qpos = ref.clone()
    qpos[:, mirror(m_, ref, lim_qadr)] = lo + (hi - lo) * u
    return base.settle(m_, d.replace(qpos=qpos), SETTLE_STEPS)

  def get_observation(m_, d):
    return {'position': d.qpos[:, 1:], 'velocity': d.qvel}

  def get_reward(m_, d):
    return rewards.tolerance(d.sensordata[:, subtree_adr],
                             bounds=(_RUN_SPEED, float('inf')),
                             margin=_RUN_SPEED, value_at_margin=0,
                             sigmoid='linear')

  return control.TaskDef(
      name='cheetah', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name != 'run':
    raise ValueError(f'unknown cheetah task {task_name!r}')
  return _make_task(device)
