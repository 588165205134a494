"""Ball-in-cup domain (reference: dm_control/suite/ball_in_cup.py), catch.

A spatial tendon (the string) ties the ball to the cup, with a limit row
when it is taut.  Each episode places the ball at random where it touches
nothing (collision-free rejection sampling), so the task is an expensive
init: BatchedEnv's auto-reset takes its states from the reset pool.
"""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common

_CONTROL_TIMESTEP = .02


@functools.lru_cache(maxsize=None)
def _make_task(device: str) -> control.TaskDef:
  m = engine.load_model(common.model_path('ball_in_cup.xml'), device)
  ball = m.name2id('body', 'ball')
  s_target = m.name2id('site', 'target')
  q_bx = int(m.jnt_qposadr[m.name2id('joint', 'ball_x')])
  q_bz = int(m.jnt_qposadr[m.name2id('joint', 'ball_z')])
  half_x, half_z = (float(v) for v in m.site_size[s_target][[0, 2]])
  ball_size = float(m.geom_size[m.name2id('geom', 'ball'), 0])

  def init_episode(m_, d, generator):
    # the ball uniform in a box beside the cup, collision-free where 20
    # draws allow (suite/ball_in_cup.py:79-87)
    def sample(d_, gen):
      qpos = d_.qpos.clone()
      kw = dict(generator=gen, dtype=qpos.dtype, device=qpos.device)
      B = qpos.shape[0]
      qpos[:, q_bx] = -.2 + .4 * torch.rand(B, **kw)
      qpos[:, q_bz] = .2 + .3 * torch.rand(B, **kw)
      return d_.replace(qpos=qpos)
    return base.collision_free_init(sample, m_, d, generator)

  def get_observation(m_, d):
    return {'position': d.qpos, 'velocity': d.qvel}

  def get_reward(m_, d):
    off = (d.site_xpos[:, s_target] - d.xpos[:, ball]).abs()
    in_target = ((off[:, 0] < half_x - ball_size)
                 & (off[:, 2] < half_z - ball_size))
    return in_target.to(d.qpos.dtype)

  return control.TaskDef(
      name='ball_in_cup', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name != 'catch':
    raise ValueError(f'unknown ball_in_cup task {task_name!r}')
  return _make_task(device)
