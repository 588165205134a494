"""Box-stacking domain (reference: dm_control/suite/stacker.py): stack_2
and stack_4.

The manipulator's arm with 2 or 4 boxes (the other boxes pruned from the
model).  An episode raises the target to a random tower height at a
random x: a per-lane `body_pos` in `Data.model_var`.  The boxes start
anywhere at any angle, drawn collision-free (20 draws per lane), so both
tasks are expensive inits whose auto-resets come from the reset pool.
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
from dm_control_tpu_torch.suite import manipulator
from dm_control_tpu_torch.utils import rewards

_CLOSE = .01
_CONTROL_TIMESTEP = .01

TASKS = {'stack_2': 2, 'stack_4': 4}


@functools.lru_cache(maxsize=None)
def _model(n_boxes: int, device: str):
  unused = {f'box{b}' for b in range(n_boxes, 4)}
  root = manipulator.prune(common.load_xml_root('stacker.xml'),
                           lambda name: name not in unused)
  return engine.model_from_root(root, device)


@functools.lru_cache(maxsize=None)
def _make_task(n_boxes: int, device: str) -> control.TaskDef:
  m = _model(n_boxes, device)
  arm = manipulator.Arm(m)
  box_names = [f'box{b}' for b in range(n_boxes)]
  b_target = m.name2id('body', 'target')
  b_hand = m.name2id('body', 'hand')
  b_boxes = [m.name2id('body', n) for n in box_names]
  s_boxes = [m.name2id('site', n) for n in box_names]
  s_target = m.name2id('site', 'target')
  s_grasp = m.name2id('site', 'grasp')
  box_size = float(m.geom_size[m.name2id('geom', 'target'), 0])
  box_q = {c: [int(m.jnt_qposadr[m.name2id('joint', f'{n}_{c}')])
               for n in box_names] for c in 'xzy'}
  box_d = [int(m.jnt_dofadr[m.name2id('joint', f'{n}_{c}')])
           for n in box_names for c in 'xyz']

  def init_episode(m_, d, generator):
    def sample(d_, gen):
      B = d_.qpos.shape[0]
      kw = dict(generator=gen, dtype=d_.qpos.dtype, device=d_.qpos.device)
      u = lambda lo, hi, *n: lo + (hi - lo) * torch.rand((B,) + n, **kw)
      qpos = arm.sample(d_.qpos, gen)
      # the target tower's height box_size * (2 h + 1), h uniform in
      # 0..n_boxes-1, at a random x (suite/stacker.py:138-144)
      h = torch.randint(0, n_boxes, (B,), generator=gen,
                        device=d_.qpos.device).to(d_.qpos.dtype)
      body_pos = mirror(m_, d_.qpos, m_.body_pos).expand(B, m_.nbody,
                                                         3).clone()
      body_pos[:, b_target, 0] = u(-.37, .37)
      body_pos[:, b_target, 2] = box_size * (2 * h + 1)
      # each box anywhere at any angle (suite/stacker.py:146-151)
      qpos[:, box_q['x']] = u(.1, .3, n_boxes)
      qpos[:, box_q['z']] = u(0., .7, n_boxes)
      qpos[:, box_q['y']] = u(0., 2 * math.pi, n_boxes)
      return d_.replace(qpos=qpos, model_var=dict(d_.model_var or {},
                                                  body_pos=body_pos))
    return base.collision_free_init(sample, m_, d, generator)

  def get_observation(m_, d):
    obs = arm.observation(d)
    obs['touch'] = torch.log1p(d.sensordata)
    obs['hand_pos'] = manipulator.body_2d_pose(d, b_hand)
    obs['box_pos'] = torch.cat([manipulator.body_2d_pose(d, b)
                                for b in b_boxes], -1)
    obs['box_vel'] = d.qvel[:, box_d]
    obs['target_pos'] = manipulator.body_2d_pose(d, b_target,
                                                 orientation=False)
    return obs

  def get_reward(m_, d):
    target = d.site_xpos[:, s_target]
    dists = torch.stack([(d.site_xpos[:, s] - target).norm(dim=-1)
                         for s in s_boxes], -1)
    box_is_close = rewards.tolerance(dists.amin(-1), margin=2 * box_size)
    hand_to_target = (d.site_xpos[:, s_grasp] - target).norm(dim=-1)
    hand_is_far = rewards.tolerance(hand_to_target, bounds=(.1, math.inf),
                                    margin=_CLOSE)
    return box_is_close * hand_is_far

  return control.TaskDef(
      name=f'stacker_{n_boxes}', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown stacker task {task_name!r}')
  return _make_task(TASKS[task_name], device)
